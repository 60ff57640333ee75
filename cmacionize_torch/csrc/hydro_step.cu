// K3: one MUSCL-Hancock step with the HLLC or exact Riemann solver.
//
// Replaces cmacionize_tpu/ops/hydro.py:hydro_step_padded (limited_gradients
// → predict_half_step → _axis_faces → _face_flux → riemann.hllc_flux or
// riemann.exact_flux → flux divergence → density floor).  The plain PyTorch
// version is cmacionize_torch/ops/hydro.py:hydro_step_padded_reference.
//
// Input: the five primitives (rho, vx, vy, vz, p) padded with 2 ghost cells
// per side, f32, C order with z fastest, (nx+4)(ny+4)(nz+4) each, and the
// conserved state u (5 fields of nx*ny*nz).  Output: the updated conserved
// state.  Padding stays in plain torch (pad_primitives), so that a halo
// exchange can supply the ghosts instead.  The gravity kick of the JAX step
// does not touch rho, so it commutes with the floor and is applied by the
// caller after K3.
//
// Two kernels:
//   * muscl_predict_kernel, one thread per cell of the pad-1 region
//     ((nx+2)(ny+2)(nz+2)): the 15 monotonized-central limited slopes and
//     the half-step predicted primitives (with the rho and P floors), 20 f32
//     per cell written to scratch that the wrapper allocates;
//   * muscl_flux_update_kernel, one thread per domain cell: for each of its
//     six faces, the left/right states w_pred ± slope/2, rotated by
//     _VEL_PERM, through the HLLC or the exact solver, then
//     u - dt*sum(F_hi - F_lo)/dx per axis in x, y, z order and the rho floor.
//     Each face is computed twice, once from each neighbour, with identical
//     arithmetic: no atomics, and the result is deterministic.
//
// Precision: built with --fmad=false and without fast math, so nothing is
// contracted and divisions and square roots are correctly rounded.  Each
// expression keeps the JAX package's operation order (predict_half_step's
// term order for drho, dv and dp; _physical_flux and star_flux in
// hllc_flux), and every constant that JAX forms in double from gamma
// ((gamma-1), (gamma+1)/(2 gamma), ...) arrives precomputed in double and
// rounded once to f32, as JAX's weakly typed Python scalars do.  So the HLLC
// path repeats the plain version's f32 operations one for one; the exact
// path differs from it only where torch's pow takes a shortcut (x**3 as
// products) that powf does not.
//
// What bounds it on an H100: at 64^3 the working set is about 6 MB of padded
// primitives, 23 MB of slopes and predicted states and 5+5 MB of state in
// and out, all L2-resident (50 MB).  The predict pass is a memory/latency
// bound 7-point stencil; the flux pass reads 7 pad-1 cells x 20 values per
// cell and does 6 Riemann solves, so with HLLC it is bound by L2 traffic
// and with the exact solver (20 Newton iterations with powf) by arithmetic.
// The simple design is deliberate: a fused shared-memory tile with halo,
// one flux per face, and padding by index mapping are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hllc.cuh"

namespace {

using cmi::energy_density;
using cmi::hllc_flux;
using cmi::max_nan;
using cmi::min_nan;
using cmi::physical_flux;

constexpr int kPredictThreads = 256;
constexpr int kFluxThreads = 128;
constexpr float kRhoFloor = 1e-30f;
constexpr float kPFloor = 1e-30f;

struct Consts {
  float gamma;     // gamma
  float gm1;       // gamma - 1
  float cq;        // (gamma + 1) / (2 gamma)
  float gp1;       // gamma + 1
  float g1r;       // (gamma - 1) / (gamma + 1)
  float gz;        // (gamma - 1) / (2 gamma)
  float inv_gz;    // 1 / gz
  float neg_exp;   // -(gamma + 1) / (2 gamma)
  float half_gm1;  // 0.5 (gamma - 1)
  float c2gp1;     // 2 / (gamma + 1)
  float e_rho;     // 2 / (gamma - 1)
  float e_p;       // 2 gamma / (gamma - 1)
  float inv_g;     // 1 / gamma
  float dt;
  float half_dt;   // 0.5 dt
  float inv_dx[3];
  int n_iter;      // Newton iterations of the exact solver
  int exact;       // 0: HLLC, 1: exact
};

struct Fields5 {
  const float* f[5];
};
struct OutFields5 {
  float* f[5];
};

// _limited_slope: monotonized central, in units of one cell
__device__ __forceinline__ float limited_slope(float wm, float w0, float wp) {
  const float dl = w0 - wm;
  const float dr = wp - w0;
  const float dc = 0.5f * (wp - wm);
  const float sgn = dc > 0.0f ? 1.0f : (dc < 0.0f ? -1.0f : 0.0f);
  const float slope =
      sgn * min_nan(fabsf(dc), 2.0f * min_nan(fabsf(dl), fabsf(dr)));
  return dl * dr > 0.0f ? slope : 0.0f;
}

__global__ void __launch_bounds__(kPredictThreads) muscl_predict_kernel(
    Fields5 wp, float* __restrict__ scratch, int nx, int ny, int nz,
    Consts c) {
  const int n1x = nx + 2, n1y = ny + 2, n1z = nz + 2;
  const int n1 = n1x * n1y * n1z;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n1) return;
  const int a = idx / (n1y * n1z);
  const int b = (idx / n1z) % n1y;
  const int k = idx % n1z;
  const int NY = ny + 4, NZ = nz + 4;
  // the pad-1 cell (a, b, k) is the padded cell (a+1, b+1, k+1)
  const int centre = ((a + 1) * NY + (b + 1)) * NZ + (k + 1);
  const int stride[3] = {NY * NZ, NZ, 1};

  float w[5];
  float g[3][5];
  for (int f = 0; f < 5; ++f) {
    const float* field = wp.f[f];
    w[f] = field[centre];
    for (int axis = 0; axis < 3; ++axis) {
      g[axis][f] = limited_slope(field[centre - stride[axis]], w[f],
                                 field[centre + stride[axis]]);
    }
  }

  const float rho = w[0], vx = w[1], vy = w[2], vz = w[3], p = w[4];
  const float i0 = c.inv_dx[0], i1 = c.inv_dx[1], i2 = c.inv_dx[2];
  // predict_half_step, term for term
  const float div_v = g[0][1] * i0 + g[1][2] * i1 + g[2][3] * i2;
  const float drho = vx * g[0][0] * i0 + vy * g[1][0] * i1 +
                     vz * g[2][0] * i2 + rho * div_v;
  const float dvx = vx * g[0][1] * i0 + vy * g[1][1] * i1 +
                    vz * g[2][1] * i2 + g[0][4] * i0 / rho;
  const float dvy = vx * g[0][2] * i0 + vy * g[1][2] * i1 +
                    vz * g[2][2] * i2 + g[1][4] * i1 / rho;
  const float dvz = vx * g[0][3] * i0 + vy * g[1][3] * i1 +
                    vz * g[2][3] * i2 + g[2][4] * i2 / rho;
  const float dp = vx * g[0][4] * i0 + vy * g[1][4] * i1 +
                   vz * g[2][4] * i2 + c.gamma * p * div_v;

  scratch[0 * n1 + idx] = max_nan(rho - c.half_dt * drho, kRhoFloor);
  scratch[1 * n1 + idx] = vx - c.half_dt * dvx;
  scratch[2 * n1 + idx] = vy - c.half_dt * dvy;
  scratch[3 * n1 + idx] = vz - c.half_dt * dvz;
  scratch[4 * n1 + idx] = max_nan(p - c.half_dt * dp, kPFloor);
  for (int axis = 0; axis < 3; ++axis) {
    for (int f = 0; f < 5; ++f) {
      scratch[(5 + 5 * axis + f) * n1 + idx] = g[axis][f];
    }
  }
}

// ------------------------------------------------------------ Riemann solvers
// Outputs are in the face frame: mass, normal momentum, two tangential
// momenta, energy.  hllc_flux, physical_flux and energy_density are in
// hllc.cuh (shared with K7); the exact solver follows.

// Toro's f_K(p) and its derivative
__device__ __forceinline__ float fK(float p, float rhoK, float pK, float aK,
                                    const Consts& c) {
  if (p > pK) {
    const float AK = 2.0f / (c.gp1 * rhoK);
    const float BK = c.g1r * pK;
    return (p - pK) * sqrtf(AK / (p + BK));
  }
  return 2.0f * aK / c.gm1 * (powf(p / pK, c.gz) - 1.0f);
}

__device__ __forceinline__ float fK_prime(float p, float rhoK, float pK,
                                          float aK, const Consts& c) {
  if (p > pK) {
    const float AK = 2.0f / (c.gp1 * rhoK);
    const float BK = c.g1r * pK;
    return sqrtf(AK / (p + BK)) * (1.0f - 0.5f * (p - pK) / (p + BK));
  }
  return powf(p / pK, c.neg_exp) / (rhoK * aK);
}

// exact_sample at s = 0 (exact_star_pressure included): (rho, u, p)
__device__ void exact_sample_zero(float rhoL, float uL, float pL, float rhoR,
                                  float uR, float pR, const Consts& c,
                                  float* rho, float* u, float* p) {
  const float s = 0.0f;
  const float aL = sqrtf(c.gamma * pL / rhoL);
  const float aR = sqrtf(c.gamma * pR / rhoR);
  const float du = uR - uL;
  // two-rarefaction initial guess, then Newton-Raphson
  const float p0 = powf((aL + aR - c.half_gm1 * du) /
                            (aL / powf(pL, c.gz) + aR / powf(pR, c.gz)),
                        c.inv_gz);
  float ps = max_nan(p0, 1e-10f * min_nan(pL, pR));
  for (int it = 0; it < c.n_iter; ++it) {
    const float f = fK(ps, rhoL, pL, aL, c) + fK(ps, rhoR, pR, aR, c) + du;
    const float fp = fK_prime(ps, rhoL, pL, aL, c) + fK_prime(ps, rhoR, pR, aR, c);
    const float p_new = ps - f / max_nan(fp, 1e-30f);
    ps = max_nan(p_new, 1e-10f * ps);
  }
  const float u_star =
      0.5f * (uL + uR) + 0.5f * (fK(ps, rhoR, pR, aR, c) - fK(ps, rhoL, pL, aL, c));
  const float g1 = c.g1r;

  if (s <= u_star) {  // left of the contact
    if (ps > pL) {  // left shock
      const float SL_shock = uL - aL * sqrtf(c.cq * ps / pL + c.gz);
      if (s < SL_shock) {
        *rho = rhoL; *u = uL; *p = pL;
      } else {
        *rho = rhoL * (ps / pL + g1) / (g1 * ps / pL + 1.0f);
        *u = u_star; *p = ps;
      }
    } else {  // left rarefaction
      const float SHL = uL - aL;
      const float aL_star = aL * powf(ps / pL, c.gz);
      const float STL = u_star - aL_star;
      if (s < SHL) {
        *rho = rhoL; *u = uL; *p = pL;
      } else if (s > STL) {
        *rho = rhoL * powf(ps / pL, c.inv_g); *u = u_star; *p = ps;
      } else {
        const float fan_u = c.c2gp1 * (aL + c.half_gm1 * uL + s);
        const float fan_a = c.c2gp1 * (aL + c.half_gm1 * (uL - s));
        *rho = rhoL * powf(fan_a / aL, c.e_rho);
        *u = fan_u;
        *p = pL * powf(fan_a / aL, c.e_p);
      }
    }
  } else {  // right of the contact
    if (ps > pR) {  // right shock
      const float SR_shock = uR + aR * sqrtf(c.cq * ps / pR + c.gz);
      if (s > SR_shock) {
        *rho = rhoR; *u = uR; *p = pR;
      } else {
        *rho = rhoR * (ps / pR + g1) / (g1 * ps / pR + 1.0f);
        *u = u_star; *p = ps;
      }
    } else {  // right rarefaction
      const float SHR = uR + aR;
      const float aR_star = aR * powf(ps / pR, c.gz);
      const float STR = u_star + aR_star;
      if (s > SHR) {
        *rho = rhoR; *u = uR; *p = pR;
      } else if (s < STR) {
        *rho = rhoR * powf(ps / pR, c.inv_g); *u = u_star; *p = ps;
      } else {
        const float fan_u = c.c2gp1 * (-aR + c.half_gm1 * uR + s);
        const float fan_a = c.c2gp1 * (aR - c.half_gm1 * (uR - s));
        *rho = rhoR * powf(fan_a / aR, c.e_rho);
        *u = fan_u;
        *p = pR * powf(fan_a / aR, c.e_p);
      }
    }
  }
}

// one-sided rarefactions into vacuum (Toro 4.6), sampled at s = 0
__device__ void left_into_vacuum(float rhoL, float uL, float pL, float aL,
                                 const Consts& c, float* rho, float* u,
                                 float* p) {
  const float shl = uL - aL;
  const float svl = uL + 2.0f * aL / c.gm1;
  if (shl >= 0.0f) {
    *rho = rhoL; *u = uL; *p = pL;
  } else if (svl <= 0.0f) {
    *rho = 0.0f; *u = 0.0f; *p = 0.0f;
  } else {
    const float fan_a = max_nan(c.c2gp1 * (aL + c.half_gm1 * uL), 0.0f);
    *u = c.c2gp1 * (aL + c.half_gm1 * uL);
    *rho = rhoL * powf(fan_a / aL, c.e_rho);
    *p = pL * powf(fan_a / aL, c.e_p);
  }
}

__device__ void right_into_vacuum(float rhoR, float uR, float pR, float aR,
                                  const Consts& c, float* rho, float* u,
                                  float* p) {
  const float shr = uR + aR;
  const float svr = uR - 2.0f * aR / c.gm1;
  if (shr <= 0.0f) {
    *rho = rhoR; *u = uR; *p = pR;
  } else if (svr >= 0.0f) {
    *rho = 0.0f; *u = 0.0f; *p = 0.0f;
  } else {
    const float fan_a = max_nan(c.c2gp1 * (aR - c.half_gm1 * uR), 0.0f);
    *u = c.c2gp1 * (-aR + c.half_gm1 * uR);
    *rho = rhoR * powf(fan_a / aR, c.e_rho);
    *p = pR * powf(fan_a / aR, c.e_p);
  }
}

__device__ void exact_flux(float rhoL, float uL, float vL, float wL, float pL,
                           float rhoR, float uR, float vR, float wR, float pR,
                           const Consts& c, float out[5]) {
  const float tiny = 1e-40f;
  const bool vac_L = (rhoL <= tiny) || (pL <= tiny);
  const bool vac_R = (rhoR <= tiny) || (pR <= tiny);
  const float rhoL_s = vac_L ? 1.0f : rhoL;
  const float pL_s = vac_L ? 1.0f : max_nan(pL, tiny);
  const float rhoR_s = vac_R ? 1.0f : rhoR;
  const float pR_s = vac_R ? 1.0f : max_nan(pR, tiny);
  const float aL = sqrtf(c.gamma * pL_s / rhoL_s);
  const float aR = sqrtf(c.gamma * pR_s / rhoR_s);
  const bool vac_gen =
      !vac_L && !vac_R && (2.0f * (aL + aR) / c.gm1 <= uR - uL);

  float rho, u, p;
  if (vac_L && vac_R) {
    rho = 0.0f; u = 0.0f; p = 0.0f;
  } else if (vac_R) {
    left_into_vacuum(rhoL_s, uL, pL_s, aL, c, &rho, &u, &p);
  } else if (vac_L) {
    right_into_vacuum(rhoR_s, uR, pR_s, aR, c, &rho, &u, &p);
  } else if (vac_gen) {
    const float svl = uL + 2.0f * aL / c.gm1;
    if (svl >= 0.0f) {
      left_into_vacuum(rhoL_s, uL, pL_s, aL, c, &rho, &u, &p);
    } else {
      right_into_vacuum(rhoR_s, uR, pR_s, aR, c, &rho, &u, &p);
    }
  } else {
    exact_sample_zero(rhoL_s, uL, pL_s, rhoR_s, uR, pR_s, c, &rho, &u, &p);
  }
  // tangential velocities ride the contact: upwind by the interface u
  const float v = u > 0.0f ? vL : vR;
  const float w = u > 0.0f ? wL : wR;
  physical_flux(rho, u, v, w, p, c, out);
}

// Flux through the face between pad-1 cells A (left) and B (right) along
// `axis`, rotated back to (mass, mom_x, mom_y, mom_z, energy).
__device__ void face_flux(const float* __restrict__ scratch, int n1, int A,
                          int B, int axis, const Consts& c, float flux[5]) {
  const float* sl = scratch + (5 + 5 * axis) * n1;
  float left[5], right[5];
  for (int f = 0; f < 5; ++f) {
    left[f] = scratch[f * n1 + A] + 0.5f * sl[f * n1 + A];
    right[f] = scratch[f * n1 + B] - 0.5f * sl[f * n1 + B];
  }
  // _VEL_PERM: (normal, tangential 1, tangential 2) field per axis
  const int n = 1 + axis;
  const int t1 = 1 + (axis + 1) % 3;
  const int t2 = 1 + (axis + 2) % 3;
  float ff[5];
  if (c.exact) {
    exact_flux(left[0], left[n], left[t1], left[t2], left[4], right[0],
               right[n], right[t1], right[t2], right[4], c, ff);
  } else {
    hllc_flux(left[0], left[n], left[t1], left[t2], left[4], right[0],
              right[n], right[t1], right[t2], right[4], c, ff);
  }
  flux[0] = ff[0];
  flux[n] = ff[1];
  flux[t1] = ff[2];
  flux[t2] = ff[3];
  flux[4] = ff[4];
}

__global__ void __launch_bounds__(kFluxThreads) muscl_flux_update_kernel(
    const float* __restrict__ scratch, Fields5 u, OutFields5 out, int nx,
    int ny, int nz, Consts c) {
  const int n = nx * ny * nz;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int i = idx / (ny * nz);
  const int j = (idx / nz) % ny;
  const int k = idx % nz;
  const int n1y = ny + 2, n1z = nz + 2;
  const int n1 = (nx + 2) * n1y * n1z;
  const int centre = ((i + 1) * n1y + (j + 1)) * n1z + (k + 1);
  const int stride[3] = {n1y * n1z, n1z, 1};

  float acc[5];
  for (int f = 0; f < 5; ++f) acc[f] = u.f[f][idx];
  for (int axis = 0; axis < 3; ++axis) {
    float lo[5], hi[5];
    face_flux(scratch, n1, centre - stride[axis], centre, axis, c, lo);
    face_flux(scratch, n1, centre, centre + stride[axis], axis, c, hi);
    for (int f = 0; f < 5; ++f) {
      acc[f] = acc[f] - c.dt * ((hi[f] - lo[f]) * c.inv_dx[axis]);
    }
  }
  out.f[0][idx] = max_nan(acc[0], kRhoFloor);
  for (int f = 1; f < 5; ++f) out.f[f][idx] = acc[f];
}

}  // namespace

// Launches K3 on `stream`; returns cudaGetLastError() (0 on success).
// wp: 5 padded primitives ((nx+4)(ny+4)(nz+4) each); u, out: 5 conserved
// fields (nx*ny*nz each); scratch: 20*(nx+2)(ny+2)(nz+2) floats; consts: a
// HOST array of the 18 f32 constants in Consts order (gamma ...
// inv_dx[2]); exact: 0 for HLLC, 1 for the exact solver.
extern "C" int cmi_hydro_step(
    const float* wp_rho, const float* wp_vx, const float* wp_vy,
    const float* wp_vz, const float* wp_p, const float* u_rho,
    const float* u_mx, const float* u_my, const float* u_mz,
    const float* u_e, float* out_rho, float* out_mx, float* out_my,
    float* out_mz, float* out_e, float* scratch, const float* consts, int nx,
    int ny, int nz, int exact, int n_iter, void* stream) {
  Consts c;
  c.gamma = consts[0];
  c.gm1 = consts[1];
  c.cq = consts[2];
  c.gp1 = consts[3];
  c.g1r = consts[4];
  c.gz = consts[5];
  c.inv_gz = consts[6];
  c.neg_exp = consts[7];
  c.half_gm1 = consts[8];
  c.c2gp1 = consts[9];
  c.e_rho = consts[10];
  c.e_p = consts[11];
  c.inv_g = consts[12];
  c.dt = consts[13];
  c.half_dt = consts[14];
  for (int a = 0; a < 3; ++a) c.inv_dx[a] = consts[15 + a];
  c.n_iter = n_iter;
  c.exact = exact;
  const Fields5 wp = {{wp_rho, wp_vx, wp_vy, wp_vz, wp_p}};
  const Fields5 u = {{u_rho, u_mx, u_my, u_mz, u_e}};
  const OutFields5 out = {{out_rho, out_mx, out_my, out_mz, out_e}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n1 = (nx + 2) * (ny + 2) * (nz + 2);
  const int n = nx * ny * nz;
  if (n > 0) {
    muscl_predict_kernel<<<(n1 + kPredictThreads - 1) / kPredictThreads,
                           kPredictThreads, 0, s>>>(wp, scratch, nx, ny, nz, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    muscl_flux_update_kernel<<<(n + kFluxThreads - 1) / kFluxThreads,
                               kFluxThreads, 0, s>>>(scratch, u, out, nx, ny,
                                                     nz, c);
  }
  return static_cast<int>(cudaGetLastError());
}
