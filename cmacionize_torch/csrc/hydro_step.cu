// K3: one MUSCL-Hancock step with the HLLC or exact Riemann solver, one
// launch a step on shared-memory bricks.
//
// Replaces cmacionize_tpu/ops/hydro.py:hydro_step_padded (limited_gradients
// → predict_half_step → _axis_faces → _face_flux → riemann.hllc_flux or
// riemann.exact_flux → flux divergence → density floor), and with it the
// primitives and the ghost padding of hydro_step (primitives_from_conserved,
// pad_primitives), which XLA fuses into the same jitted step.  The plain
// PyTorch version is cmacionize_torch/ops/hydro.py:hydro_step_padded_reference
// after primitives_from_conserved and pad_primitives.
//
// Each block owns a brick of kBX x kBY x kBZ cells (z fastest, as the fields
// are laid out) and runs the whole step on it in shared memory:
//   1. the primitives of the brick and its 2-cell halo on every side, corners
//      included (the predicted states read diagonal neighbours), in one of
//      two ways, a template argument:
//        (U) from the conserved state u: each loaded cell maps to its source
//            cell by per-axis index tables (ops/hydro.py:ghost_map: periodic,
//            reflective and outflow walls, a bit for the reflective wall's
//            sign of the normal velocity), and primitives_from_conserved's
//            f32 operations, in its order, form the primitives there;
//        (P) from primitives already padded with 2 ghosts per side (inflow
//            ghosts, or a halo exchange's);
//   2. the 15 monotonized-central slopes and the half-step predicted state
//      of each pad-1 cell that a face of the brick reads (the brick and the
//      six layers beside it), the predicted state kept;
//   3. each face of the brick solved once, from the predicted states and
//      the slopes along its axis (recomputed at the face from the
//      primitives, the same operations on the same values as in 2), through
//      HLLC or the exact solver: each thread the low faces of its cell along
//      x, y and z, then the brick's high faces on the first 224 threads;
//   4. each thread's cell takes u - dt * ((F_hi - F_lo) * inv_dx) axis by
//      axis in x, y, z order, as the plain version's loop over the axes
//      does, and at the end the density floor.
// There is no global scratch: the step reads u (and in (P) the padded
// primitives) and writes the new state.
//
// The brick: 4 x 8 x 16 cells, a thread a cell (512 threads); 8 x 12 x 20
// loaded cells (5 floats each, 38,400 B), 6 x 10 x 18 pad-1 cells (5 floats,
// 21,600 B; the 960 that a face reads are predicted, two passes of the
// block) and the fluxes of the 640 + 576 + 544 faces (5 floats, 35,200 B):
// 95,200 B of dynamic shared memory (cudaFuncSetAttribute before the
// launch), 2 blocks a SM, 32 warps.  Measured on an H100 at 64^3 (PERF.md
// section 6), the larger brick beat 4 x 8 x 8 (256 threads, 4 blocks a SM)
// by 40%, with less halo loaded and predicted a cell; 64^3 cells are 512
// bricks.
//
// Precision: built with --fmad=false and without fast math, so nothing is
// contracted and divisions and square roots are correctly rounded.  Each
// expression keeps the JAX package's operation order (predict_half_step's
// term order for drho, dv and dp; _physical_flux and star_flux in
// hllc_flux; primitives_from_conserved as torch evaluates it), and every
// constant that JAX forms in double from gamma ((gamma-1), (gamma+1)/(2
// gamma), ...) arrives precomputed in double and rounded once to f32, as
// JAX's weakly typed Python scalars are.  So (U) gives the bits of torch's
// primitives, pad_primitives and (P); the HLLC path repeats the plain
// version's f32 operations one for one; the exact path differs from it only
// where torch's pow takes a shortcut (x**3 as products) that powf does not.
//
// What bounds it on an H100: the state in and out, 40 B a cell (10.5 MB at
// 64^3, 0.0031 ms at 3.35 TB/s); the operations of 3 solves a cell, the
// slopes and the predictions of the pad-1 cells (1.9 a brick cell) and the
// primitives of the loaded cells (3.75 a brick cell) come under it at the
// f32 peak.  The loads of the halo come from L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hllc.cuh"
#include "occupancy.cuh"

namespace {

using cmi::energy_density;
using cmi::hllc_flux;
using cmi::max_nan;
using cmi::min_nan;
using cmi::physical_flux;

constexpr int kBX = 4, kBY = 8, kBZ = 16;  // the brick of cells a block owns
constexpr int kThreads = kBX * kBY * kBZ;  // a thread a cell of the brick
// the loaded region: the brick and 2 cells on every side
constexpr int kWX = kBX + 4, kWY = kBY + 4, kWZ = kBZ + 4;
constexpr int kWCells = kWX * kWY * kWZ;
// the pad-1 region: the brick and 1 cell on every side
constexpr int kPX = kBX + 2, kPY = kBY + 2, kPZ = kBZ + 2;
constexpr int kPCells = kPX * kPY * kPZ;
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

// ------------------------------------------------------------------ the step

// The faces of the brick along each axis: one more than the brick along it.
template <int kAxis>
struct FaceExtent {
  static constexpr int x = kBX + (kAxis == 0), y = kBY + (kAxis == 1), z = kBZ + (kAxis == 2);
  static constexpr int count = x * y * z;
};

// The block's shared memory: the loaded primitives, the predicted states of
// the pad-1 cells, the face fluxes of the three axes.
struct Tile {
  float w[5][kWCells];
  float pred[5][kPCells];
  float fx[5][FaceExtent<0>::count];
  float fy[5][FaceExtent<1>::count];
  float fz[5][FaceExtent<2>::count];
};

template <int kAxis>
__device__ __forceinline__ float (&fluxes(Tile& t))[5][FaceExtent<kAxis>::count] {
  if constexpr (kAxis == 0) {
    return t.fx;
  } else if constexpr (kAxis == 1) {
    return t.fy;
  } else {
    return t.fz;
  }
}

// The ghost map of one padded index along an axis (ops/hydro.py:ghost_map):
// its source cell, bit-inverted where a reflective wall flips the sign of
// that axis's velocity.
__device__ __forceinline__ int source_of(int code, bool* flip) {
  *flip = code < 0;
  return code < 0 ? ~code : code;
}

// Step 1: the primitives of the loaded region, padded index (x0 + a, y0 + b,
// z0 + k) at local (a, b, k); cells past the padded grid (a ragged brick)
// are zero and never read.
template <bool kFromConserved>
__device__ __forceinline__ void load_primitives(Tile& t, const Fields5& src,
                                                const int* __restrict__ map,
                                                int x0, int y0, int z0, int nx,
                                                int ny, int nz, const Consts& c) {
  const int NX = nx + 4, NY = ny + 4, NZ = nz + 4;
  for (int i = threadIdx.x; i < kWCells; i += kThreads) {
    const int a = i / (kWY * kWZ), b = (i / kWZ) % kWY, k = i % kWZ;
    const int px = x0 + a, py = y0 + b, pz = z0 + k;
    float w[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (px < NX && py < NY && pz < NZ) {
      if (kFromConserved) {
        bool fx, fy, fz;
        const int sx = source_of(__ldg(map + px), &fx);
        const int sy = source_of(__ldg(map + NX + py), &fy);
        const int sz = source_of(__ldg(map + NX + NY + pz), &fz);
        const int64_t cell = (static_cast<int64_t>(sx) * ny + sy) * nz + sz;
        // primitives_from_conserved, as torch evaluates it
        const float rho = max_nan(__ldg(src.f[0] + cell), kRhoFloor);
        const float vx = __ldg(src.f[1] + cell) / rho;
        const float vy = __ldg(src.f[2] + cell) / rho;
        const float vz = __ldg(src.f[3] + cell) / rho;
        const float kinetic = 0.5f * rho * (vx * vx + vy * vy + vz * vz);
        w[0] = rho;
        w[1] = fx ? -vx : vx;
        w[2] = fy ? -vy : vy;
        w[3] = fz ? -vz : vz;
        w[4] = max_nan(c.gm1 * (__ldg(src.f[4] + cell) - kinetic), kPFloor);
      } else {
        const int64_t cell = (static_cast<int64_t>(px) * NY + py) * NZ + pz;
        for (int f = 0; f < 5; ++f) w[f] = __ldg(src.f[f] + cell);
      }
    }
    for (int f = 0; f < 5; ++f) t.w[f][i] = w[f];
  }
}

// local strides of the loaded region along x, y, z
__device__ __forceinline__ int w_stride(int axis) {
  return axis == 0 ? kWY * kWZ : (axis == 1 ? kWZ : 1);
}

// The slope along `axis` of field f at loaded cell `centre`.
__device__ __forceinline__ float slope_at(const Tile& t, int f, int centre, int axis) {
  const int s = w_stride(axis);
  return limited_slope(t.w[f][centre - s], t.w[f][centre], t.w[f][centre + s]);
}

// The pad-1 cells that a face of the brick reads, enumerated: the brick's
// cells, then the layers beside its two x faces, its two y faces and its
// two z faces (960 for the 4 x 8 x 16 brick: two passes of the block).
constexpr int kXLayer = kBY * kBZ, kYLayer = kBX * kBZ, kZLayer = kBX * kBY;
constexpr int kNeeded = kThreads + 2 * (kXLayer + kYLayer + kZLayer);
static_assert(kXLayer + kYLayer + kZLayer <= kThreads, "a thread for each high face");

__device__ __forceinline__ void needed_cell(int i, int* a, int* b, int* k) {
  if (i < kThreads) {  // the brick: pad-1 (1..kBX, 1..kBY, 1..kBZ)
    *a = 1 + i / (kBY * kBZ), *b = 1 + (i / kBZ) % kBY, *k = 1 + i % kBZ;
    return;
  }
  i -= kThreads;
  if (i < 2 * kXLayer) {
    const int r = i % kXLayer;
    *a = i < kXLayer ? 0 : kPX - 1, *b = 1 + r / kBZ, *k = 1 + r % kBZ;
    return;
  }
  i -= 2 * kXLayer;
  if (i < 2 * kYLayer) {
    const int r = i % kYLayer;
    *b = i < kYLayer ? 0 : kPY - 1, *a = 1 + r / kBZ, *k = 1 + r % kBZ;
    return;
  }
  i -= 2 * kYLayer;
  const int r = i % kZLayer;
  *k = i < kZLayer ? 0 : kPZ - 1, *a = 1 + r / kBY, *b = 1 + r % kBY;
}

// Step 2: the predicted state of each pad-1 cell that a face of the brick
// reads (predict_half_step, term for term).
__device__ __forceinline__ void predict(Tile& t, int x0, int y0, int z0, int nx,
                                        int ny, int nz, const Consts& c) {
  for (int i = threadIdx.x; i < kNeeded; i += kThreads) {
    int a, b, k;
    needed_cell(i, &a, &b, &k);
    if (x0 + a > nx + 1 || y0 + b > ny + 1 || z0 + k > nz + 1) continue;  // past the grid
    const int centre = ((a + 1) * kWY + (b + 1)) * kWZ + (k + 1);
    float g[3][5];
    for (int axis = 0; axis < 3; ++axis) {
      for (int f = 0; f < 5; ++f) g[axis][f] = slope_at(t, f, centre, axis);
    }
    const float rho = t.w[0][centre], vx = t.w[1][centre], vy = t.w[2][centre],
                vz = t.w[3][centre], p = t.w[4][centre];
    const float i0 = c.inv_dx[0], i1 = c.inv_dx[1], i2 = c.inv_dx[2];
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
    const int p1 = (a * kPY + b) * kPZ + k;
    t.pred[0][p1] = max_nan(rho - c.half_dt * drho, kRhoFloor);
    t.pred[1][p1] = vx - c.half_dt * dvx;
    t.pred[2][p1] = vy - c.half_dt * dvy;
    t.pred[3][p1] = vz - c.half_dt * dvz;
    t.pred[4][p1] = max_nan(p - c.half_dt * dp, kPFloor);
  }
}

// Step 3: the flux through face (a, b, k) along kAxis, the low face of brick
// cell (a, b, k), between pad-1 cells L and R (rotated back to mass, mom_x,
// mom_y, mom_z, energy), into the axis's flux array; faces that no cell of
// the grid reads are skipped.
template <int kAxis, bool kExact>
__device__ __forceinline__ void solve_face(Tile& t, int a, int b, int k, int x0, int y0,
                                           int z0, int nx, int ny, int nz, const Consts& c) {
  using F = FaceExtent<kAxis>;
  if (x0 + a > nx || y0 + b > ny || z0 + k > nz) return;
  if ((kAxis != 0 && x0 + a == nx) || (kAxis != 1 && y0 + b == ny) ||
      (kAxis != 2 && z0 + k == nz)) return;
  constexpr int kPStride = kAxis == 0 ? kPY * kPZ : (kAxis == 1 ? kPZ : 1);
  const int R = ((a + 1) * kPY + (b + 1)) * kPZ + (k + 1);
  const int L = R - kPStride;
  const int wR = ((a + 2) * kWY + (b + 2)) * kWZ + (k + 2);
  const int wL = wR - w_stride(kAxis);
  float left[5], right[5];
  for (int f = 0; f < 5; ++f) {
    left[f] = t.pred[f][L] + 0.5f * slope_at(t, f, wL, kAxis);
    right[f] = t.pred[f][R] - 0.5f * slope_at(t, f, wR, kAxis);
  }
  // _VEL_PERM: (normal, tangential 1, tangential 2) field per axis
  constexpr int n = 1 + kAxis;
  constexpr int t1 = 1 + (kAxis + 1) % 3;
  constexpr int t2 = 1 + (kAxis + 2) % 3;
  float ff[5];
  if (kExact) {
    exact_flux(left[0], left[n], left[t1], left[t2], left[4], right[0],
               right[n], right[t1], right[t2], right[4], c, ff);
  } else {
    hllc_flux(left[0], left[n], left[t1], left[t2], left[4], right[0],
              right[n], right[t1], right[t2], right[4], c, ff);
  }
  float (&out)[5][F::count] = fluxes<kAxis>(t);
  const int i = (a * F::y + b) * F::z + k;
  out[0][i] = ff[0];
  out[n][i] = ff[1];
  out[t1][i] = ff[2];
  out[t2][i] = ff[3];
  out[4][i] = ff[4];
}

// Step 3's update for one axis: acc - dt * ((F_hi - F_lo) * inv_dx).
template <int kAxis>
__device__ __forceinline__ void add_axis(Tile& t, int a, int b, int k,
                                         const Consts& c, float acc[5]) {
  using F = FaceExtent<kAxis>;
  constexpr int kFStride = kAxis == 0 ? F::y * F::z : (kAxis == 1 ? F::z : 1);
  const float (&flux)[5][F::count] = fluxes<kAxis>(t);
  const int lo = (a * F::y + b) * F::z + k;
  for (int f = 0; f < 5; ++f) {
    acc[f] = acc[f] - c.dt * ((flux[f][lo + kFStride] - flux[f][lo]) * c.inv_dx[kAxis]);
  }
}

template <bool kFromConserved, bool kExact>
__global__ void __launch_bounds__(kThreads) hydro_step_kernel(
    Fields5 src, const int* __restrict__ map, Fields5 u, OutFields5 out, int nx,
    int ny, int nz, Consts c) {
  extern __shared__ __align__(16) unsigned char shared[];
  Tile& t = *reinterpret_cast<Tile*>(shared);
  const int bricks_y = (ny + kBY - 1) / kBY, bricks_z = (nz + kBZ - 1) / kBZ;
  const int brick = blockIdx.x;
  const int x0 = brick / (bricks_y * bricks_z) * kBX;
  const int y0 = brick / bricks_z % bricks_y * kBY;
  const int z0 = brick % bricks_z * kBZ;
  // this thread's cell of the brick
  const int a = threadIdx.x / (kBY * kBZ), b = threadIdx.x / kBZ % kBY, k = threadIdx.x % kBZ;
  const bool mine = x0 + a < nx && y0 + b < ny && z0 + k < nz;
  const int64_t cell = (static_cast<int64_t>(x0 + a) * ny + (y0 + b)) * nz + (z0 + k);
  float acc[5];
  for (int f = 0; f < 5; ++f) acc[f] = mine ? __ldg(u.f[f] + cell) : 0.0f;

  load_primitives<kFromConserved>(t, src, map, x0, y0, z0, nx, ny, nz, c);
  __syncthreads();
  predict(t, x0, y0, z0, nx, ny, nz, c);
  __syncthreads();
  // each thread the low faces of its cell along x, y and z, then the brick's
  // high faces (kXLayer + kYLayer + kZLayer of them) on the first threads
  solve_face<0, kExact>(t, a, b, k, x0, y0, z0, nx, ny, nz, c);
  solve_face<1, kExact>(t, a, b, k, x0, y0, z0, nx, ny, nz, c);
  solve_face<2, kExact>(t, a, b, k, x0, y0, z0, nx, ny, nz, c);
  const int h = threadIdx.x;
  if (h < kXLayer) {
    solve_face<0, kExact>(t, kBX, h / kBZ, h % kBZ, x0, y0, z0, nx, ny, nz, c);
  } else if (h < kXLayer + kYLayer) {
    const int r = h - kXLayer;
    solve_face<1, kExact>(t, r / kBZ, kBY, r % kBZ, x0, y0, z0, nx, ny, nz, c);
  } else if (h < kXLayer + kYLayer + kZLayer) {
    const int r = h - kXLayer - kYLayer;
    solve_face<2, kExact>(t, r / kBY, r % kBY, kBZ, x0, y0, z0, nx, ny, nz, c);
  }
  __syncthreads();
  add_axis<0>(t, a, b, k, c, acc);
  add_axis<1>(t, a, b, k, c, acc);
  add_axis<2>(t, a, b, k, c, acc);
  if (mine) {
    out.f[0][cell] = max_nan(acc[0], kRhoFloor);
    for (int f = 1; f < 5; ++f) out.f[f][cell] = acc[f];
  }
}

// The kernel's shared memory is above the 48 KB of a static allocation: it
// is dynamic, allowed once per kernel and device before its first launch.
constexpr int kMaxDevices = 64;

template <bool kFromConserved, bool kExact>
cudaError_t allow_tile() {
  static bool allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < kMaxDevices && allowed[device])) return err;
  err = cudaFuncSetAttribute(hydro_step_kernel<kFromConserved, kExact>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Tile));
  if (err == cudaSuccess && device < kMaxDevices) allowed[device] = true;
  return err;
}

template <bool kFromConserved, bool kExact>
cudaError_t launch(const Fields5& src, const int* map, const Fields5& u,
                   const OutFields5& out, int nx, int ny, int nz, const Consts& c,
                   cudaStream_t s) {
  const cudaError_t err = allow_tile<kFromConserved, kExact>();
  if (err != cudaSuccess) return err;
  const int bricks = ((nx + kBX - 1) / kBX) * ((ny + kBY - 1) / kBY) * ((nz + kBZ - 1) / kBZ);
  hydro_step_kernel<kFromConserved, kExact><<<bricks, kThreads, sizeof(Tile), s>>>(
      src, map, u, out, nx, ny, nz, c);
  return cudaGetLastError();
}

}  // namespace

// Launches K3 on `stream`; returns cudaGetLastError() (0 on success).
// src: with from_conserved, the 5 conserved fields (the same as u) and `map`
// the ghost map of the three axes, (nx+4) + (ny+4) + (nz+4) ints
// (ops/hydro.py:ghost_map: a padded index's source cell, bit-inverted where
// the normal velocity flips); without it, 5 primitives padded with 2 ghosts
// per side ((nx+4)(ny+4)(nz+4) each) and `map` unused.  u, out: 5 conserved
// fields of nx*ny*nz.  The f32 constants in Consts order (gamma ...
// inv_dx[2]) follow the ints; exact: 0 for HLLC, 1 for the exact solver.
extern "C" int cmi_hydro_step(
    const float* s0, const float* s1, const float* s2, const float* s3,
    const float* s4, const int* map, const float* u_rho, const float* u_mx,
    const float* u_my, const float* u_mz, const float* u_e, float* out_rho,
    float* out_mx, float* out_my, float* out_mz, float* out_e, int nx, int ny,
    int nz, int from_conserved, int exact, int n_iter, float gamma, float gm1,
    float cq, float gp1, float g1r, float gz, float inv_gz, float neg_exp,
    float half_gm1, float c2gp1, float e_rho, float e_p, float inv_g, float dt,
    float half_dt, float inv_dx0, float inv_dx1, float inv_dx2, void* stream) {
  const Consts c = {gamma, gm1, cq, gp1, g1r, gz, inv_gz, neg_exp, half_gm1, c2gp1,
                    e_rho, e_p, inv_g, dt, half_dt, {inv_dx0, inv_dx1, inv_dx2}, n_iter};
  const Fields5 src = {{s0, s1, s2, s3, s4}};
  const Fields5 u = {{u_rho, u_mx, u_my, u_mz, u_e}};
  const OutFields5 out = {{out_rho, out_mx, out_my, out_mz, out_e}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<int64_t>(nx) * ny * nz == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
  if (from_conserved) {
    err = exact ? launch<true, true>(src, map, u, out, nx, ny, nz, c, s)
                : launch<true, false>(src, map, u, out, nx, ny, nz, c, s);
  } else {
    err = exact ? launch<false, true>(src, map, u, out, nx, ny, nz, c, s)
                : launch<false, false>(src, map, u, out, nx, ny, nz, c, s);
  }
  return static_cast<int>(err);
}

// The registers a thread of K3's HLLC kernel takes, (U) or (P), and its
// blocks resident on one SM of the current device with its shared memory,
// and that device's SM count; return the CUDA error (0 on success).
extern "C" int cmi_hydro_step_u_occupancy(int* registers, int* blocks_per_sm, int* sms) {
  const cudaError_t err = allow_tile<true, false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return cmi_occupancy::query(hydro_step_kernel<true, false>, kThreads, registers,
                              blocks_per_sm, sms, sizeof(Tile));
}

extern "C" int cmi_hydro_step_p_occupancy(int* registers, int* blocks_per_sm, int* sms) {
  const cudaError_t err = allow_tile<false, false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return cmi_occupancy::query(hydro_step_kernel<false, false>, kThreads, registers,
                              blocks_per_sm, sms, sizeof(Tile));
}
