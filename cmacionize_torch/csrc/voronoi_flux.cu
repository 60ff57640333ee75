// K7: one moving-face Godunov update on a Voronoi cell graph (MUSCL with
// least-squares gradients, HLLC in the face frame, trial + first-order
// fallback), one thread per cell.
//
// Replaces cmacionize_tpu/models/voronoi_hydro.py:_voronoi_flux_update with
// its _lsq_gradients.  The plain PyTorch version is
// cmacionize_torch/models/voronoi_hydro.py:voronoi_flux_update_reference.
//
// Inputs: the intensive conserved state u (5 fields of C floats), the padded
// [C, K] rows (neighbours int32: >= 0 cell, -1 wall, -2 padding; normals
// [C, K, 3]; A/V [C, K], formed in f64 on the host; the face arm
// face_rel [C, K, 3] and the neighbour offset nbr_rel [C, K, 3], meters) and
// the grid velocity gen_vel [C, 3].  Three passes, because the trial flag of
// every neighbour must exist before the final one:
//   1. gradients_kernel (second order only): the least-squares matrix G of
//      the cell, built once for the five primitives (the JAX function builds
//      it five times), with the Tikhonov floor; per primitive the right-hand
//      side with w * dW rounded first (in SI units this underflows for
//      density, ROADMAP.md queue 3), an LU solve with partial pivoting in
//      getrf/getrs order, the Barth-Jespersen limiter with the slope factor;
//      then the half-dt prediction with its positivity fallback.  Writes the
//      limited gradients [5, C, 3] and the predicted primitives [5, C];
//   2. trial_kernel (second order only): per face the second-order states
//      (face_L, face_R from the neighbour's arm, the pair clamp, the wall
//      mirror, the projection on (n, t1, t2)), HLLC in the face frame with
//      w_n, de-boosted, summed as flux * A/V * active * dt over the K faces;
//      writes flag[c] = rho2 < rho/4 or E2 < E/4 or either not finite;
//   3. update_kernel: per face the first-order states where flag_i | flag_j
//      (everywhere without second order), the second-order ones elsewhere;
//      HLLC again, summed, and the new state written.
// Each face is computed from both of its cells with the same arithmetic, as
// in the JAX function: no atomics, deterministic.
//
// Precision: built with --fmad=false and without fast math.  Every sum over
// a cell's faces runs in face order from face 0, every 3-term dot product
// left to right, exactly as the plain version writes them; the constants
// (gamma, gamma - 1, (gamma + 1) / (2 gamma), dt, slope factor) arrive as
// f32 values formed in double on the host.  So K7 repeats the plain
// version's f32 operations one for one.  1e-300 in the JAX source rounds to
// 0 in f32 (max(rho, 1e-300) is max(rho, 0)); subnormals are kept.
//
// What bounds it on an H100: at C = 40000, K = 25 the rows are 40000 x 25 x
// (4 + 12 + 4 + 12 + 12 + 4) B = 48 MB, read three times per update, and the
// neighbour gathers hit the 2 MB of state and the 3.2 MB of scratch in L2;
// each face runs two HLLC solves (trial and update) and each cell five 3x3
// solves.  A thread per cell keeps its five primitives, gradients and
// accumulators in registers.  One flux per face (both sides from one
// evaluation) and face-major tiles in shared memory are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hllc.cuh"

namespace {

using cmi::hllc_flux;
using cmi::max_nan;
using cmi::min_nan;

constexpr int kThreads = 128;
constexpr float kFloor = 1e-30f;   // the density and pressure floors, w floor
constexpr float kTinyW = 1e-12f;   // limiter threshold on an extrapolation
constexpr float kDegenerate = 1e-6f;

struct Consts {
  float gamma;         // gamma
  float gm1;           // gamma - 1
  float cq;            // (gamma + 1) / (2 gamma)
  float dt;
  float half_dt;       // 0.5 dt
  float slope_factor;
};

struct Rows {
  const int* nbr;           // [C, K]
  const float* normals;     // [C, K, 3]
  const float* aov;         // [C, K]
  const float* face_rel;    // [C, K, 3]
  const float* nbr_rel;     // [C, K, 3]
  const float* gen_vel;     // [C, 3]
  int C, K;
};

struct State5 {
  const float* f[5];
};
struct Out5 {
  float* f[5];
};

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// primitives_from_conserved for one cell: rho, vx, vy, vz, p
__device__ __forceinline__ void primitives(const State5& u, int c,
                                           const Consts& k, float w[5]) {
  const float rho = u.f[0][c];
  const float mx = u.f[1][c], my = u.f[2][c], mz = u.f[3][c];
  const float inv_rho = 1.0f / max_nan(rho, 0.0f);
  const float vx = mx * inv_rho, vy = my * inv_rho, vz = mz * inv_rho;
  const float ekin = 0.5f * (mx * vx + my * vy + mz * vz);
  w[0] = rho;
  w[1] = vx;
  w[2] = vy;
  w[3] = vz;
  w[4] = max_nan((u.f[4][c] - ekin) * k.gm1, 1e-30f);
}

// face_basis: t1 = (-n_y, n_x, 0), or (0, -n_z, n_y) where that is shorter
// than 1e-6, normalised; t2 = n x t1
__device__ __forceinline__ void face_basis(const float n[3], float t1[3],
                                           float t2[3]) {
  t1[0] = -n[1];
  t1[1] = n[0];
  t1[2] = 0.0f;
  if (sqrtf(dot3(t1, t1)) < kDegenerate) {
    t1[0] = 0.0f;
    t1[1] = -n[2];
    t1[2] = n[1];
  }
  const float norm = max_nan(sqrtf(dot3(t1, t1)), 1e-30f);
  for (int a = 0; a < 3; ++a) t1[a] = t1[a] / norm;
  t2[0] = n[1] * t1[2] - n[2] * t1[1];
  t2[1] = n[2] * t1[0] - n[0] * t1[2];
  t2[2] = n[0] * t1[1] - n[1] * t1[0];
}

struct Face {
  float n[3], t1[3], t2[3];
  bool is_cell, is_wall;
  int j;       // the neighbour, or cell 0 where there is none (as the JAX gather)
  float w_n;   // face speed along n
  float wA;    // A/V * active * dt
};

__device__ __forceinline__ void load_face(const Rows& r, int c, int k,
                                          const Consts& kc, Face& f) {
  const int64_t row = static_cast<int64_t>(c) * r.K + k;
  const int nb = __ldg(r.nbr + row);
  for (int a = 0; a < 3; ++a) f.n[a] = __ldg(r.normals + row * 3 + a);
  face_basis(f.n, f.t1, f.t2);
  f.is_cell = nb >= 0;
  f.is_wall = nb == -1;
  f.j = nb > 0 ? nb : 0;
  float gi[3], gj[3];
  for (int a = 0; a < 3; ++a) {
    gi[a] = __ldg(r.gen_vel + static_cast<int64_t>(c) * 3 + a);
    gj[a] = __ldg(r.gen_vel + static_cast<int64_t>(f.j) * 3 + a);
  }
  const float gvn = dot3(gi, f.n), gvn_nbr = dot3(gj, f.n);
  f.w_n = f.is_cell ? 0.5f * (gvn + gvn_nbr) : 0.0f;
  const float active = (f.is_cell || f.is_wall) ? 1.0f : 0.0f;
  f.wA = __ldg(r.aov + row) * active * kc.dt;
}

// the face's Riemann problem from left/right primitives (rho, vx, vy, vz, p)
// already through the mirror/selection of the caller: HLLC in the face frame,
// de-boosted, the momentum rotated to xyz; out = mass, mx, my, mz, energy
__device__ __forceinline__ void face_flux(const Face& f, float rhoL, float uL,
                                          float ut1L, float ut2L, float pL,
                                          float rhoR, float uR, float ut1R,
                                          float ut2R, float pR,
                                          const Consts& kc, float out[5]) {
  float fl[5];
  hllc_flux(rhoL, uL - f.w_n, ut1L, ut2L, pL, rhoR, uR - f.w_n, ut1R, ut2R,
            pR, kc, fl);
  const float f_e = fl[4] + f.w_n * (fl[1] + 0.5f * f.w_n * fl[0]);
  const float f_un = fl[1] + f.w_n * fl[0];
  out[0] = fl[0];
  for (int a = 0; a < 3; ++a) {
    out[1 + a] = f_un * f.n[a] + fl[2] * f.t1[a] + fl[3] * f.t2[a];
  }
  out[4] = f_e;
}

// first-order states of a face: the cell's primitives, the neighbour's (or
// the wall mirror), projected
__device__ __forceinline__ void first_order_flux(const Face& f,
                                                 const float wi[5],
                                                 const float wj[5],
                                                 const Consts& kc,
                                                 float out[5]) {
  const float vi[3] = {wi[1], wi[2], wi[3]};
  const float vj[3] = {wj[1], wj[2], wj[3]};
  const float uL = dot3(vi, f.n), ut1L = dot3(vi, f.t1), ut2L = dot3(vi, f.t2);
  const float uRn = dot3(vj, f.n), ut1Rn = dot3(vj, f.t1), ut2Rn = dot3(vj, f.t2);
  const float rhoR = f.is_cell ? wj[0] : wi[0];
  const float pR = f.is_cell ? wj[4] : wi[4];
  const float uR = f.is_cell ? uRn : -uL;
  const float ut1R = f.is_cell ? ut1Rn : ut1L;
  const float ut2R = f.is_cell ? ut2Rn : ut2L;
  face_flux(f, wi[0], uL, ut1L, ut2L, wi[4], rhoR, uR, ut1R, ut2R, pR, kc, out);
}

// second-order states of a face from the predicted primitives and limited
// gradients of both cells (scratch), clamped to the pair's envelope
__device__ __forceinline__ void second_order_flux(
    const Rows& r, const Face& f, int c, int k, const float wi[5],
    const float wj[5], const float* __restrict__ grad,
    const float* __restrict__ pred, const Consts& kc, float out[5]) {
  const int64_t row = static_cast<int64_t>(c) * r.K + k;
  float arm_i[3], arm_j[3];
  for (int a = 0; a < 3; ++a) {
    arm_i[a] = __ldg(r.face_rel + row * 3 + a);
    arm_j[a] = arm_i[a] - __ldg(r.nbr_rel + row * 3 + a);
  }
  float L[5], R[5];
  for (int q = 0; q < 5; ++q) {
    float gi[3], gj[3];
    for (int a = 0; a < 3; ++a) {
      gi[a] = grad[(static_cast<int64_t>(q) * r.C + c) * 3 + a];
      gj[a] = grad[(static_cast<int64_t>(q) * r.C + f.j) * 3 + a];
    }
    const float left = pred[static_cast<int64_t>(q) * r.C + c] + dot3(arm_i, gi);
    const float right = pred[static_cast<int64_t>(q) * r.C + f.j] + dot3(arm_j, gj);
    const float lo = min_nan(wi[q], wj[q]);
    const float hi = max_nan(wi[q], wj[q]);
    L[q] = min_nan(max_nan(left, lo), hi);
    R[q] = min_nan(max_nan(right, lo), hi);
  }
  const float rhoL = max_nan(L[0], kFloor);
  const float pL = max_nan(L[4], kFloor);
  const float vL[3] = {L[1], L[2], L[3]};
  const float vR[3] = {R[1], R[2], R[3]};
  const float uL = dot3(vL, f.n), ut1L = dot3(vL, f.t1), ut2L = dot3(vL, f.t2);
  const float rhoR = f.is_cell ? max_nan(R[0], kFloor) : rhoL;
  const float pR = f.is_cell ? max_nan(R[4], kFloor) : pL;
  const float uRn = dot3(vR, f.n), ut1Rn = dot3(vR, f.t1), ut2Rn = dot3(vR, f.t2);
  const float uR = f.is_cell ? uRn : -uL;
  const float ut1R = f.is_cell ? ut1Rn : ut1L;
  const float ut2R = f.is_cell ? ut2Rn : ut2L;
  face_flux(f, rhoL, uL, ut1L, ut2L, pL, rhoR, uR, ut1R, ut2R, pR, kc, out);
}

// LU with partial pivoting in getrf order, then getrs: as
// voronoi_hydro.py:lu_solve3
__device__ __forceinline__ void lu_solve3(float A[3][3], float x[3]) {
  for (int j = 0; j < 3; ++j) {
    int best = j;
    float big = fabsf(A[j][j]);
    for (int i = j + 1; i < 3; ++i) {
      if (fabsf(A[i][j]) > big) {
        best = i;
        big = fabsf(A[i][j]);
      }
    }
    if (best != j) {
      for (int col = 0; col < 3; ++col) {
        const float t = A[j][col];
        A[j][col] = A[best][col];
        A[best][col] = t;
      }
      const float t = x[j];
      x[j] = x[best];
      x[best] = t;
    }
    const float recip = 1.0f / A[j][j];
    for (int i = j + 1; i < 3; ++i) {
      A[i][j] = A[i][j] * recip;
      for (int col = j + 1; col < 3; ++col) {
        A[i][col] = A[i][col] - A[i][j] * A[j][col];
      }
    }
  }
  for (int k = 0; k < 3; ++k) {
    for (int i = k + 1; i < 3; ++i) x[i] = x[i] - x[k] * A[i][k];
  }
  for (int k = 2; k >= 0; --k) {
    x[k] = x[k] / A[k][k];
    for (int i = 0; i < k; ++i) x[i] = x[i] - x[k] * A[i][k];
  }
}

__global__ void __launch_bounds__(kThreads) gradients_kernel(
    State5 u, Rows r, Consts kc, float* __restrict__ grad,
    float* __restrict__ pred) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= r.C) return;
  float wi[5];
  primitives(u, c, kc, wi);
  const int64_t base = static_cast<int64_t>(c) * r.K;

  // G = sum_k (w d_a) d_b over the faces in order, from face 0
  float G[3][3];
  for (int k = 0; k < r.K; ++k) {
    const bool is_cell = __ldg(r.nbr + base + k) >= 0;
    float d[3];
    for (int a = 0; a < 3; ++a) d[a] = __ldg(r.nbr_rel + (base + k) * 3 + a);
    const float w = is_cell ? 1.0f / max_nan(dot3(d, d), 1e-30f) : 0.0f;
    for (int a = 0; a < 3; ++a) {
      const float wd = w * d[a];
      for (int b = 0; b < 3; ++b) {
        G[a][b] = k == 0 ? wd * d[b] : G[a][b] + wd * d[b];
      }
    }
  }
  const float tr = G[0][0] + G[1][1] + G[2][2];
  const float floor = 1e-8f * max_nan(tr, 1e-30f);
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b) G[a][b] = G[a][b] + floor * (a == b ? 1.0f : 0.0f);
  }

  float g[5][3];
  for (int q = 0; q < 5; ++q) {
    float b[3];
    float wmax = wi[q], wmin = wi[q];  // running max/min over the rows and W
    bool first = true;
    for (int k = 0; k < r.K; ++k) {
      const int nb = __ldg(r.nbr + base + k);
      const bool is_cell = nb >= 0;
      float wj[5];
      primitives(u, nb > 0 ? nb : 0, kc, wj);
      float d[3];
      for (int a = 0; a < 3; ++a) d[a] = __ldg(r.nbr_rel + (base + k) * 3 + a);
      const float w = is_cell ? 1.0f / max_nan(dot3(d, d), 1e-30f) : 0.0f;
      const float wdw = w * (is_cell ? wj[q] - wi[q] : 0.0f);
      for (int a = 0; a < 3; ++a) b[a] = first ? wdw * d[a] : b[a] + wdw * d[a];
      first = false;
      const float nbrW = is_cell ? wj[q] : wi[q];
      wmax = k == 0 ? nbrW : max_nan(wmax, nbrW);
      wmin = k == 0 ? nbrW : min_nan(wmin, nbrW);
    }
    float A[3][3];
    for (int a = 0; a < 3; ++a)
      for (int bb = 0; bb < 3; ++bb) A[a][bb] = G[a][bb];
    lu_solve3(A, b);
    const float hi = max_nan(wmax, wi[q]) - wi[q];
    const float lo = min_nan(wmin, wi[q]) - wi[q];
    float amin = 0.0f;
    for (int k = 0; k < r.K; ++k) {
      const int nb = __ldg(r.nbr + base + k);
      float arm[3];
      for (int a = 0; a < 3; ++a) arm[a] = __ldg(r.face_rel + (base + k) * 3 + a);
      const float ext = dot3(arm, b);
      float a_k = ext > kTinyW    ? hi / max_nan(ext, kTinyW)
                  : ext < -kTinyW ? lo / min_nan(ext, -kTinyW)
                                  : 1.0f;
      if (nb < -1) a_k = 1.0f;  // padding
      amin = k == 0 ? a_k : min_nan(amin, a_k);
    }
    const float alpha = kc.slope_factor * min_nan(max_nan(amin, 0.0f), 1.0f);
    for (int a = 0; a < 3; ++a) g[q][a] = b[a] * alpha;
  }
  for (int q = 0; q < 5; ++q)
    for (int a = 0; a < 3; ++a)
      grad[(static_cast<int64_t>(q) * r.C + c) * 3 + a] = g[q][a];

  // half-dt primitive prediction (predict_primitive_variables)
  const float rho = wi[0], vx = wi[1], vy = wi[2], vz = wi[3], p = wi[4];
  const float half = kc.half_dt;
  const float div_v = g[1][0] + g[2][1] + g[3][2];
  const float inv_rho_c = 1.0f / max_nan(rho, 0.0f);
  float vd[5];
  for (int q = 0; q < 5; ++q) vd[q] = vx * g[q][0] + vy * g[q][1] + vz * g[q][2];
  float rho_p = rho - half * (vd[0] + rho * div_v);
  const float vx_p = vx - half * (vd[1] + g[4][0] * inv_rho_c);
  const float vy_p = vy - half * (vd[2] + g[4][1] * inv_rho_c);
  const float vz_p = vz - half * (vd[3] + g[4][2] * inv_rho_c);
  float p_p = p - half * (vd[4] + kc.gamma * p * div_v);
  // positivity: fall back to the unpredicted value (SAFE_HYDRO)
  rho_p = rho_p > 0.0f ? rho_p : rho;
  p_p = p_p > 0.0f ? p_p : p;
  const float out[5] = {rho_p, vx_p, vy_p, vz_p, p_p};
  for (int q = 0; q < 5; ++q) pred[static_cast<int64_t>(q) * r.C + c] = out[q];
}

__global__ void __launch_bounds__(kThreads) trial_kernel(
    State5 u, Rows r, Consts kc, const float* __restrict__ grad,
    const float* __restrict__ pred, uint8_t* __restrict__ flag) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= r.C) return;
  float wi[5];
  primitives(u, c, kc, wi);
  float acc_rho = 0.0f, acc_e = 0.0f;
  for (int k = 0; k < r.K; ++k) {
    Face f;
    load_face(r, c, k, kc, f);
    float wj[5];
    primitives(u, f.j, kc, wj);
    float fl[5];
    second_order_flux(r, f, c, k, wi, wj, grad, pred, kc, fl);
    const float x_rho = fl[0] * f.wA, x_e = fl[4] * f.wA;
    acc_rho = k == 0 ? x_rho : acc_rho + x_rho;
    acc_e = k == 0 ? x_e : acc_e + x_e;
  }
  const float rho0 = u.f[0][c], e0 = u.f[4][c];
  const float rho2 = rho0 + -acc_rho;
  const float e2 = e0 + -acc_e;
  const bool bad = rho2 < 0.25f * rho0 || e2 < 0.25f * e0 || !isfinite(rho2) ||
                   !isfinite(e2);
  flag[c] = bad ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads) update_kernel(
    State5 u, Rows r, Consts kc, const float* __restrict__ grad,
    const float* __restrict__ pred, const uint8_t* __restrict__ flag,
    int second_order, Out5 out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= r.C) return;
  float wi[5];
  primitives(u, c, kc, wi);
  const bool flag_i = second_order && flag[c] != 0;
  float acc[5];
  for (int k = 0; k < r.K; ++k) {
    Face f;
    load_face(r, c, k, kc, f);
    float wj[5];
    primitives(u, f.j, kc, wj);
    const bool bad =
        !second_order || flag_i || (f.is_cell && flag[f.j] != 0);
    float fl[5];
    if (bad) {
      first_order_flux(f, wi, wj, kc, fl);
    } else {
      second_order_flux(r, f, c, k, wi, wj, grad, pred, kc, fl);
    }
    for (int q = 0; q < 5; ++q) {
      const float x = fl[q] * f.wA;
      acc[q] = k == 0 ? x : acc[q] + x;
    }
  }
  for (int q = 0; q < 5; ++q) out.f[q][c] = u.f[q][c] + -acc[q];
}

}  // namespace

// Launches K7 on `stream`; returns the first cudaGetLastError() that is not
// 0, else 0.  u: 5 conserved fields of C floats; out: 5 fields of C floats;
// nbr/aov [C*K]; normals, face_rel, nbr_rel [C*K*3]; gen_vel [C*3]; grad
// [5*C*3], pred [5*C] and flag [C] scratch (unused, and may be null, without
// second order); consts: a HOST array of the 6 f32 constants in Consts
// order (gamma, gamma - 1, (gamma + 1)/(2 gamma), dt, dt/2, slope factor).
extern "C" int cmi_voronoi_flux(
    const float* u_rho, const float* u_mx, const float* u_my,
    const float* u_mz, const float* u_e, float* out_rho, float* out_mx,
    float* out_my, float* out_mz, float* out_e, const int* nbr,
    const float* normals, const float* aov, const float* face_rel,
    const float* nbr_rel, const float* gen_vel, float* grad, float* pred,
    uint8_t* flag, const float* consts, int C, int K, int second_order,
    void* stream) {
  Consts kc;
  kc.gamma = consts[0];
  kc.gm1 = consts[1];
  kc.cq = consts[2];
  kc.dt = consts[3];
  kc.half_dt = consts[4];
  kc.slope_factor = consts[5];
  const State5 u = {{u_rho, u_mx, u_my, u_mz, u_e}};
  const Out5 out = {{out_rho, out_mx, out_my, out_mz, out_e}};
  const Rows r = {nbr, normals, aov, face_rel, nbr_rel, gen_vel, C, K};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (C + kThreads - 1) / kThreads;
  if (second_order) {
    gradients_kernel<<<blocks, kThreads, 0, s>>>(u, r, kc, grad, pred);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    trial_kernel<<<blocks, kThreads, 0, s>>>(u, r, kc, grad, pred, flag);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  update_kernel<<<blocks, kThreads, 0, s>>>(u, r, kc, grad, pred, flag,
                                            second_order, out);
  return static_cast<int>(cudaGetLastError());
}
