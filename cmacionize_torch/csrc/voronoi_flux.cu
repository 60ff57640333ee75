// K7: one moving-face Godunov update on a Voronoi cell graph (MUSCL with
// least-squares gradients, HLLC in the face frame, trial + first-order
// fallback), with a thread per face slot.
//
// Replaces cmacionize_tpu/models/voronoi_hydro.py:_voronoi_flux_update with
// its _lsq_gradients.  The plain PyTorch version is
// cmacionize_torch/models/voronoi_hydro.py:voronoi_flux_update_reference.
//
// Inputs: the intensive conserved state u (5 fields of C floats), the padded
// [C, K] rows (neighbours int32: >= 0 cell, -1 wall, -2 padding; normals
// [C, K, 3]; A/V [C, K], formed in f64 on the host; the face arm
// face_rel [C, K, 3] and the neighbour offset nbr_rel [C, K, 3], meters) and
// the grid velocity gen_vel [C, 3].  Four launches, because each needs the
// previous one's values of every cell, neighbours included:
//   1. primitives_kernel, a thread a cell: the five primitives W
//      (primitives_from_conserved) and the grid velocity into the cell's
//      record, read by every later pass for the cell and its neighbours;
//   2. gradients_kernel (second order only): the least-squares matrix G of
//      each cell, built once for the five primitives (the JAX function builds
//      it five times), with the Tikhonov floor; per primitive the right-hand
//      side with w * dW rounded first (in SI units this underflows for
//      density, ROADMAP.md queue 3), an LU solve with partial pivoting in
//      getrf/getrs order, the Barth-Jespersen limiter with the slope factor;
//      then the half-dt prediction with its positivity fallback.  Writes the
//      predicted primitives and the limited gradients into the record;
//   3. trial_kernel (second order only): per face the second-order states
//      (face_L, face_R from the neighbour's arm, the pair clamp, the wall
//      mirror, the projection on (n, t1, t2)), HLLC in the face frame with
//      w_n, de-boosted, times A/V * active * dt; the five sums over the K
//      faces, the flag (rho2 < rho/4 or E2 < E/4 or either not finite, and
//      a count of the flagged cells) and the new state of the cell as if no
//      face were first order;
//   4. update_kernel: the rows with a first-order face (a face of a flagged
//      cell, or whose neighbour is flagged; every row without second order)
//      again: the first-order states on those faces, the second-order ones
//      elsewhere (the trial's arithmetic on the trial's inputs, so the same
//      bits), HLLC, the sums and the new state.  A row without such a face
//      keeps the trial's new state: the parent computed the same sums a
//      second time.  With no cell flagged, every block leaves at once.
// Each face is computed from both of its cells with the same arithmetic, as
// in the JAX function: no atomics on any value (only on the count of flagged
// cells), deterministic.
//
// The layout: a block of 256 threads holds R = min(256 / K, 32) whole rows,
// a thread per face slot (thread t: row t / K, slot t % K; at K = 25 ten rows
// and 250 threads).  The slots' loads are coalesced along the rows, and the
// face work (the states, the HLLC solve, its divisions and square roots, the
// gradient's per-face terms and limiter ratios) runs on ~C * K lanes, not C.
// A cell's own values and those its neighbours' faces gather (W, the grid
// velocity, the predictions and the gradients) sit in one 128-byte record a
// cell, so that a neighbour costs one line, read as float4s, and not one
// 32-byte sector per field.  Each slot's terms go to shared memory, and one
// thread per cell and component sums them from face 0 in face order, as the
// plain version's _ksum and the JAX function do.  Padding slots are computed too: their
// products are flux * 0, and adding them keeps the bits of the plain sum over
// all K slots (a -0.0 sum meets +0.0 there).
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
// (4 + 12 + 4 + 12 + 12) B = 44 MB, read by the gradient pass (neighbours,
// offsets, arms) and the trial pass (all of them), and again by the update
// on its few rows; the neighbour gathers hit the 5 MB of records in L2.  Each face slot runs one HLLC solve (two on a
// row with a first-order face) and each cell five 3x3 solves.  One flux per
// face (both sides from one evaluation) would change bits and is not done.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hllc.cuh"
#include "occupancy.cuh"

namespace {

using cmi::hllc_flux;
using cmi::max_nan;
using cmi::min_nan;

constexpr int kBlock = 256;       // threads a block of the row kernels
constexpr int kMaxRows = 32;      // rows a block holds at most
constexpr int kCellThreads = 128;  // threads a block of primitives_kernel
constexpr int kTerms = 29;        // a slot's gradient terms: G 9, rhs 15, neighbour W 5
// a cell's record, 32 floats (128 B, one line): W [0, 5), the grid velocity
// [5, 8), the predicted primitives [8, 13), the limited gradients [13, 28)
// as q * 3 + axis
constexpr int kRecord = 32;
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
  int C, K, R;              // R: rows a block
};

struct State5 {
  const float* f[5];
};

// a thread's face slot: row r of the block (cell c), slot k; live where the
// thread holds a slot of a cell
struct Slot {
  int r, k, c;
  bool live;
};

__device__ __forceinline__ Slot slot_of(const Rows& rows) {
  Slot s;
  const int t = threadIdx.x;
  s.r = t / rows.K;
  s.k = t - s.r * rows.K;
  s.c = blockIdx.x * rows.R + s.r;
  s.live = s.r < rows.R && s.c < rows.C;
  return s;
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// a cell's primitives and grid velocity: the record's first 32 B
__device__ __forceinline__ void load_w(const float* __restrict__ record, int c, float w[5],
                                       float gv[3]) {
  const float4* r = reinterpret_cast<const float4*>(record + static_cast<int64_t>(c) * kRecord);
  const float4 a = __ldg(r), b = __ldg(r + 1);
  w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w, w[4] = b.x;
  gv[0] = b.y, gv[1] = b.z, gv[2] = b.w;
}

// a cell's predicted primitives and limited gradients: the record's floats
// [8, 28)
__device__ __forceinline__ void load_second(const float* __restrict__ record, int c,
                                            float pred[5], float grad[15]) {
  const float4* r =
      reinterpret_cast<const float4*>(record + static_cast<int64_t>(c) * kRecord) + 2;
  float v[20];
  for (int i = 0; i < 5; ++i) {
    const float4 x = __ldg(r + i);
    v[4 * i] = x.x, v[4 * i + 1] = x.y, v[4 * i + 2] = x.z, v[4 * i + 3] = x.w;
  }
  for (int q = 0; q < 5; ++q) pred[q] = v[q];
  for (int i = 0; i < 15; ++i) grad[i] = v[5 + i];
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

// the face of slot k of cell c whose neighbour code is nb; gi, gj the grid
// velocities of the cell and of f.j
__device__ __forceinline__ void load_face(const Rows& r, int c, int k, int nb,
                                          const float gi[3], const float gj[3],
                                          const Consts& kc, Face& f) {
  const int64_t row = static_cast<int64_t>(c) * r.K + k;
  for (int a = 0; a < 3; ++a) f.n[a] = __ldg(r.normals + row * 3 + a);
  face_basis(f.n, f.t1, f.t2);
  f.is_cell = nb >= 0;
  f.is_wall = nb == -1;
  f.j = nb > 0 ? nb : 0;
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
    const float wj[5], const float* __restrict__ record, const Consts& kc, float out[5]) {
  const int64_t row = static_cast<int64_t>(c) * r.K + k;
  float arm_i[3], arm_j[3];
  for (int a = 0; a < 3; ++a) {
    arm_i[a] = __ldg(r.face_rel + row * 3 + a);
    arm_j[a] = arm_i[a] - __ldg(r.nbr_rel + row * 3 + a);
  }
  float pred_i[5], grad_i[15], pred_j[5], grad_j[15];
  load_second(record, c, pred_i, grad_i);
  load_second(record, f.j, pred_j, grad_j);
  float L[5], R[5];
  for (int q = 0; q < 5; ++q) {
    const float left = pred_i[q] + dot3(arm_i, grad_i + 3 * q);
    const float right = pred_j[q] + dot3(arm_j, grad_j + 3 * q);
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

// the sums over the row of `terms` components of the slots' values in
// shared memory (value[component][thread]), each from face 0 in face order,
// into sum[component][row]; one thread a row and component
template <int kComponents>
__device__ __forceinline__ void row_sums(const Rows& rows, float (*value)[kBlock],
                                         float (*sum)[kMaxRows]) {
  for (int p = threadIdx.x; p < kComponents * rows.R; p += kBlock) {
    const int q = p / rows.R;
    const int r = p - q * rows.R;
    const float* v = value[q] + r * rows.K;
    float acc = v[0];
    for (int k = 1; k < rows.K; ++k) acc = acc + v[k];
    sum[q][r] = acc;
  }
}

__global__ void __launch_bounds__(kCellThreads) primitives_kernel(
    State5 u, const float* __restrict__ gen_vel, int C, Consts kc, float* __restrict__ record,
    int* __restrict__ flagged) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c == 0) *flagged = 0;  // the trial's count of flagged cells starts at 0
  if (c >= C) return;
  const float rho = u.f[0][c];
  const float mx = u.f[1][c], my = u.f[2][c], mz = u.f[3][c];
  const float inv_rho = 1.0f / max_nan(rho, 0.0f);
  const float vx = mx * inv_rho, vy = my * inv_rho, vz = mz * inv_rho;
  const float ekin = 0.5f * (mx * vx + my * vy + mz * vz);
  const float p = max_nan((u.f[4][c] - ekin) * kc.gm1, 1e-30f);
  float4* r = reinterpret_cast<float4*>(record + static_cast<int64_t>(c) * kRecord);
  const float* gv = gen_vel + static_cast<int64_t>(c) * 3;
  r[0] = make_float4(rho, vx, vy, vz);
  r[1] = make_float4(p, gv[0], gv[1], gv[2]);
}

__global__ void __launch_bounds__(kBlock) gradients_kernel(Rows rows, Consts kc,
                                                           float* __restrict__ record) {
  __shared__ float term[kTerms][kBlock];  // a slot's terms; later its limiter ratios
  __shared__ float sum[24][kMaxRows];     // a row's G (9) and right-hand sides (15)
  __shared__ float wmax[5][kMaxRows], wmin[5][kMaxRows];
  __shared__ float g[15][kMaxRows];       // a row's gradients, [q * 3 + axis]
  __shared__ float hi[5][kMaxRows], lo[5][kMaxRows];
  const Slot s = slot_of(rows);
  const int C = rows.C;
  const int t = threadIdx.x;

  // 1. a slot's terms: w d_a d_b, w dW_q d_a, the neighbour's value (or the
  //    cell's where there is none)
  if (s.live) {
    const int64_t row = static_cast<int64_t>(s.c) * rows.K + s.k;
    const int nb = __ldg(rows.nbr + row);
    const bool is_cell = nb >= 0;
    float d[3];
    for (int a = 0; a < 3; ++a) d[a] = __ldg(rows.nbr_rel + row * 3 + a);
    const float w = is_cell ? 1.0f / max_nan(dot3(d, d), 1e-30f) : 0.0f;
    for (int a = 0; a < 3; ++a) {
      const float wd = w * d[a];
      for (int b = 0; b < 3; ++b) term[a * 3 + b][t] = wd * d[b];
    }
    float wi[5], wj[5], gv[3];
    load_w(record, s.c, wi, gv);
    load_w(record, nb > 0 ? nb : 0, wj, gv);
    for (int q = 0; q < 5; ++q) {
      const float wdw = w * (is_cell ? wj[q] - wi[q] : 0.0f);
      for (int a = 0; a < 3; ++a) term[9 + q * 3 + a][t] = wdw * d[a];
      term[24 + q][t] = is_cell ? wj[q] : wi[q];
    }
  }
  __syncthreads();

  // 2. the row sums in face order, and the running max / min of the values
  row_sums<24>(rows, term, sum);
  for (int p = t; p < 5 * rows.R; p += kBlock) {
    const int q = p / rows.R;
    const int r = p - q * rows.R;
    const float* v = term[24 + q] + r * rows.K;
    float top = v[0], bottom = v[0];
    for (int k = 1; k < rows.K; ++k) {
      top = max_nan(top, v[k]);
      bottom = min_nan(bottom, v[k]);
    }
    wmax[q][r] = top;
    wmin[q][r] = bottom;
  }
  __syncthreads();

  // 3. a thread a cell and primitive: G with its Tikhonov floor, the solve,
  //    the limiter's bounds
  for (int p = t; p < 5 * rows.R; p += kBlock) {
    const int q = p / rows.R;
    const int r = p - q * rows.R;
    const int c = blockIdx.x * rows.R + r;
    if (c >= C) continue;
    float A[3][3];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) A[a][b] = sum[a * 3 + b][r];
    const float tr = A[0][0] + A[1][1] + A[2][2];
    const float floor = 1e-8f * max_nan(tr, 1e-30f);
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) A[a][b] = A[a][b] + floor * (a == b ? 1.0f : 0.0f);
    float x[3] = {sum[9 + q * 3][r], sum[9 + q * 3 + 1][r], sum[9 + q * 3 + 2][r]};
    lu_solve3(A, x);
    for (int a = 0; a < 3; ++a) g[q * 3 + a][r] = x[a];
    const float wi = record[static_cast<int64_t>(c) * kRecord + q];
    hi[q][r] = max_nan(wmax[q][r], wi) - wi;
    lo[q][r] = min_nan(wmin[q][r], wi) - wi;
  }
  __syncthreads();

  // 4. a slot's limiter ratio for each primitive (1 on padding)
  if (s.live) {
    const int64_t row = static_cast<int64_t>(s.c) * rows.K + s.k;
    const bool padding = __ldg(rows.nbr + row) < -1;
    float arm[3];
    for (int a = 0; a < 3; ++a) arm[a] = __ldg(rows.face_rel + row * 3 + a);
    for (int q = 0; q < 5; ++q) {
      const float gq[3] = {g[q * 3][s.r], g[q * 3 + 1][s.r], g[q * 3 + 2][s.r]};
      const float ext = dot3(arm, gq);
      const float h = hi[q][s.r], l = lo[q][s.r];
      float a_k = ext > kTinyW    ? h / max_nan(ext, kTinyW)
                  : ext < -kTinyW ? l / min_nan(ext, -kTinyW)
                                  : 1.0f;
      if (padding) a_k = 1.0f;
      term[q][t] = a_k;
    }
  }
  __syncthreads();

  // 5. a thread a cell and primitive: the least ratio in face order, the
  //    limited gradient
  for (int p = t; p < 5 * rows.R; p += kBlock) {
    const int q = p / rows.R;
    const int r = p - q * rows.R;
    const float* v = term[q] + r * rows.K;
    float amin = v[0];
    for (int k = 1; k < rows.K; ++k) amin = min_nan(amin, v[k]);
    const float alpha = kc.slope_factor * min_nan(max_nan(amin, 0.0f), 1.0f);
    for (int a = 0; a < 3; ++a) g[q * 3 + a][r] = g[q * 3 + a][r] * alpha;
  }
  __syncthreads();

  // 6. a thread a cell: the half-dt primitive prediction
  //    (predict_primitive_variables); the predictions and the gradients
  //    into the cell's record
  if (t < rows.R) {
    const int c = blockIdx.x * rows.R + t;
    if (c < C) {
      float wi[5], gv[3];
      load_w(record, c, wi, gv);
      float gc[5][3];
      for (int q = 0; q < 5; ++q)
        for (int a = 0; a < 3; ++a) gc[q][a] = g[q * 3 + a][t];
      const float rho = wi[0], vx = wi[1], vy = wi[2], vz = wi[3], p = wi[4];
      const float half = kc.half_dt;
      const float div_v = gc[1][0] + gc[2][1] + gc[3][2];
      const float inv_rho_c = 1.0f / max_nan(rho, 0.0f);
      float vd[5];
      for (int q = 0; q < 5; ++q) vd[q] = vx * gc[q][0] + vy * gc[q][1] + vz * gc[q][2];
      float rho_p = rho - half * (vd[0] + rho * div_v);
      const float vx_p = vx - half * (vd[1] + gc[4][0] * inv_rho_c);
      const float vy_p = vy - half * (vd[2] + gc[4][1] * inv_rho_c);
      const float vz_p = vz - half * (vd[3] + gc[4][2] * inv_rho_c);
      float p_p = p - half * (vd[4] + kc.gamma * p * div_v);
      // positivity: fall back to the unpredicted value (SAFE_HYDRO)
      rho_p = rho_p > 0.0f ? rho_p : rho;
      p_p = p_p > 0.0f ? p_p : p;
      const float v[20] = {rho_p, vx_p, vy_p, vz_p, p_p,
                           gc[0][0], gc[0][1], gc[0][2], gc[1][0], gc[1][1],
                           gc[1][2], gc[2][0], gc[2][1], gc[2][2], gc[3][0],
                           gc[3][1], gc[3][2], gc[4][0], gc[4][1], gc[4][2]};
      float4* out =
          reinterpret_cast<float4*>(record + static_cast<int64_t>(c) * kRecord) + 2;
      for (int i = 0; i < 5; ++i) {
        out[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      }
    }
  }
}

// a slot's five products flux * A/V * active * dt, first or second order
__device__ __forceinline__ void face_products(const Rows& rows, const Slot& s, int nb,
                                              bool first_order, const Consts& kc,
                                              const float* __restrict__ record, float x[5]) {
  float wi[5], wj[5], gi[3], gj[3];
  load_w(record, s.c, wi, gi);
  load_w(record, nb > 0 ? nb : 0, wj, gj);
  Face f;
  load_face(rows, s.c, s.k, nb, gi, gj, kc, f);
  float fl[5];
  if (first_order) {
    first_order_flux(f, wi, wj, kc, fl);
  } else {
    second_order_flux(rows, f, s.c, s.k, wi, wj, record, kc, fl);
  }
  for (int q = 0; q < 5; ++q) x[q] = fl[q] * f.wA;
}

__global__ void __launch_bounds__(kBlock) trial_kernel(
    State5 u, Rows rows, Consts kc, const float* __restrict__ record,
    uint8_t* __restrict__ flag, int* __restrict__ flagged, float* __restrict__ out) {
  __shared__ float product[5][kBlock];
  __shared__ float sum[5][kMaxRows];
  const Slot s = slot_of(rows);
  const int C = rows.C;
  if (s.live) {
    const int nb = __ldg(rows.nbr + static_cast<int64_t>(s.c) * rows.K + s.k);
    float x[5];
    face_products(rows, s, nb, false, kc, record, x);
    for (int q = 0; q < 5; ++q) product[q][threadIdx.x] = x[q];
  }
  __syncthreads();
  row_sums<5>(rows, product, sum);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < rows.R) {
    const int c = blockIdx.x * rows.R + t;
    if (c < C) {
      const float rho0 = u.f[0][c], e0 = u.f[4][c];
      const float rho2 = rho0 + -sum[0][t];
      const float e2 = e0 + -sum[4][t];
      const bool bad = rho2 < 0.25f * rho0 || e2 < 0.25f * e0 || !isfinite(rho2) ||
                       !isfinite(e2);
      flag[c] = bad ? 1 : 0;
      if (bad) atomicAdd(flagged, 1);
      for (int q = 0; q < 5; ++q) out[static_cast<int64_t>(q) * C + c] = u.f[q][c] + -sum[q][t];
    }
  }
}

__global__ void __launch_bounds__(kBlock) update_kernel(
    State5 u, Rows rows, Consts kc, const float* __restrict__ record,
    const uint8_t* __restrict__ flag, const int* __restrict__ flagged, int second_order,
    float* __restrict__ out) {
  __shared__ float product[5][kBlock];
  __shared__ float sum[5][kMaxRows];
  __shared__ int redo[kMaxRows];  // the row has a first-order face
  // no cell flagged: every row keeps the trial's state (the whole block leaves)
  if (second_order && __ldcg(flagged) == 0) return;
  const Slot s = slot_of(rows);
  const int C = rows.C;
  const int t = threadIdx.x;
  if (t < rows.R) redo[t] = second_order ? 0 : 1;
  __syncthreads();
  int nb = 0;
  bool first_order = !second_order;
  if (s.live) {
    nb = __ldg(rows.nbr + static_cast<int64_t>(s.c) * rows.K + s.k);
    if (second_order) {
      first_order = flag[s.c] != 0 || (nb >= 0 && flag[nb > 0 ? nb : 0] != 0);
      if (first_order) redo[s.r] = 1;
    }
  }
  __syncthreads();
  if (s.live && redo[s.r]) {
    float x[5];
    face_products(rows, s, nb, first_order, kc, record, x);
    for (int q = 0; q < 5; ++q) product[q][t] = x[q];
  }
  __syncthreads();
  row_sums<5>(rows, product, sum);
  __syncthreads();
  if (t < rows.R) {
    const int c = blockIdx.x * rows.R + t;
    if (c < C && redo[t]) {
      for (int q = 0; q < 5; ++q) out[static_cast<int64_t>(q) * C + c] = u.f[q][c] + -sum[q][t];
    }
  }
}

}  // namespace

// Launches K7 on `stream`; returns the first cudaGetLastError() that is not
// 0, else 0.  u_*: the 5 conserved fields of C floats; out: [5, C] floats;
// nbr/aov [C*K]; normals, face_rel, nbr_rel [C*K*3]; gen_vel [C*3]; scratch:
// record [32 * C] floats, 128-byte aligned (W and the grid velocity always;
// the predictions and gradients with second order), flag [C] bytes and
// flagged, one int (both written, and read, with second order only).  K <=
// 256.  The 6 f32 constants in Consts order: gamma, gamma - 1, (gamma +
// 1)/(2 gamma), dt, dt/2, slope factor.
extern "C" int cmi_voronoi_flux(
    const float* u_rho, const float* u_mx, const float* u_my, const float* u_mz,
    const float* u_e, float* out, const int* nbr, const float* normals, const float* aov,
    const float* face_rel, const float* nbr_rel, const float* gen_vel, float* record,
    uint8_t* flag, int* flagged, int C, int K, int second_order, float gamma, float gm1,
    float cq, float dt, float half_dt, float slope_factor, void* stream) {
  if (C < 0 || K < 0 || K > kBlock) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || K == 0) return static_cast<int>(cudaGetLastError());
  const Consts kc = {gamma, gm1, cq, dt, half_dt, slope_factor};
  const State5 u = {{u_rho, u_mx, u_my, u_mz, u_e}};
  int R = kBlock / K;
  R = R < kMaxRows ? R : kMaxRows;
  const Rows rows = {nbr, normals, aov, face_rel, nbr_rel, gen_vel, C, K, R};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (C + R - 1) / R;
  primitives_kernel<<<(C + kCellThreads - 1) / kCellThreads, kCellThreads, 0, s>>>(
      u, gen_vel, C, kc, record, flagged);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (second_order) {
    gradients_kernel<<<row_blocks, kBlock, 0, s>>>(rows, kc, record);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    trial_kernel<<<row_blocks, kBlock, 0, s>>>(u, rows, kc, record, flag, flagged, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  update_kernel<<<row_blocks, kBlock, 0, s>>>(u, rows, kc, record, flag, flagged,
                                               second_order, out);
  return static_cast<int>(cudaGetLastError());
}

// The registers a thread takes and the blocks of 256 resident on one SM of
// the current device of K7's gradient (which 0), trial (1) and update (2)
// kernels, and that device's SM count; returns the CUDA error (0 on success).
extern "C" int cmi_voronoi_gradients_occupancy(int* registers, int* blocks_per_sm, int* sms) {
  return cmi_occupancy::query(gradients_kernel, kBlock, registers, blocks_per_sm, sms);
}

extern "C" int cmi_voronoi_trial_occupancy(int* registers, int* blocks_per_sm, int* sms) {
  return cmi_occupancy::query(trial_kernel, kBlock, registers, blocks_per_sm, sms);
}

extern "C" int cmi_voronoi_update_occupancy(int* registers, int* blocks_per_sm, int* sms) {
  return cmi_occupancy::query(update_kernel, kBlock, registers, blocks_per_sm, sms);
}
