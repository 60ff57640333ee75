// The face-plane step shared by K6 (trace_voronoi.cu) and K6s
// (trace_voronoi_spectral.cu): the exit face of a packet's cell and the
// move across it, as cmacionize_tpu/models/voronoi.py:_trace_voronoi_jit
// computes them.
//
// Precision (both kernels are built with --fmad=false, no fast math): where
// XLA on the CPU fuses the JAX march, these helpers round once with an
// explicit FMA, and only there.  A bit-parity test of the plain version
// against JAX-on-CPU (open and periodic grids) chose the forms:
//   * n.d and n.p of einsum("pkc,pc->pk"): the first product rounded, then
//     the second and third terms each added with one FMA, in axis order;
//   * the advance pos + d * travel: one FMA per axis, then the shift added.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cmi_voronoi {

constexpr float kEpsDir = 1e-12f;   // _EPS_DIR: faces with n.d <= it are never hit
constexpr float kChiFloor = 1e-30f;
constexpr int kThreads = 256;

// jnp.maximum / torch.clamp_min: NaN in either operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float dot3(float nx, float ny, float nz, float x,
                                      float y, float z) {
  return __fmaf_rn(nz, z, __fmaf_rn(ny, y, nx * x));
}

// The exit face of `row` from its packed faces (normal and offset as one
// float4, VoronoiTables.faces): the first face of least distance t_k among
// the row's first `count` faces (a strict <, as jnp.argmin and torch.min
// pick; a NaN distance wins, as there), with
//   t_k = max(off - n.p, 0) / max(n.d, 1e-12)  where n.d > 1e-12,
//   t_k = +inf                                   elsewhere.
// A face with a zero normal (padding) gets n.d = 0 and t = +inf, as the plain
// march's -2 test gives, so the same face and distance bits; a row where
// every t_k is +inf gives face 0 at +inf.
__device__ __forceinline__ int exit_face_packed(const float4* __restrict__ faces,
                                                int count, int64_t row, int K,
                                                float px, float py, float pz,
                                                float dx, float dy, float dz,
                                                float* t_exit) {
  const float inf = __int_as_float(0x7f800000);
  float best = inf;
  int best_k = 0;
  const float4* f = faces + row * K;
  for (int k = 0; k < count; ++k) {
    const float4 face = __ldg(f + k);
    const float ndotd = dot3(face.x, face.y, face.z, dx, dy, dz);
    const float ndotp = dot3(face.x, face.y, face.z, px, py, pz);
    float t = inf;
    if (ndotd > kEpsDir) {
      t = max_nan(face.w - ndotp, 0.0f) / max_nan(ndotd, kEpsDir);
    }
    if (t < best || (t != t && best == best)) {
      best = t;
      best_k = k;
    }
  }
  *t_exit = best;
  return best_k;
}

// One step of the march for a packet that is still active, given its
// opacity chi (floored here) in the current cell: returns the path length
// to deposit and updates position, cell, tau_left and the flags.
__device__ __forceinline__ float step(const int* __restrict__ nbr,
                                      const float* __restrict__ shifts,
                                      int64_t row, int K, int k_exit,
                                      float t_exit, float chi, float eps,
                                      float& px, float& py, float& pz,
                                      float dx, float dy, float dz, int& cell,
                                      float& tau_left, bool& active,
                                      bool& absorbed) {
  const float chi_c = max_nan(chi, kChiFloor);
  const float tau_cell = chi_c * t_exit;
  const bool absorbed_now = tau_cell >= tau_left;
  const float l_travel = absorbed_now ? tau_left / chi_c : t_exit;
  if (absorbed_now) {
    px = __fmaf_rn(dx, l_travel, px);
    py = __fmaf_rn(dy, l_travel, py);
    pz = __fmaf_rn(dz, l_travel, pz);
    tau_left = 0.0f;
    absorbed = true;
    active = false;
    return l_travel;
  }
  // nudge past the face so the next plane test is strictly inside, then
  // take the face's periodic shift
  const float travel = l_travel + eps;
  const float* s = shifts + (row * K + k_exit) * 3;
  px = __fmaf_rn(dx, travel, px) + __ldg(s);
  py = __fmaf_rn(dy, travel, py) + __ldg(s + 1);
  pz = __fmaf_rn(dz, travel, pz) + __ldg(s + 2);
  const int next = __ldg(nbr + row * K + k_exit);
  if (next >= 0) cell = next;
  if (next == -1) active = false;  // escaped through a wall
  tau_left = tau_left - tau_cell;
  return l_travel;
}

}  // namespace cmi_voronoi
