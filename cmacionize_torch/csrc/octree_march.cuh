// The octree descent and the march step shared by K5 (trace_octree.cu),
// K5s (trace_octree_spectral.cu) and K5d (cmi_leaf_of_positions in
// trace_octree.cu), as cmacionize_tpu/ops/amr_traversal.py computes them.
//
// The hierarchy is two int32 tables: root[(ix*ny + iy)*nz + iz] over the
// coarse lattice and children[node*8 + octant], octant = ox*4 + oy*2 + oz;
// a value >= 0 is an internal node (a row of children), a value < 0 the leaf
// -(value + 1).  Positions are in coarse cell units.
//
// Precision (the kernels are built with --fmad=false, no fast math): where
// XLA on the CPU fuses the JAX march, these helpers round once with an
// explicit FMA, and only there: the advance p + d*l.  The nudged point
// p + eps*d of the descent and of the inside test is NOT fused by XLA (a
// targeted test against JAX-on-CPU, with inputs on which the two roundings
// pick different leaves, found the product rounded first), so it is a
// product and a sum here.  Everything else is one IEEE f32 operation per JAX
// operation, in its order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cmi_octree {

constexpr float kEpsDir = 1e-12f;   // _EPS_DIR: |d| <= it never crosses
constexpr float kChiFloor = 1e-30f;
constexpr int kThreads = 256;

// jnp.maximum / torch.clamp_min: NaN in either operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// jnp.clip(floor(p).astype(int32), 0, n - 1)
__device__ __forceinline__ int coarse_index(float p, int n) {
  const int i = static_cast<int>(floorf(p));
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

struct Leaf {
  int id;
  float lo_x, lo_y, lo_z, size;  // the leaf's box, coarse cell units
};

// The leaf holding (px, py, pz) and its box: at most max_level gathers from
// children after the one from root, through the read-only path.
__device__ __forceinline__ Leaf descend(const int* __restrict__ root,
                                        const int* __restrict__ children,
                                        float px, float py, float pz, int nx,
                                        int ny, int nz, int max_level) {
  const int ix = coarse_index(px, nx), iy = coarse_index(py, ny),
            iz = coarse_index(pz, nz);
  int node = __ldg(root + (ix * ny + iy) * nz + iz);
  Leaf b{0, static_cast<float>(ix), static_cast<float>(iy),
         static_cast<float>(iz), 1.0f};
  for (int level = 0; level < max_level && node >= 0; ++level) {
    const float half = 0.5f * b.size;
    const bool ox = px >= b.lo_x + half;
    const bool oy = py >= b.lo_y + half;
    const bool oz = pz >= b.lo_z + half;
    const int octant = (ox ? 4 : 0) + (oy ? 2 : 0) + (oz ? 1 : 0);
    node = __ldg(children + static_cast<int64_t>(node) * 8 + octant);
    if (ox) b.lo_x = b.lo_x + half;
    if (oy) b.lo_y = b.lo_y + half;
    if (oz) b.lo_z = b.lo_z + half;
    b.size = half;
  }
  b.id = -node - 1;
  return b;
}

// Distance along dirn to the leaf's wall on one axis, clamped at 0; +inf
// for a degenerate direction component.
__device__ __forceinline__ float wall_distance(float pos, float lo, float size,
                                               float dirn) {
  if (!(fabsf(dirn) > kEpsDir)) return __int_as_float(0x7f800000);
  const float wall = dirn > 0.0f ? lo + size : lo;
  return max_nan((wall - pos) / dirn, 0.0f);
}

// The leaf of the packet's nudged point: robust on the wall it sits on.
__device__ __forceinline__ Leaf current_leaf(const int* __restrict__ root,
                                             const int* __restrict__ children,
                                             float px, float py, float pz,
                                             float dx, float dy, float dz,
                                             float eps, int nx, int ny, int nz,
                                             int max_level) {
  return descend(root, children, px + eps * dx, py + eps * dy, pz + eps * dz,
                 nx, ny, nz, max_level);
}

// The exit distance of the packet from leaf b.
__device__ __forceinline__ float exit_distance(const Leaf& b, float px,
                                               float py, float pz, float dx,
                                               float dy, float dz, float* tx,
                                               float* ty) {
  *tx = wall_distance(px, b.lo_x, b.size, dx);
  *ty = wall_distance(py, b.lo_y, b.size, dy);
  const float tz = wall_distance(pz, b.lo_z, b.size, dz);
  return fminf(*tx, fminf(*ty, tz));
}

// One step of an active packet in leaf b, given its opacity chi there
// (floored here): returns the path length to deposit and updates position,
// tau_left and the flags.  An absorbed packet stops inside the leaf; a
// crossing one lands on the crossed wall (x, then y, then z on ties) and
// stays active while its nudged point is inside the box.
__device__ __forceinline__ float step(const Leaf& b, float l_exit, float tx,
                                      float ty, float chi, float eps, int nx,
                                      int ny, int nz, float& px, float& py,
                                      float& pz, float dx, float dy, float dz,
                                      float& tau_left, bool& active,
                                      bool& absorbed) {
  const float chi_c = max_nan(chi, kChiFloor);
  const float tau_cell = chi_c * l_exit;
  const bool absorbed_now = tau_cell >= tau_left;
  const float l_travel = absorbed_now ? tau_left / chi_c : l_exit;
  px = __fmaf_rn(dx, l_travel, px);
  py = __fmaf_rn(dy, l_travel, py);
  pz = __fmaf_rn(dz, l_travel, pz);
  if (absorbed_now) {
    tau_left = 0.0f;
    absorbed = true;
    active = false;
    return l_travel;
  }
  if (l_exit == tx) {
    px = dx > 0.0f ? b.lo_x + b.size : b.lo_x;
  } else if (l_exit == ty) {
    py = dy > 0.0f ? b.lo_y + b.size : b.lo_y;
  } else {
    pz = dz > 0.0f ? b.lo_z + b.size : b.lo_z;
  }
  const float qx = px + eps * dx, qy = py + eps * dy, qz = pz + eps * dz;
  active = qx >= 0.0f && qx < static_cast<float>(nx) && qy >= 0.0f &&
           qy < static_cast<float>(ny) && qz >= 0.0f &&
           qz < static_cast<float>(nz);
  tau_left = tau_left - tau_cell;
  return l_travel;
}

}  // namespace cmi_octree
