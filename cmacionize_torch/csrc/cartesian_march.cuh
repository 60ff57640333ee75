// One step of the Cartesian cell march, shared by K1 (trace_packets.cu), K2
// (trace_packets_spectral.cu) and the peel-off march of K8/K8p
// (peel_march.cuh), so that the three stay step for step the same as the
// plain version, cmacionize_torch/ops/traversal.py:trace_packets_reference.
//
// Semantics, step for step as in the JAX march (cmacionize_tpu/ops/
// traversal.py:trace_packets):
//   * wall distance per axis with a degenerate-direction guard (|d| <= 1e-12
//     never crosses its wall: +inf), clamped at 0;
//   * chi floored at 1e-30; absorption when chi * l_exit >= tau_left, the
//     packet then travels tau_left / chi and stops inside the cell;
//   * the crossed axis is the first of x, y, z whose wall distance equals
//     l_exit exactly, and that coordinate is snapped onto the wall;
//   * periodic axes wrap position and cell; a cell outside the grid escapes.
// Built with --fmad=false and without fast math, the compiler contracts
// nothing, so each step is the same sequence of IEEE f32 operations (mul,
// sub, div.rn, min, max) as the plain version's separate elementwise ops.
// The one fused multiply-add is explicit: the advance p + d*l is __fmaf_rn,
// because XLA on the CPU fuses the JAX march's advance that way.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cart {

constexpr float kEpsDir = 1e-12f;  // _EPS_DIR of the JAX march
constexpr float kChiFloor = 1e-30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float wall_distance(float pos, int cell, float dirn) {
  if (!(fabsf(dirn) > kEpsDir)) return __int_as_float(0x7f800000);  // +inf
  const float wall = static_cast<float>(cell + (dirn > 0.0f ? 1 : 0));
  return fmaxf((wall - pos) / dirn, 0.0f);
}

// Periodic wrap of one axis: a step leaves the range by at most one cell.
__device__ __forceinline__ void wrap(float& p, int& c, int n) {
  if (c < 0) {
    p = p + static_cast<float>(n);
    c += n;
  } else if (c >= n) {
    p = p - static_cast<float>(n);
    c -= n;
  }
}

struct Grid {
  int nx, ny, nz;
  bool per_x, per_y, per_z;
};

__device__ __forceinline__ Grid make_grid(int nx, int ny, int nz, int periodic_mask) {
  return Grid{nx, ny, nz, (periodic_mask & 1) != 0, (periodic_mask & 2) != 0,
              (periodic_mask & 4) != 0};
}

// A packet: position (cell units), cell, direction and the optical depth
// left to its interaction.
struct Ray {
  float px, py, pz;
  int cx, cy, cz;
  float dx, dy, dz;
  float tau_left;
};

__device__ __forceinline__ bool inside(const Ray& r, const Grid& g) {
  return r.cx >= 0 && r.cx < g.nx && r.cy >= 0 && r.cy < g.ny && r.cz >= 0 && r.cz < g.nz;
}

// One step from the ray's cell, which must lie inside the grid.
// opacity(flat) gives the cell's chi before the floor; deposit(flat, l) is
// called once with the path length through the cell.  Returns true when the
// ray stops in the cell (tau_left is then 0); otherwise the ray has crossed
// into the next cell (wrapped on periodic axes), which may lie outside.
template <class Opacity, class Deposit>
__device__ __forceinline__ bool step(Ray& r, const Grid& g, Opacity opacity, Deposit deposit) {
  const float tx = wall_distance(r.px, r.cx, r.dx);
  const float ty = wall_distance(r.py, r.cy, r.dy);
  const float tz = wall_distance(r.pz, r.cz, r.dz);
  const float l_exit = fminf(tx, fminf(ty, tz));

  const int flat = (r.cx * g.ny + r.cy) * g.nz + r.cz;
  const float chi = fmaxf(opacity(flat), kChiFloor);
  const float tau_cell = chi * l_exit;
  if (tau_cell >= r.tau_left) {  // absorbed inside the cell
    const float l_travel = r.tau_left / chi;
    deposit(flat, l_travel);
    r.px = __fmaf_rn(r.dx, l_travel, r.px);
    r.py = __fmaf_rn(r.dy, l_travel, r.py);
    r.pz = __fmaf_rn(r.dz, l_travel, r.pz);
    r.tau_left = 0.0f;
    return true;
  }
  deposit(flat, l_exit);
  r.px = __fmaf_rn(r.dx, l_exit, r.px);
  r.py = __fmaf_rn(r.dy, l_exit, r.py);
  r.pz = __fmaf_rn(r.dz, l_exit, r.pz);
  // snap the crossed coordinate onto the wall (x, then y, then z on ties)
  if (l_exit == tx) {
    r.px = static_cast<float>(r.dx > 0.0f ? r.cx + 1 : r.cx);
    r.cx += r.dx > 0.0f ? 1 : -1;
  } else if (l_exit == ty) {
    r.py = static_cast<float>(r.dy > 0.0f ? r.cy + 1 : r.cy);
    r.cy += r.dy > 0.0f ? 1 : -1;
  } else {
    r.pz = static_cast<float>(r.dz > 0.0f ? r.cz + 1 : r.cz);
    r.cz += r.dz > 0.0f ? 1 : -1;
  }
  if (g.per_x) wrap(r.px, r.cx, g.nx);
  if (g.per_y) wrap(r.py, r.cy, g.ny);
  if (g.per_z) wrap(r.pz, r.cz, g.nz);
  r.tau_left = r.tau_left - tau_cell;
  return false;
}

}  // namespace cart
