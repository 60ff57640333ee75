// The peel-off march and the CCD projection, shared by K8 (peel_off.cu) and
// K8p (peel_off_polarized.cu).
//
// Replaces the first two parts of the JAX dust driver's peel-off
// (cmacionize_tpu/models/dust_simulation.py): _peel_off_tau (:243), a full
// K1 march of every event toward the observer with a target tau of 1e4,
// zero weight and a tally that nothing reads, and _ccd_pixel (:268).  The
// plain PyTorch versions are peel_off_tau_reference and ccd_pixel_reference
// in cmacionize_torch/ops/peel_off.py.
//
// The march takes K1's steps (cartesian_march.cuh: the same wall distances,
// the clamp at 0, the crossed axis the first of x, y, z whose distance
// equals l_exit, the snap onto the wall, the periodic wrap) without the
// deposit, under K1's step cap, with tau_left starting at 1e4 and decreased
// by tau_cell at every step, so tau = 1e4 - tau_left matches the plain
// version (and the JAX march) bit for bit; it resolves only to ulp(1e4).
// Two things make its chain shorter than K1's step (redesigned; the first
// port ran cart::step itself, ~915 cycles a step for a lone event):
//   * every event marches along the one observer direction, so the three
//     divisors of the wall distances are the same for the whole launch:
//     each thread forms r = RN(1 / s) once and takes a quotient as
//     q0 = a r, e = fma(-s, q0, a), q = fma(e, r, q0), which Markstein's
//     theorem makes RN(a / s), IEEE division bit for bit, for a = 0 and
//     2^-64 <= |a| <= 2 (tests/test_torch_division_identity.py; a march
//     inside the grid has |a| <= 1).  A batch of steps takes that form
//     without a branch, and a batch in which a numerator fell outside its
//     range (or was 0, which only a position on a wall it marches toward
//     gives) is walked again with __fdiv_rn;
//   * the cells of a march do not depend on chi: only the absorption test
//     does, and it ends the march.  So the geometry of kAhead steps is
//     formed first (the snap and the crossing by selects), then their kAhead
//     chi are read at once, then tau is taken step by step in order; the
//     gathers of a batch overlap instead of each waiting for the step before
//     it.  An absorption needs no position (the peel-off reads only tau), so
//     no step divides by chi.
// The projection is the JAX driver's f32 arithmetic in production (x64
// off): the SI position with one rounding per operation, the dot products
// with e1 and e2 as fma(z, e_z, fma(y, e_y, x * e_x)) (XLA's dot), then
// ((u - anchor) / side) * pixels, truncated toward zero and clipped into
// the edge pixels.  Built with --fmad=false, nothing else is contracted.

#pragma once

#include "cartesian_march.cuh"

namespace peel {

constexpr float kTauTarget = 1.0e4f;
constexpr int kAhead = 4;  // steps whose cells are formed before their chi are read
// the numerators whose quotient by a direction component in [1e-12, 1] the
// reciprocal form rounds as the IEEE division does: 0 and this range
constexpr float kLeastNumerator = 0x1p-64f;
constexpr float kGreatestNumerator = 2.0f;
// their bits: |a| lies in the range where bits(|a|) - kLeastBits <= kNumeratorSpan
constexpr unsigned kLeastBits = 0x1f800000u;
constexpr unsigned kNumeratorSpan = 0x40000000u - kLeastBits;

// The host-side layout of the view arrays handed to the launchers (the
// order of ops/peel_off.py:PeelOffView's floats and ints).
constexpr int kViewFloats = 22;
constexpr int kViewInts = 7;

struct View {
  float march[3];  // the observer direction as the march takes it
  float phase[3];  // the observer direction of the phase / polarized peel-off
  float anchor[3], cell[3];  // box anchor and cell size (m)
  float e1[3], e2[3];        // image-plane axes
  float ccd_anchor[2], ccd_sides[2];
  int nx, ny, nz, periodic_mask, max_steps, npx, npy;
};

inline View make_view(const float* f, const int* i) {
  View v;
  for (int k = 0; k < 3; ++k) {
    v.march[k] = f[k];
    v.phase[k] = f[3 + k];
    v.anchor[k] = f[6 + k];
    v.cell[k] = f[9 + k];
    v.e1[k] = f[12 + k];
    v.e2[k] = f[15 + k];
  }
  v.ccd_anchor[0] = f[18];
  v.ccd_anchor[1] = f[19];
  v.ccd_sides[0] = f[20];
  v.ccd_sides[1] = f[21];
  v.nx = i[0];
  v.ny = i[1];
  v.nz = i[2];
  v.periodic_mask = i[3];
  v.max_steps = i[4];
  v.npx = i[5];
  v.npy = i[6];
  return v;
}

__device__ __forceinline__ int start_cell(float p, int n) {
  return min(max(static_cast<int>(floorf(p)), 0), n - 1);
}

// One axis of the march direction: the component s, r = RN(1 / s), whether
// the axis moves (|s| > 1e-12; else its wall is never crossed), the wall of
// cell c (c + up) and the step of a crossing.
struct Axis {
  float s, r;
  bool moves;
  int up, step;

  // cart::wall_distance(pos, cell, s) with the quotient taken by r: bit for
  // bit where |numerator| lies within [2^-64, 2] (one unsigned comparison of
  // its bits), else held is cleared; a zero numerator, exact in this form
  // too but rare in a march, clears it as well
  __device__ __forceinline__ float fast_distance(float pos, int cell, bool& held) const {
    const float a = static_cast<float>(cell + up) - pos;
    held &= !moves || (__float_as_uint(a) & 0x7fffffffu) - kLeastBits <= kNumeratorSpan;
    const float q0 = a * r;
    const float q = __fmaf_rn(__fmaf_rn(-s, q0, a), r, q0);
    return moves ? fmaxf(q, 0.0f) : __int_as_float(0x7f800000);  // +inf
  }

  // cart::wall_distance(pos, cell, s) by IEEE division
  __device__ __forceinline__ float exact_distance(float pos, int cell) const {
    if (!moves) return __int_as_float(0x7f800000);
    return fmaxf(__fdiv_rn(static_cast<float>(cell + up) - pos, s), 0.0f);
  }
};

__device__ __forceinline__ Axis make_axis(float s) {
  const int up = s > 0.0f ? 1 : 0;
  return Axis{s, __frcp_rn(s), fabsf(s) > cart::kEpsDir, up, up ? 1 : -1};
}

// A march's position (cell units), cell, and whether it has a step to take
// (inside the grid, under the step cap).
struct Walker {
  float px, py, pz;
  int cx, cy, cz;
  bool alive;
};

// One step of cart::step's geometry on w, where w.alive: the step's cell
// (its flat index, 0 where w is not alive) and length, then the advance, the
// snap onto the crossed wall and the periodic wraps, with selects in place
// of branches.  kExact takes the wall distances by IEEE division, else by
// the reciprocals, clearing held where a numerator is out of their range.
template <bool kExact>
__device__ __forceinline__ void walk(Walker& w, const Axis& ax, const Axis& ay, const Axis& az,
                                     const cart::Grid& g, bool below_cap, int& flat,
                                     float& length, bool& held) {
  const bool valid = w.alive && below_cap;
  bool in_range = true;
  const float tx = kExact ? ax.exact_distance(w.px, w.cx) : ax.fast_distance(w.px, w.cx, in_range);
  const float ty = kExact ? ay.exact_distance(w.py, w.cy) : ay.fast_distance(w.py, w.cy, in_range);
  const float tz = kExact ? az.exact_distance(w.pz, w.cz) : az.fast_distance(w.pz, w.cz, in_range);
  held &= in_range || !valid;
  const float l = fminf(tx, fminf(ty, tz));
  flat = valid ? (w.cx * g.ny + w.cy) * g.nz + w.cz : 0;
  length = l;
  const bool cross_x = l == tx, cross_y = !cross_x && l == ty, cross_z = !cross_x && !cross_y;
  w.px = cross_x ? static_cast<float>(w.cx + ax.up) : __fmaf_rn(ax.s, l, w.px);
  w.py = cross_y ? static_cast<float>(w.cy + ay.up) : __fmaf_rn(ay.s, l, w.py);
  w.pz = cross_z ? static_cast<float>(w.cz + az.up) : __fmaf_rn(az.s, l, w.pz);
  w.cx += cross_x ? ax.step : 0;
  w.cy += cross_y ? ay.step : 0;
  w.cz += cross_z ? az.step : 0;
  if (g.per_x) cart::wrap(w.px, w.cx, g.nx);
  if (g.per_y) cart::wrap(w.py, w.cy, g.ny);
  if (g.per_z) cart::wrap(w.pz, w.cz, g.nz);
  w.alive = valid && w.cx >= 0 && w.cx < g.nx && w.cy >= 0 && w.cy < g.ny && w.cz >= 0 &&
            w.cz < g.nz;
}

// Optical depth from (px, py, pz) (cell units) to the box edge along the
// march direction: cart::step's march, kAhead steps a batch.  A batch whose
// numerators left the reciprocals' range is walked again from its start with
// IEEE divisions.
__device__ __forceinline__ float march_tau(const float* __restrict__ chi, float px,
                                           float py, float pz, const View& v) {
  const Axis ax = make_axis(v.march[0]), ay = make_axis(v.march[1]), az = make_axis(v.march[2]);
  const cart::Grid g = cart::make_grid(v.nx, v.ny, v.nz, v.periodic_mask);
  // start_cell keeps the cell inside the grid
  Walker w{px, py, pz, start_cell(px, v.nx), start_cell(py, v.ny), start_cell(pz, v.nz), true};
  float tau_left = kTauTarget;
  for (int step = 0; w.alive && step < v.max_steps; step += kAhead) {
    const Walker start = w;
    int flat[kAhead];
    float length[kAhead];
    int count = 0;
    bool held = true;
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      count += w.alive && step + k < v.max_steps;
      walk<false>(w, ax, ay, az, g, step + k < v.max_steps, flat[k], length[k], held);
    }
    if (!held) {
      w = start;
      count = 0;
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        count += w.alive && step + k < v.max_steps;
        walk<true>(w, ax, ay, az, g, step + k < v.max_steps, flat[k], length[k], held);
      }
    }
    float opacity[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) opacity[k] = __ldg(chi + flat[k]);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (k < count) {
        const float tau_cell = fmaxf(opacity[k], cart::kChiFloor) * length[k];
        if (tau_cell >= tau_left) return kTauTarget;  // absorbed: tau_left = 0
        tau_left = tau_left - tau_cell;
      }
    }
  }
  return kTauTarget - tau_left;
}

__device__ __forceinline__ int pixel_index(float u, float anchor, float side, int n) {
  const int p = static_cast<int>((u - anchor) / side * static_cast<float>(n));
  return min(max(p, 0), n - 1);
}

// Flat CCD pixel (px * npy + py) of (gx, gy, gz) (cell units).
__device__ __forceinline__ int ccd_pixel(float gx, float gy, float gz, const View& v) {
  const float sx = v.anchor[0] + gx * v.cell[0];
  const float sy = v.anchor[1] + gy * v.cell[1];
  const float sz = v.anchor[2] + gz * v.cell[2];
  const float u = __fmaf_rn(sz, v.e1[2], __fmaf_rn(sy, v.e1[1], sx * v.e1[0]));
  const float w = __fmaf_rn(sz, v.e2[2], __fmaf_rn(sy, v.e2[1], sx * v.e2[0]));
  return pixel_index(u, v.ccd_anchor[0], v.ccd_sides[0], v.npx) * v.npy +
         pixel_index(w, v.ccd_anchor[1], v.ccd_sides[1], v.npy);
}

}  // namespace peel
