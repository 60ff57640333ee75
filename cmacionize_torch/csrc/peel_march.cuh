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
// The march is K1's step (cartesian_march.cuh) without its deposit, under
// K1's step cap, with tau_left starting at 1e4 and decreased by tau_cell at
// every step, so tau = 1e4 - tau_left matches the plain
// version (and the JAX march) bit for bit; it resolves only to ulp(1e4).
// The projection is the JAX driver's f32 arithmetic in production (x64
// off): the SI position with one rounding per operation, the dot products
// with e1 and e2 as fma(z, e_z, fma(y, e_y, x * e_x)) (XLA's dot), then
// ((u - anchor) / side) * pixels, truncated toward zero and clipped into
// the edge pixels.  Built with --fmad=false, nothing else is contracted.

#pragma once

#include "cartesian_march.cuh"

namespace peel {

constexpr float kTauTarget = 1.0e4f;

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

// Optical depth from (px, py, pz) (cell units) to the box edge along the
// march direction.
__device__ __forceinline__ float march_tau(const float* __restrict__ chi, float px,
                                           float py, float pz, const View& v) {
  cart::Ray r{px, py, pz, start_cell(px, v.nx), start_cell(py, v.ny), start_cell(pz, v.nz),
              v.march[0], v.march[1], v.march[2], kTauTarget};
  const cart::Grid g = cart::make_grid(v.nx, v.ny, v.nz, v.periodic_mask);
  const auto opacity = [&](int flat) { return __ldg(chi + flat); };
  const auto no_tally = [](int, float) {};
  bool active = true;  // start_cell keeps the cell inside the grid
  for (int step = 0; active && step < v.max_steps; ++step) {
    if (cart::step(r, g, opacity, no_tally)) break;  // never at a target of 1e4
    active = cart::inside(r, g);
  }
  return kTauTarget - r.tau_left;
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
