// The HLLC Riemann solver on the device, shared by K3 (hydro_step.cu) and
// K7 (voronoi_flux.cu).
//
// Repeats cmacionize_torch/ops/riemann.py:hllc_flux (the JAX package's
// ops/riemann.py:hllc_flux) operation for operation under --fmad=false:
// _physical_flux's and star_flux's expression order, the vacuum and
// degenerate-denominator guards, and the pick whose later tests override the
// earlier ones.  The constants arrive in the caller's struct `c` as f32
// values formed in double and rounded once, as JAX's weakly typed Python
// scalars are: c.gamma, c.gm1 = gamma - 1, c.cq = (gamma + 1) / (2 gamma).
//
// Outputs are in the face frame: mass, normal momentum, two tangential
// momenta, energy.
#pragma once

#include <cuda_runtime.h>

namespace cmi {

// jnp.maximum / jnp.minimum: NaN in either operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

template <class Consts>
__device__ __forceinline__ float energy_density(float rho, float u, float v,
                                                float w, float p,
                                                const Consts& c) {
  return p / c.gm1 + 0.5f * rho * (u * u + v * v + w * w);
}

template <class Consts>
__device__ __forceinline__ void physical_flux(float rho, float u, float v,
                                              float w, float p,
                                              const Consts& c, float f[5]) {
  const float e = energy_density(rho, u, v, w, p, c);
  f[0] = rho * u;
  f[1] = rho * u * u + p;
  f[2] = rho * u * v;
  f[3] = rho * u * w;
  f[4] = (e + p) * u;
}

template <class Consts>
__device__ __forceinline__ float q_factor(float p_star, float p,
                                          const Consts& c) {
  const float sp = p > 1e-30f ? p : 1.0f;
  const float ratio = p_star / sp;
  return ratio > 1.0f ? sqrtf(1.0f + c.cq * (ratio - 1.0f)) : 1.0f;
}

// star_flux of hllc_flux: F* = F + S (U* - U)
template <class Consts>
__device__ __forceinline__ void star_flux(const float f[5], float rho, float u,
                                          float v, float w, float p, float S,
                                          float S_star, const Consts& c,
                                          float out[5]) {
  const float tiny = 1e-30f;
  const float e = energy_density(rho, u, v, w, p, c);
  const float s_diff = S - S_star;
  const float coef = rho * (S - u) / (fabsf(s_diff) > tiny ? s_diff : tiny);
  const float denom = rho * (S - u);
  const float safe_denom_su = fabsf(denom) > tiny ? denom : tiny;
  const float e_star = coef * (e / rho + (S_star - u) * (S_star + p / safe_denom_su));
  out[0] = f[0] + S * (coef - rho);
  out[1] = f[1] + S * (coef * S_star - rho * u);
  out[2] = f[2] + S * (coef * v - rho * v);
  out[3] = f[3] + S * (coef * w - rho * w);
  out[4] = f[4] + S * (e_star - e);
}

template <class Consts>
__device__ void hllc_flux(float rhoL, float uL, float vL, float wL, float pL,
                          float rhoR, float uR, float vR, float wR, float pR,
                          const Consts& c, float out[5]) {
  const float tiny = 1e-30f;
  const bool okL = rhoL > tiny;
  const bool okR = rhoR > tiny;
  if (!(okL || okR)) {  // both sides vacuum: no flux
    for (int i = 0; i < 5; ++i) out[i] = 0.0f;
    return;
  }
  const float srhoL = okL ? rhoL : 1.0f;
  const float srhoR = okR ? rhoR : 1.0f;
  const float spL = max_nan(pL, 0.0f);
  const float spR = max_nan(pR, 0.0f);
  const float aL = sqrtf(c.gamma * spL / srhoL);
  const float aR = sqrtf(c.gamma * spR / srhoR);

  // PVRS pressure estimate
  const float rho_bar = 0.5f * (srhoL + srhoR);
  const float a_bar = 0.5f * (aL + aR);
  const float p_pvrs = 0.5f * (spL + spR) - 0.5f * (uR - uL) * rho_bar * a_bar;
  const float p_star = max_nan(0.0f, p_pvrs);

  const float SL = uL - aL * q_factor(p_star, spL, c);
  const float SR = uR + aR * q_factor(p_star, spR, c);
  const float denom = srhoL * (SL - uL) - srhoR * (SR - uR);
  const float safe_denom = fabsf(denom) > tiny ? denom : tiny;
  const float S_star =
      (spR - spL + srhoL * uL * (SL - uL) - srhoR * uR * (SR - uR)) /
      safe_denom;

  float f[5];
  // hllc_flux's pick, whose later tests override the earlier ones
  if (SR <= 0.0f) {
    physical_flux(srhoR, uR, vR, wR, spR, c, out);
  } else if (S_star < 0.0f && SR > 0.0f) {
    physical_flux(srhoR, uR, vR, wR, spR, c, f);
    star_flux(f, srhoR, uR, vR, wR, spR, SR, S_star, c, out);
  } else if (SL < 0.0f && S_star >= 0.0f) {
    physical_flux(srhoL, uL, vL, wL, spL, c, f);
    star_flux(f, srhoL, uL, vL, wL, spL, SL, S_star, c, out);
  } else if (SL >= 0.0f) {
    physical_flux(srhoL, uL, vL, wL, spL, c, out);
  } else {  // comparisons with NaN: pick leaves 0
    for (int i = 0; i < 5; ++i) out[i] = 0.0f;
  }
}

}  // namespace cmi
