// K4: the per-cell thermal balance, f64, one thread per cell.
//
// Replaces cmacionize_tpu/ops/temperature.py:solve_temperature (the lockstep
// lax.while_loop log-secant solve; the driver reaches it through
// solve_temperature_compacted, whose staged width compaction is bookkeeping
// for the TPU's lockstep loop and is not carried over: a thread simply stops
// when its cell has converged).  The plain PyTorch version is
// cmacionize_torch/ops/temperature.py:solve_temperature_reference.
//
// Per cell, up to max_iterations log-secant sweeps; each sweep evaluates the
// cooling/heating balance at 1.1T, 0.9T and T.  One balance evaluation runs
//   * the 14 recombination rates (Verner fits + dielectronic terms),
//   * the coupled H-He fixed point (<= 20 iterations, early exit when either
//     fraction settles, damping after 10),
//   * the closed-form metal chains with charge transfer,
//   * the coolant abundances, ten 5x5 level-population solves (Gauss-Jordan
//     with partial pivoting) and three two-level coolants,
//   * bremsstrahlung and recombination cooling.
// After the sweeps, the post-conditions of _temperature_fixups.
//
// Precision: f64 throughout, built with --fmad=false and without fast math.
// Every expression repeats the plain version's torch operations in their
// order: left-to-right sums, one rounding per operation, divisions as IEEE
// divisions, pow with torch's special exponents (pow_scalar), max/min/clamp
// that propagate NaN as torch's clamp does (fmax/fmin would drop a NaN).
// A cell without gas (nd = 0) or without radiation follows the same
// arithmetic as in torch, NaN included, and never traps.
//
// Tables: the wrapper (kernels/temperature.py:kernel_tables) packs the
// abundances, the recombination and charge-transfer fits and the
// line-cooling tables into one f64 buffer; each block copies it into shared
// memory (12.9 KB) once.  The layout offsets below match the wrapper's.
//
// What bounds it on an H100: f64 arithmetic and transcendentals (about 300
// pow/exp/log per balance evaluation, 900 per sweep), not memory: a cell
// reads 18 and writes 16 doubles.  Warps diverge because cells need from 1
// to 100 sweeps and the H-He loop from 1 to 20 iterations; a warp runs as
// long as its slowest cell.  Simple by design: the state lives in registers
// and local memory (spills accepted); sorting cells by expected sweep count
// or splitting the evaluations across threads is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kIons = 14;
constexpr int kMetals = 12;
constexpr int kFive = 10;
constexpr int kTwo = 3;
constexpr double kTiny = 1e-300;

// --- buffer layout (kernels/temperature.py:kernel_tables) -------------------
constexpr int kAHe = 0, kAC = 1, kAN = 2, kAO = 3, kANe = 4, kAS = 5;
constexpr int kPahfac = 6, kCrfac = 7, kEpsilon = 8, kMinT = 9;
constexpr int kLogBracket = 10, kCollision = 11, kBoltzmann = 12, kKPerEV = 13;
constexpr int kRec = 16, kRecStride = 20;          // 14 ions x 20
constexpr int kCT = kRec + kIons * kRecStride;       // 3 tables x 14 ions x 8
constexpr int kCTStride = 8;
constexpr int kFiveA = kCT + 3 * kIons * kCTStride;  // [10][10]
constexpr int kFiveE = kFiveA + 100;                 // [10][10]
constexpr int kFiveInvw = kFiveE + 100;              // [10][5]
constexpr int kFiveGamma = kFiveInvw + 50;           // [10][10][7]
constexpr int kTwoA = kFiveGamma + 700;              // [3]
constexpr int kTwoE = kTwoA + 3;                     // [3]
constexpr int kTwoInvw = kTwoE + 3;                  // [3][2]
constexpr int kTwoGamma = kTwoInvw + 6;              // [3][7]
constexpr int kTableSize = kTwoGamma + 21;
// charge-transfer tables
constexpr int kCTRecH = 0, kCTIonH = 1, kCTRecHe = 2;
// ion indices (models/ions.py)
enum { H_n, He_n, C_p1, C_p2, N_n, N_p1, N_p2, O_n, O_p1, Ne_n, Ne_p1, S_p1, S_p2, S_p3 };
// metal slot m is ion m + 2
__device__ __forceinline__ int metal(int ion) { return ion - 2; }

// --- torch semantics ----------------------------------------------------------
__device__ __forceinline__ double nan_max(double x, double lo) {
  return isnan(x) ? x : (x > lo ? x : lo);  // torch.clamp_min
}
__device__ __forceinline__ double nan_min(double x, double hi) {
  return isnan(x) ? x : (x < hi ? x : hi);  // torch.clamp_max
}
__device__ __forceinline__ double nan_clamp(double x, double lo, double hi) {
  return nan_min(nan_max(x, lo), hi);  // torch.clamp
}
// tensor ** python-number, with torch's special exponents
__device__ __forceinline__ double pow_scalar(double x, double e) {
  if (e == 0.0) return 1.0;
  if (e == 1.0) return x;
  if (e == 0.5) return sqrt(x);
  if (e == 2.0) return x * x;
  if (e == 3.0) return x * x * x;
  if (e == -0.5) return rsqrt(x);
  if (e == -1.0) return 1.0 / x;
  if (e == -2.0) return 1.0 / (x * x);
  return pow(x, e);
}

// --- ops/recombination.py -----------------------------------------------------
__device__ double recombination_rate(int ion, double T, const double* tab) {
  const double* c = tab + kRec + ion * kRecStride;
  double rate;
  if (c[0] == 0.0) {  // rnew: A / (tt (1+tt)^(1-B) (1+sqrt(T/T1))^(1+B))
    const double A = c[1], B = c[2], T0 = c[3], T1 = c[4];
    const double tt = sqrt(T / T0);
    rate = A / (tt * pow_scalar(1.0 + tt, 1.0 - B) *
                pow_scalar(1.0 + sqrt(T / T1), 1.0 + B));
  } else {  // rrec: a (T/1e4)^-b
    rate = c[1] * pow_scalar(T * 1e-4, -c[2]);
  }
  const int kind = static_cast<int>(c[5]);
  const double* d = c + 6;
  if (kind == 1) {  // Nussbaumer & Storey 1983
    const double t = T * 1e-4;
    const double t_inv = 1.0 / t;
    rate = rate + 1e-12 * (d[0] * t_inv + d[1] + d[2] * t + d[3] * t * t) *
                      pow_scalar(t, -1.5) * exp(-d[4] * t_inv);
  } else if (kind == 2) {  // S_p1
    const double t_ev = T / tab[kKPerEV];
    rate = rate + d[0] * exp(d[1] / t_ev) * pow_scalar(t_ev, -1.5);
  } else if (kind == 3) {  // S_p2
    const double t_ev = T / tab[kKPerEV];
    rate = rate + (d[0] * exp(d[1] / t_ev) + d[2] * exp(d[3] / t_ev)) *
                      pow_scalar(t_ev, -1.5);
  } else if (kind == 4) {  // S_p3
    const double T_inv = 1.0 / T;
    double total = d[0] * exp(d[1] * T_inv);
    for (int k = 1; k < 6; ++k) total = total + d[2 * k] * exp(d[2 * k + 1] * T_inv);
    rate = rate + total * pow_scalar(T, -1.5);
  }
  return nan_max(rate, 0.0) * 1e-6;
}

// --- ops/charge_transfer.py ---------------------------------------------------
__device__ double charge_transfer(int table, int ion, double t4, const double* tab) {
  const double* c = tab + kCT + (table * kIons + ion) * kCTStride;
  if (c[0] == 0.0) return 0.0;  // no published rate
  const double t = nan_clamp(t4, c[6], c[7]);
  double rate = c[1] * pow_scalar(t, c[2]) * (1.0 + c[3] * exp(-c[4] * t));
  if (c[5] != 0.0) rate = rate * exp(-c[5] / t);
  return rate;
}

// --- ops/ionization.py:hydrogen_helium_neutral_fractions ---------------------
__device__ void hydrogen_helium(double jH, double jHe, double nH, double AHe, double T,
                                double alphaH, double alphaHe, double& h0_out,
                                double& he0_out) {
  const double safe_jH = jH > 0.0 ? jH : 1.0;
  const double safe_jHe = jHe > 0.0 ? jHe : 1.0;
  const bool has_che = jHe > 0.0;
  const double alpha_e_2sP = 4.17e-20 * pow_scalar(T * 1.0e-4, -0.861);
  const double ch1 = alphaH * nH / safe_jH;
  const double ch2 = AHe * alpha_e_2sP * nH / safe_jH;
  const double che = has_che ? alphaHe * nH / safe_jHe : 0.0;
  const double sqrtT = sqrt(T);

  double h0old = 0.99 * (1.0 - exp(-0.5 / ch1));
  double h0 = 0.9 * h0old;
  double he0old = has_che ? nan_min(0.5 / nan_max(che, kTiny), 1.0) : 1.0;
  double he0 = 0.0;
  auto converged = [](double h0, double h0old, double he0, double he0old) {
    const bool dh = fabs(h0 - h0old) > 1e-4 * h0old;
    const bool dhe = fabs(he0 - he0old) > 1e-4 * he0old;
    return !(dh && dhe);
  };
  bool frozen = converged(h0, h0old, he0, he0old);
  for (int niter = 0; niter < 20 && !frozen; ++niter) {
    const double h0old_n = h0;
    const double he0old_n = nan_max(he0, 0.0);
    const double pHots =
        1.0 / (1.0 + 77.0 * he0old_n / (sqrtT * nan_max(h0old_n, kTiny)));
    const double ch = ch1 - ch2 * AHe * (1.0 - he0old_n) * pHots / (1.0 - h0old_n);

    const double bhe = (1.0 + 2.0 * AHe - h0) * che + 1.0;
    const double che_bhe = che / bhe;
    const double opAHeh0 = 1.0 + AHe - h0;
    const double t1he = 4.0 * AHe * opAHeh0 * che_bhe * che_bhe;
    const double disc_he =
        sqrt(nan_max(bhe * bhe - 4.0 * AHe * opAHeh0 * che * che, 0.0));
    const double he0_exact = (bhe - disc_he) / (2.0 * AHe * nan_max(che, kTiny));
    double he0_new = t1he < 1e-3 ? opAHeh0 * che_bhe : he0_exact;
    he0_new = has_che ? he0_new : 1.0;

    const double b = ch * (2.0 + AHe - he0_new * AHe) + 1.0;
    const double ch_b = ch / b;
    const double opA = 1.0 + AHe - he0_new * AHe;
    const double t1 = 4.0 * ch_b * ch_b * opA;
    const double disc_h = sqrt(nan_max(b * b - 4.0 * ch * ch * opA, 0.0));
    const double sign_ch = ch >= 0.0 ? 1.0 : -1.0;
    const double h0_exact = (b - disc_h) / (2.0 * sign_ch * nan_max(fabs(ch), kTiny));
    double h0_new = t1 < 1e-3 ? ch_b * opA : h0_exact;

    if (niter + 1 > 10) {  // averaging damping
      h0_new = 0.5 * (h0_new + h0old_n);
      he0_new = 0.5 * (he0_new + he0old_n);
    }
    h0 = h0_new;
    he0 = he0_new;
    h0old = h0old_n;
    he0old = he0old_n;
    frozen = converged(h0, h0old, he0, he0old);
  }
  const bool neutral = jH < 1.0e-20;
  h0_out = neutral ? 1.0 : h0;
  he0_out = neutral ? 1.0 : he0;
}

// --- ops/ionization.py:metal_ion_fractions -------------------------------------
struct MetalInputs {
  const double* j;  // [14] photoionization rates
  double safe_ne, t4, nh0, nhe0, nhp;
  const double* alpha;  // [14] recombination rates (metal slots used)
  const double* tab;
};

__device__ double stage_ratio(const MetalInputs& in, int ion, bool with_ion_H) {
  double denom = in.safe_ne * in.alpha[ion] +
                 in.nh0 * charge_transfer(kCTRecH, ion, in.t4, in.tab);
  denom = denom + in.nhe0 * charge_transfer(kCTRecHe, ion, in.t4, in.tab);
  double numer = in.j[ion];
  if (with_ion_H) numer = numer + in.nhp * charge_transfer(kCTIonH, ion, in.t4, in.tab);
  return numer / nan_max(denom, kTiny);
}

// stage fractions of one element from R(2,1) and the next `n - 1` ratios
__device__ void chain(double* out, const double* ratios, int n) {
  double cumulative[3];
  cumulative[0] = ratios[0];
  for (int k = 1; k < n; ++k) cumulative[k] = ratios[k] * cumulative[k - 1];
  double total = 1.0 + cumulative[0];
  for (int k = 1; k < n; ++k) total = total + cumulative[k];
  const double inv = 1.0 / total;
  for (int k = 0; k < n; ++k) out[k] = cumulative[k] * inv;
}

__device__ void metal_fractions(const MetalInputs& in, double* m) {
  double r[3];
  r[0] = in.j[C_p1] / nan_max(in.safe_ne * in.alpha[C_p1], kTiny);
  r[1] = stage_ratio(in, C_p2, false);
  chain(m + metal(C_p1), r, 2);
  r[0] = stage_ratio(in, N_n, true);
  r[1] = stage_ratio(in, N_p1, false);
  r[2] = stage_ratio(in, N_p2, false);
  chain(m + metal(N_n), r, 3);
  r[0] = stage_ratio(in, O_n, true);
  r[1] = stage_ratio(in, O_p1, false);
  chain(m + metal(O_n), r, 2);
  r[0] = in.j[Ne_n] / nan_max(in.safe_ne * in.alpha[Ne_n], kTiny);
  r[1] = stage_ratio(in, Ne_p1, false);
  chain(m + metal(Ne_n), r, 2);
  r[0] = stage_ratio(in, S_p1, false);
  r[1] = stage_ratio(in, S_p2, false);
  r[2] = stage_ratio(in, S_p3, false);
  chain(m + metal(S_p1), r, 3);
}

// --- ops/line_cooling.py --------------------------------------------------------
// Ω(T) fit; g holds (1+g0, g1, g2, g3, g4, g5-1, g6)
__device__ __forceinline__ double collision_strength(const double* g, double T,
                                                     double Tinv, double logT) {
  return pow(T, g[0]) *
         (g[1] + g[2] * Tinv + g[3] * logT + g[4] * T * (1.0 + g[5] * pow(T, g[6])));
}

// Σ over the ion's transitions of n_upper A E (solve5x5's order)
__device__ double five_level_cooling(int ion, double T, double Tinv, double logT,
                                     double prefactor, const double* tab) {
  const double* A = tab + kFiveA + ion * 10;
  const double* E = tab + kFiveE + ion * 10;
  const double* iw = tab + kFiveInvw + ion * 5;
  const double* gamma = tab + kFiveGamma + ion * 70;
  double dn[10], up[10];
  for (int t = 0; t < 10; ++t) {
    dn[t] = prefactor * collision_strength(gamma + 7 * t, T, Tinv, logT);
    up[t] = dn[t] * exp(-E[t] * Tinv);
  }
  enum { T01, T02, T03, T04, T12, T13, T14, T23, T24, T34 };
  double M[5][6];
  for (int k = 0; k < 5; ++k) M[0][k] = 1.0;
  M[1][0] = up[T01] * iw[0];
  M[1][1] = -(A[T01] + iw[1] * (dn[T01] + up[T12] + up[T13] + up[T14]));
  M[1][2] = A[T12] + iw[2] * dn[T12];
  M[1][3] = A[T13] + iw[3] * dn[T13];
  M[1][4] = A[T14] + iw[4] * dn[T14];
  M[2][0] = up[T02] * iw[0];
  M[2][1] = up[T12] * iw[1];
  M[2][2] = -(A[T02] + A[T12] + iw[2] * (dn[T02] + dn[T12] + up[T23] + up[T24]));
  M[2][3] = A[T23] + iw[3] * dn[T23];
  M[2][4] = A[T24] + iw[4] * dn[T24];
  M[3][0] = up[T03] * iw[0];
  M[3][1] = up[T13] * iw[1];
  M[3][2] = up[T23] * iw[2];
  M[3][3] = -(A[T03] + A[T13] + A[T23] +
              iw[3] * (dn[T03] + dn[T13] + dn[T23] + up[T34]));
  M[3][4] = A[T34] + iw[4] * dn[T34];
  M[4][0] = up[T04] * iw[0];
  M[4][1] = up[T14] * iw[1];
  M[4][2] = up[T24] * iw[2];
  M[4][3] = up[T34] * iw[3];
  M[4][4] = -(A[T04] + A[T14] + A[T24] + A[T34] +
              iw[4] * (dn[T04] + dn[T14] + dn[T24] + dn[T34]));
  for (int r = 0; r < 5; ++r) M[r][5] = r == 0 ? 1.0 : 0.0;

  // Gauss-Jordan with partial pivoting: the first row of largest |value|,
  // NaN counting as largest (torch.argmax)
  for (int j = 0; j < 5; ++j) {
    int p = j;
    double best = fabs(M[j][j]);
    for (int r = j + 1; r < 5; ++r) {
      const double c = fabs(M[r][j]);
      if (!isnan(best) && (isnan(c) || c > best)) {
        best = c;
        p = r;
      }
    }
    if (p != j) {
      for (int k = 0; k < 6; ++k) {
        const double tmp = M[j][k];
        M[j][k] = M[p][k];
        M[p][k] = tmp;
      }
    }
    const double piv = M[j][j];
    double row[6];
    for (int k = 0; k < 6; ++k) row[k] = M[j][k] / piv;
    for (int r = 0; r < 5; ++r) {
      if (r == j) continue;
      const double f = M[r][j];
      for (int k = 0; k < 6; ++k) M[r][k] = M[r][k] - f * row[k];
    }
    for (int k = 0; k < 6; ++k) M[j][k] = row[k];
  }
  constexpr int kUpper[10] = {1, 2, 3, 4, 2, 3, 4, 3, 4, 4};
  double total = M[kUpper[0]][5] * A[0] * E[0];
  for (int t = 1; t < 10; ++t) total = total + M[kUpper[t]][5] * A[t] * E[t];
  return total;
}

__device__ double two_level_cooling(int ion, double T, double Tinv, double logT,
                                    double prefactor, const double* tab) {
  const double A = tab[kTwoA + ion], E = tab[kTwoE + ion];
  const double iw0 = tab[kTwoInvw + 2 * ion], iw1 = tab[kTwoInvw + 2 * ion + 1];
  const double cs = prefactor * collision_strength(tab + kTwoGamma + 7 * ion, T, Tinv, logT);
  const double Texp = exp(-E * Tinv);
  const double pop = cs * Texp * iw0 / (A + cs * (iw1 + Texp * iw0));
  return pop * A * E;
}

// --- ops/temperature.py:cooling_heating_balance --------------------------------
struct Balance {
  double h0, he0, gain, loss;
  double metals[kMetals];
};

__device__ __noinline__ void balance(double T, const double* j, double hH, double hHe,
                                     double nd, const double* tab, Balance& out) {
  const double AHe = tab[kAHe];
  double alpha[kIons];
  for (int ion = 0; ion < kIons; ++ion) alpha[ion] = recombination_rate(ion, T, tab);

  double h0, he0;
  hydrogen_helium(j[H_n], j[He_n], nd, AHe, T, alpha[H_n], alpha[He_n], h0, he0);
  const double ne = nd * (1.0 - h0 + AHe * (1.0 - he0));
  const double nhp = nd * (1.0 - h0);
  const double nhep = nd * AHe * (1.0 - he0);
  const double nenhp = ne * nhp;
  const double nenhep = ne * nhep;
  const double sqrtT = sqrt(T);
  const double logT = log(T);
  const double T4 = T * 1e-4;

  // heating
  double gain = nd * (hH * h0 + hHe * AHe * he0);
  const double alpha_e_2sP = 4.17e-20 * pow_scalar(T4, -0.861);
  const double pHots = 1.0 / (1.0 + 77.0 * he0 / (sqrtT * nan_max(h0, kTiny)));
  gain = gain + pHots * 1.21765423e-18 * alpha_e_2sP * nenhep;
  gain = gain + 1.5e-37 * nd * ne * tab[kPahfac];
  if (tab[kCrfac] > 0.0) {
    gain = gain + (tab[kCrfac] * 1.2e-25) / sqrt(nan_max(ne, kTiny));
  }

  // metal ionization
  MetalInputs in;
  in.j = j;
  in.safe_ne = nan_max(ne, 1e-30);
  in.t4 = T * 1.0e-4;
  in.nh0 = nd * h0;
  in.nhe0 = nd * he0 * AHe;
  in.nhp = nhp;
  in.alpha = alpha;
  in.tab = tab;
  double* m = out.metals;
  metal_fractions(in, m);

  // coolant abundances, line_cooling.COOLANT_NAMES order
  const double AC = tab[kAC], AN = tab[kAN], AO = tab[kAO], ANe = tab[kANe],
               AS = tab[kAS];
  const double abund[kFive + kTwo] = {
      AN * (1.0 - m[metal(N_n)] - m[metal(N_p1)] - m[metal(N_p2)]),  // NI
      AN * m[metal(N_n)],                                             // NII
      AO * (1.0 - m[metal(O_n)] - m[metal(O_p1)]),                    // OI
      AO * m[metal(O_n)],                                             // OII
      AO * m[metal(O_p1)],                                            // OIII
      ANe * m[metal(Ne_p1)],                                          // NeIII
      AS * (1.0 - m[metal(S_p1)] - m[metal(S_p2)] - m[metal(S_p3)]),  // SII
      AS * m[metal(S_p1)],                                            // SIII
      AC * (1.0 - m[metal(C_p1)] - m[metal(C_p2)]),                   // CII
      AC * m[metal(C_p1)],                                            // CIII
      AN * m[metal(N_p1)],                                            // NIII
      ANe * m[metal(Ne_n)],                                           // NeII
      AS * m[metal(S_p2)],                                            // SIV
  };

  // line cooling
  const double Tinv = 1.0 / T;
  const double prefactor = tab[kCollision] * ne / sqrtT;
  double lines = abund[0] * five_level_cooling(0, T, Tinv, logT, prefactor, tab);
  for (int ion = 1; ion < kFive; ++ion) {
    lines = lines + abund[ion] * five_level_cooling(ion, T, Tinv, logT, prefactor, tab);
  }
  for (int ion = 0; ion < kTwo; ++ion) {
    lines = lines +
            abund[kFive + ion] * two_level_cooling(ion, T, Tinv, logT, prefactor, tab);
  }
  double loss = nan_max(tab[kBoltzmann] * lines, 1e-99) * nd;

  // bremsstrahlung and recombination cooling
  const double cgaunt = 5.5 - logT;
  const double gff = 1.1 + 0.34 * exp(-cgaunt * cgaunt / 3.0);
  loss = loss + 1.42e-40 * gff * sqrtT * (nenhp + nenhep);
  loss = loss + 2.85e-40 * nenhp * sqrtT *
                    (5.914 - 0.5 * logT + 0.01184 * pow_scalar(T, 1.0 / 3.0));
  loss = loss + 1.55e-39 * nenhep * pow_scalar(T, 0.3647);

  out.h0 = h0;
  out.he0 = he0;
  out.gain = nan_max(gain, 0.0);
  out.loss = nan_max(loss, 0.0);
}

__device__ __forceinline__ double log_ratio(double a, double b) {
  return b > 0.0 ? (a > 0.0 ? log(nan_max(a, kTiny) / b) : -99.0)
                 : (a > 0.0 ? 99.0 : 0.0);
}

__global__ void __launch_bounds__(kThreads) temperature_kernel(
    const double* __restrict__ tables, const double* __restrict__ T_init,
    const double* __restrict__ j_in, const double* __restrict__ h_in,
    const double* __restrict__ nd_in, double* __restrict__ T_out,
    double* __restrict__ h0_out, double* __restrict__ he0_out,
    double* __restrict__ metals_out, int32_t* __restrict__ sweeps_out, int n,
    int max_iterations) {
  __shared__ double tab[kTableSize];
  for (int k = threadIdx.x; k < kTableSize; k += blockDim.x) tab[k] = tables[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  double j[kIons];
  for (int ion = 0; ion < kIons; ++ion) j[ion] = j_in[static_cast<int64_t>(ion) * n + i];
  const double hH = h_in[i], hHe = h_in[static_cast<int64_t>(n) + i];
  const double nd = nd_in[i];
  const double Ti = T_init[i];
  const double epsilon = tab[kEpsilon], min_T = tab[kMinT];

  // _secant_start_state
  double T = Ti <= 4000.0 ? 8000.0 : Ti;
  double gain = 1.0, loss = 0.0, h0 = 0.0, he0 = 0.0;
  double m[kMetals];
  for (int k = 0; k < kMetals; ++k) m[k] = 0.0;
  int sweeps = 0;

  // _secant_loop: sweep until this cell freezes
  Balance bal1, bal2, bal0;
  for (int it = 0; it < max_iterations; ++it) {
    balance(1.1 * T, j, hH, hHe, nd, tab, bal1);
    balance(0.9 * T, j, hH, hHe, nd, tab, bal2);
    balance(T, j, hH, hHe, nd, tab, bal0);
    const double expdiff = log_ratio(bal1.gain, bal2.gain) - log_ratio(bal1.loss, bal2.loss);
    const bool good = bal0.gain > 0.0 && expdiff != 0.0;
    const double ratio = bal0.loss / nan_max(bal0.gain, kTiny);
    const double exponent = nan_clamp(tab[kLogBracket] / (good ? expdiff : 1.0), -50.0, 50.0);
    double T_new = good ? T * exp(exponent * log(nan_max(ratio, kTiny))) : 1.1 * T;

    const bool went_cold = T_new < min_T;
    const bool went_hot = T_new > 1e10;
    T_new = went_cold ? 500.0 : (went_hot ? 1e10 : T_new);
    h0 = went_cold ? 1.0 : (went_hot ? 1e-10 : bal0.h0);
    he0 = went_cold ? 1.0 : (went_hot ? 1e-10 : bal0.he0);
    const bool forced = went_cold || went_hot;
    gain = forced ? 1.0 : bal0.gain;
    loss = forced ? 1.0 : bal0.loss;
    for (int k = 0; k < kMetals; ++k) m[k] = bal0.metals[k];
    T = T_new;
    ++sweeps;
    // the reference's top-of-loop exit test, on the values just computed
    if (fabs(gain - loss) <= epsilon * nan_max(gain, kTiny)) break;
  }

  // _temperature_fixups
  T = nan_min(T, 30000.0);
  const bool no_jH = j[H_n] <= 0.0;
  h0 = no_jH ? 1.0 : h0;
  he0 = j[He_n] <= 0.0 ? 1.0 : he0;
  const bool clean = no_jH || h0 <= 1e-10;
  T_out[i] = T;
  h0_out[i] = h0;
  he0_out[i] = he0;
  for (int k = 0; k < kMetals; ++k) {
    metals_out[static_cast<int64_t>(k) * n + i] = clean ? 0.0 : m[k];
  }
  sweeps_out[i] = sweeps;
}

}  // namespace

// Launches K4 on `stream`; returns cudaGetLastError() (0 on success).
// tables: the packed f64 buffer (kTableSize values); T_init, nd, T, h0, he0
// and sweeps: n values; j: [14][n]; h: [2][n]; metals: [12][n].
extern "C" int cmi_temperature(const double* tables, const double* T_init,
                               const double* j, const double* h, const double* nd,
                               double* T, double* h0, double* he0, double* metals,
                               int32_t* sweeps, int n, int max_iterations,
                               int table_size, void* stream) {
  if (table_size != kTableSize) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    temperature_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        tables, T_init, j, h, nd, T, h0, he0, metals, sweeps, n, max_iterations);
  }
  return static_cast<int>(cudaGetLastError());
}
