// K4 and K4f: the per-cell thermal balance in f64 (K4) and in scaled f32
// (K4f), from one body templated on the scalar type.
//
// K4 replaces cmacionize_tpu/ops/temperature.py:solve_temperature (the
// lockstep lax.while_loop log-secant solve; the driver reaches it through
// solve_temperature_compacted, whose staged width compaction is bookkeeping
// for the TPU's lockstep loop and is not carried over: a lane simply takes
// the next cell when its cell has converged).  K4f replaces
// solve_temperature_device (:338), the same algorithm in f32 with every gain
// and loss coefficient multiplied by DEVICE_SOLVE_SCALE = 1e26 (the backend
// `TemperatureCalculator: backend: f32-device`), and with the collision
// strengths interpolated in log T from the JAX package's f32 table
// (line_cooling._omega_tables) instead of their fit, which cancels in f32.
// The chunking of solve_temperature_device_chunked (:376) works around the
// TPU compile's constant budget and is not carried over.  The plain PyTorch
// versions are cmacionize_torch/ops/temperature.py:
// solve_temperature_reference and solve_temperature_device_reference.
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
// Precision: built with --fmad=false and without fast math, so that no
// operation is contracted or approximated.  Every expression repeats the
// plain version's torch operations in their order: left-to-right sums, one
// rounding per operation, divisions as IEEE divisions, pow with torch's
// special exponents (pow_scalar), max/min/clamp that propagate NaN as torch's
// clamp does (fmax/fmin would drop a NaN), and the libdevice exp/log/pow of
// the working precision (expf/logf/powf in K4f, never __expf and friends).
// A Python number that meets a tensor in the plain version is rounded once
// to the working precision (R(...) below); a product of Python numbers, such
// as 1.42e-40 * scale or 1 + 2 AHe, is formed in f64 by the wrapper
// (kernels/temperature.py:kernel_tables) and rounded once, as JAX's weak
// typing does.  The f32 floors are those of the JAX f32 solve: the division
// guard 1e-30 (1e-300 rounds to 0 in f32) and the cooling floor 1e-35.
// Subnormals: the H100 keeps f32 subnormals unless a kernel is built with
// --ftz=true, and torch's own CUDA kernels (the plain version on the card)
// keep them too; K4f is built without --ftz, so that it equals its plain
// version on the card.  (XLA on the CPU and the TPU flush them; the 1e26
// scale keeps the balance's terms out of that range, and the CPU parity of
// the plain version with the JAX package needs no flush either: flushing in
// torch changed no result, tests/test_torch_temperature_f32.py.)  A cell without gas
// (nd = 0) or without radiation follows the same arithmetic as in torch, NaN
// included, and never traps.
//
// Tables: the wrapper packs the abundances, the scaled coefficients, the
// recombination and charge-transfer fits and the line-cooling tables into
// one buffer of the working precision (kept on the card per configuration);
// each block copies it into shared memory (12.9 KB in f64, 6.5 KB in f32)
// once.  K4f also reads the f32 log-Omega table ([512 nodes][10 x 10
// five-level + 3 two-level], 206 KB) from device memory, two rows per
// evaluation, through the caches.  The layout offsets below match the
// wrapper's.
//
// What bounds it on an H100: arithmetic and transcendentals (about 300
// pow/exp/log per balance evaluation, 900 per sweep), not memory: a cell
// reads 18 and writes 16 values.  Their f64 chains are long and the
// registers few, so a warp issues seldom; cells need from 1 to 100 sweeps (a
// cell without gas always 100).  The design (PERF.md §6 has each piece's
// reading against the one thread a cell of the first port):
//   * Lanes refill from a work counter.  The grid is persistent: the blocks
//     the card holds at once (the wrapper's occupancy query), capped at what
//     n needs.  A lane whose cell froze or reached max_iterations writes the
//     cell's outputs and takes the next cell index; the lanes of a warp that
//     want one take them with one atomicAdd (__ballot_sync / __popc, the
//     first index handed out by __shfl_sync).  The launcher zeroes the
//     counter on the stream before every launch.  A warp no longer waits
//     for its slowest cell: one thread a cell kept half the lanes busy.
//   * Three lanes a cell where the cells do not fill the card's lanes (the
//     wrapper's choice, kernels/temperature.py:lanes_per_cell): a small
//     solve is as long as its slowest cell's chain of sweeps, so the three
//     evaluations of a sweep (1.1T, 0.9T, T) run on three lanes, which
//     share their gains and losses by __shfl_sync and make the same update.
//   * State in registers: the balance is inlined once, in a loop over the
//     three temperatures that keeps only gain and loss from 1.1T and 0.9T;
//     the 5x5 Gauss-Jordan is unrolled on compile-time indices, its row swap
//     done by selects that keep torch.argmax's rule (the first row of
//     largest |value|, NaN counting as largest), and it carries only the
//     columns right of the pivot, as the plain version does.  A cell's rates
//     are read from device memory at each evaluation.
//   * Blocks of 64 threads; K4 with one lane a cell held to 168 registers
//     (kMinBlocks).
// No cell's result depends on another cell or on the lanes that ran it, so
// every output is that of one thread a cell, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"

namespace {

constexpr int kThreads = 64;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kIons = 14;
constexpr int kMetals = 12;
constexpr int kFive = 10;
constexpr int kTwo = 3;

// --- buffer layout (kernels/temperature.py:kernel_tables) -------------------
constexpr int kAHe = 0, kAC = 1, kAN = 2, kAO = 3, kANe = 4, kAS = 5;
constexpr int kPahfac = 6, kCrfac = 7, kEpsilon = 8, kMinT = 9;
constexpr int kLogBracket = 10, kCollision = 11, kBoltzmann = 12, kKPerEV = 13;
// the scale and the coefficients times the scale
constexpr int kScale = 14, kHeLya = 15, kPah = 16, kFreeFree = 17, kRecH = 18,
              kRecHe = 19;
// compound constants of AHe, and crfac x 1.2e-25 x scale
constexpr int kOnePlus2AHe = 20, kOnePlusAHe = 21, kTwoPlusAHe = 22, kFourAHe = 23,
              kTwoAHe = 24, kCosmicRay = 25;
// the f32 Omega table's first log-T node and node spacing
constexpr int kOmegaG0 = 26, kOmegaDg = 27;
constexpr int kHeader = 32;
constexpr int kRec = kHeader, kRecStride = 20;       // 14 ions x 20
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
// the f32 Omega table: per node, the 10 x 10 five-level then 3 two-level
constexpr int kOmegaNodes = 512;
constexpr int kOmegaRow = kFive * 10 + kTwo;
// charge-transfer tables
constexpr int kCTRecH = 0, kCTIonH = 1, kCTRecHe = 2;
// ion indices (models/ions.py)
enum { H_n, He_n, C_p1, C_p2, N_n, N_p1, N_p2, O_n, O_p1, Ne_n, Ne_p1, S_p1, S_p2, S_p3 };
// metal slot m is ion m + 2
__device__ __forceinline__ int metal(int ion) { return ion - 2; }

// --- the working precision ----------------------------------------------------
template <typename R> struct Limits;
template <> struct Limits<double> {
  static constexpr double kTiny = 1e-300;         // division guard
  static constexpr double kCoolingFloor = 1e-99;  // line_cooling.COOLING_FLOOR
};
template <> struct Limits<float> {
  static constexpr float kTiny = 1e-30f;
  static constexpr float kCoolingFloor = 1e-35f;
};

// libdevice's IEEE routines of each precision
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_pow(double x, double e) { return pow(x, e); }
__device__ __forceinline__ float m_pow(float x, float e) { return powf(x, e); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_rsqrt(double x) { return rsqrt(x); }
__device__ __forceinline__ float m_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double m_fabs(double x) { return fabs(x); }
__device__ __forceinline__ float m_fabs(float x) { return fabsf(x); }

// --- torch semantics ----------------------------------------------------------
template <typename R> __device__ __forceinline__ bool is_nan(R x) { return x != x; }
template <typename R> __device__ __forceinline__ R nan_max(R x, R lo) {
  return is_nan(x) ? x : (x > lo ? x : lo);  // torch.clamp_min
}
template <typename R> __device__ __forceinline__ R nan_min(R x, R hi) {
  return is_nan(x) ? x : (x < hi ? x : hi);  // torch.clamp_max
}
template <typename R> __device__ __forceinline__ R nan_clamp(R x, R lo, R hi) {
  return nan_min(nan_max(x, lo), hi);  // torch.clamp
}
// tensor ** python-number, with torch's special exponents
template <typename R> __device__ __forceinline__ R pow_scalar(R x, R e) {
  if (e == R(0.0)) return R(1.0);
  if (e == R(1.0)) return x;
  if (e == R(0.5)) return m_sqrt(x);
  if (e == R(2.0)) return x * x;
  if (e == R(3.0)) return x * x * x;
  if (e == R(-0.5)) return m_rsqrt(x);
  if (e == R(-1.0)) return R(1.0) / x;
  if (e == R(-2.0)) return R(1.0) / (x * x);
  return m_pow(x, e);
}

// --- ops/recombination.py -----------------------------------------------------
// row: kind (0 rnew, 1 rrec); rnew: A, 1 - B, 1 + B, T0, T1; rrec: a, -b;
// then the dielectronic kind (0 none, 1 NS83, 2/3/4 the S_p1/S_p2/S_p3 sums)
// and its coefficients
template <typename R> __device__ R recombination_rate(int ion, R T, const R* tab) {
  const R* c = tab + kRec + ion * kRecStride;
  R rate;
  if (c[0] == R(0.0)) {  // rnew: A / (tt (1+tt)^(1-B) (1+sqrt(T/T1))^(1+B))
    const R tt = m_sqrt(T / c[4]);
    rate = c[1] / (tt * pow_scalar(R(1.0) + tt, c[2]) *
                   pow_scalar(R(1.0) + m_sqrt(T / c[5]), c[3]));
  } else {  // rrec: a (T/1e4)^-b
    rate = c[1] * pow_scalar(T * R(1e-4), c[2]);
  }
  const int kind = static_cast<int>(c[6]);
  const R* d = c + 7;
  if (kind == 1) {  // Nussbaumer & Storey 1983
    const R t = T * R(1e-4);
    const R t_inv = R(1.0) / t;
    rate = rate + R(1e-12) * (d[0] * t_inv + d[1] + d[2] * t + d[3] * t * t) *
                      pow_scalar(t, R(-1.5)) * m_exp(-d[4] * t_inv);
  } else if (kind == 2) {  // S_p1
    const R t_ev = T / tab[kKPerEV];
    rate = rate + d[0] * m_exp(d[1] / t_ev) * pow_scalar(t_ev, R(-1.5));
  } else if (kind == 3) {  // S_p2
    const R t_ev = T / tab[kKPerEV];
    rate = rate + (d[0] * m_exp(d[1] / t_ev) + d[2] * m_exp(d[3] / t_ev)) *
                      pow_scalar(t_ev, R(-1.5));
  } else if (kind == 4) {  // S_p3
    const R T_inv = R(1.0) / T;
    R total = d[0] * m_exp(d[1] * T_inv);
    for (int k = 1; k < 6; ++k) total = total + d[2 * k] * m_exp(d[2 * k + 1] * T_inv);
    rate = rate + total * pow_scalar(T, R(-1.5));
  }
  return nan_max(rate, R(0.0)) * R(1e-6);
}

// --- ops/charge_transfer.py ---------------------------------------------------
template <typename R> __device__ R charge_transfer(int table, int ion, R t4, const R* tab) {
  const R* c = tab + kCT + (table * kIons + ion) * kCTStride;
  if (c[0] == R(0.0)) return R(0.0);  // no published rate
  const R t = nan_clamp(t4, c[6], c[7]);
  R rate = c[1] * pow_scalar(t, c[2]) * (R(1.0) + c[3] * m_exp(-c[4] * t));
  if (c[5] != R(0.0)) rate = rate * m_exp(-c[5] / t);
  return rate;
}

// --- ops/ionization.py:hydrogen_helium_neutral_fractions ---------------------
template <typename R>
__device__ __forceinline__ void hydrogen_helium(R jH, R jHe, R nH, R T, R alphaH, R alphaHe,
                                                const R* tab, R& h0_out, R& he0_out) {
  constexpr R kTiny = Limits<R>::kTiny;
  const R AHe = tab[kAHe];
  const R safe_jH = jH > R(0.0) ? jH : R(1.0);
  const R safe_jHe = jHe > R(0.0) ? jHe : R(1.0);
  const bool has_che = jHe > R(0.0);
  const R alpha_e_2sP = R(4.17e-20) * pow_scalar(T * R(1.0e-4), R(-0.861));
  const R ch1 = alphaH * nH / safe_jH;
  const R ch2 = AHe * alpha_e_2sP * nH / safe_jH;
  const R che = has_che ? alphaHe * nH / safe_jHe : R(0.0);
  const R sqrtT = m_sqrt(T);

  R h0old = R(0.99) * (R(1.0) - m_exp(R(-0.5) / ch1));
  R h0 = R(0.9) * h0old;
  R he0old = has_che ? nan_min(R(0.5) / nan_max(che, kTiny), R(1.0)) : R(1.0);
  R he0 = R(0.0);
  auto converged = [](R h0, R h0old, R he0, R he0old) {
    const bool dh = m_fabs(h0 - h0old) > R(1e-4) * h0old;
    const bool dhe = m_fabs(he0 - he0old) > R(1e-4) * he0old;
    return !(dh && dhe);
  };
  bool frozen = converged(h0, h0old, he0, he0old);
  for (int niter = 0; niter < 20 && !frozen; ++niter) {
    const R h0old_n = h0;
    const R he0old_n = nan_max(he0, R(0.0));
    const R pHots =
        R(1.0) / (R(1.0) + R(77.0) * he0old_n / (sqrtT * nan_max(h0old_n, kTiny)));
    const R ch = ch1 - ch2 * AHe * (R(1.0) - he0old_n) * pHots / (R(1.0) - h0old_n);

    const R bhe = (tab[kOnePlus2AHe] - h0) * che + R(1.0);
    const R che_bhe = che / bhe;
    const R opAHeh0 = tab[kOnePlusAHe] - h0;
    const R t1he = tab[kFourAHe] * opAHeh0 * che_bhe * che_bhe;
    const R disc_he =
        m_sqrt(nan_max(bhe * bhe - tab[kFourAHe] * opAHeh0 * che * che, R(0.0)));
    const R he0_exact = (bhe - disc_he) / (tab[kTwoAHe] * nan_max(che, kTiny));
    R he0_new = t1he < R(1e-3) ? opAHeh0 * che_bhe : he0_exact;
    he0_new = has_che ? he0_new : R(1.0);

    const R b = ch * (tab[kTwoPlusAHe] - he0_new * AHe) + R(1.0);
    const R ch_b = ch / b;
    const R opA = tab[kOnePlusAHe] - he0_new * AHe;
    const R t1 = R(4.0) * ch_b * ch_b * opA;
    const R disc_h = m_sqrt(nan_max(b * b - R(4.0) * ch * ch * opA, R(0.0)));
    const R sign_ch = ch >= R(0.0) ? R(1.0) : R(-1.0);
    const R h0_exact = (b - disc_h) / (R(2.0) * sign_ch * nan_max(m_fabs(ch), kTiny));
    R h0_new = t1 < R(1e-3) ? ch_b * opA : h0_exact;

    if (niter + 1 > 10) {  // averaging damping
      h0_new = R(0.5) * (h0_new + h0old_n);
      he0_new = R(0.5) * (he0_new + he0old_n);
    }
    h0 = h0_new;
    he0 = he0_new;
    h0old = h0old_n;
    he0old = he0old_n;
    frozen = converged(h0, h0old, he0, he0old);
  }
  const bool neutral = jH < R(1.0e-20);
  h0_out = neutral ? R(1.0) : h0;
  he0_out = neutral ? R(1.0) : he0;
}

// --- ops/ionization.py:metal_ion_fractions -------------------------------------
template <typename R> struct MetalInputs {
  const R* j;  // photoionization rates: j[ion * js]
  int64_t js;
  R safe_ne, t4, nh0, nhe0, nhp;
  const R* alpha;  // [14] recombination rates (metal slots used)
  const R* tab;
};

template <typename R>
__device__ __forceinline__ R stage_ratio(const MetalInputs<R>& in, int ion, bool with_ion_H) {
  R denom = in.safe_ne * in.alpha[ion] + in.nh0 * charge_transfer(kCTRecH, ion, in.t4, in.tab);
  denom = denom + in.nhe0 * charge_transfer(kCTRecHe, ion, in.t4, in.tab);
  R numer = in.j[ion * in.js];
  if (with_ion_H) numer = numer + in.nhp * charge_transfer(kCTIonH, ion, in.t4, in.tab);
  return numer / nan_max(denom, Limits<R>::kTiny);
}

// stage fractions of one element from R(2,1) and the next `n - 1` ratios
template <typename R> __device__ __forceinline__ void chain(R* out, const R* ratios, int n) {
  R cumulative[3];
  cumulative[0] = ratios[0];
  for (int k = 1; k < n; ++k) cumulative[k] = ratios[k] * cumulative[k - 1];
  R total = R(1.0) + cumulative[0];
  for (int k = 1; k < n; ++k) total = total + cumulative[k];
  const R inv = R(1.0) / total;
  for (int k = 0; k < n; ++k) out[k] = cumulative[k] * inv;
}

template <typename R>
__device__ __forceinline__ void metal_fractions(const MetalInputs<R>& in, R* m) {
  constexpr R kTiny = Limits<R>::kTiny;
  R r[3];
  r[0] = in.j[C_p1 * in.js] / nan_max(in.safe_ne * in.alpha[C_p1], kTiny);
  r[1] = stage_ratio(in, C_p2, false);
  chain(m + metal(C_p1), r, 2);
  r[0] = stage_ratio(in, N_n, true);
  r[1] = stage_ratio(in, N_p1, false);
  r[2] = stage_ratio(in, N_p2, false);
  chain(m + metal(N_n), r, 3);
  r[0] = stage_ratio(in, O_n, true);
  r[1] = stage_ratio(in, O_p1, false);
  chain(m + metal(O_n), r, 2);
  r[0] = in.j[Ne_n * in.js] / nan_max(in.safe_ne * in.alpha[Ne_n], kTiny);
  r[1] = stage_ratio(in, Ne_p1, false);
  chain(m + metal(Ne_n), r, 2);
  r[0] = stage_ratio(in, S_p1, false);
  r[1] = stage_ratio(in, S_p2, false);
  r[2] = stage_ratio(in, S_p3, false);
  chain(m + metal(S_p1), r, 3);
}

// --- ops/line_cooling.py --------------------------------------------------------
// Omega(T) of each transition at one temperature.  f64: the fit, with g
// holding (1+g0, g1, g2, g3, g4, g5-1, g6); f32: exp of the log-Omega table
// interpolated linearly in log T (line_cooling.omega_interpolated).
template <typename R> struct Omega;

template <> struct Omega<double> {
  double T, Tinv, logT;
  const double* tab;
  __device__ Omega(double T_, double Tinv_, double logT_, const double* tab_, const float*)
      : T(T_), Tinv(Tinv_), logT(logT_), tab(tab_) {}
  __device__ __forceinline__ double fit(const double* g) const {
    return pow(T, g[0]) *
           (g[1] + g[2] * Tinv + g[3] * logT + g[4] * T * (1.0 + g[5] * pow(T, g[6])));
  }
  __device__ __forceinline__ double five(int ion, int t) const {
    return fit(tab + kFiveGamma + ion * 70 + 7 * t);
  }
  __device__ __forceinline__ double two(int ion) const { return fit(tab + kTwoGamma + 7 * ion); }
};

template <> struct Omega<float> {
  const float* lo;  // the table's row at the node below T, and the next
  const float* hi;
  float frac;
  __device__ Omega(float T, float, float, const float* tab, const float* table) {
    const float x = (logf(nan_clamp(T, 1.0e2f, 1.0e10f)) - tab[kOmegaG0]) / tab[kOmegaDg];
    int k = static_cast<int>(floorf(x));
    k = k < 0 ? 0 : (k > kOmegaNodes - 2 ? kOmegaNodes - 2 : k);
    frac = x - static_cast<float>(k);
    lo = table + k * kOmegaRow;
    hi = lo + kOmegaRow;
  }
  __device__ __forceinline__ float at(int c) const {
    const float a = __ldg(lo + c);
    return expf(a + frac * (__ldg(hi + c) - a));
  }
  __device__ __forceinline__ float five(int ion, int t) const { return at(ion * 10 + t); }
  __device__ __forceinline__ float two(int ion) const { return at(kFive * 10 + ion); }
};

// The 5x5 augmented system of one five-level ion, rows in registers (or, in
// the shared-scratch form, in `s`).  Gauss-Jordan with partial pivoting in the
// plain version's order (line_cooling._gauss_jordan): per column j the first
// row of largest |value| from j down, NaN counting as largest (torch.argmax),
// is swapped up by selects; the pivot row is divided by the pivot and every
// other row r loses f_r times it.  Columns left of the pivot column never
// reach the solution, so the plain version drops them and so does this.
template <typename R> __device__ __forceinline__ void gauss_jordan(R (&M)[5][6]) {
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    int p = j;
    R best = m_fabs(M[j][j]);
#pragma unroll
    for (int r = j + 1; r < 5; ++r) {
      const R c = m_fabs(M[r][j]);
      const bool take = !is_nan(best) && (is_nan(c) || c > best);
      best = take ? c : best;
      p = take ? r : p;
    }
#pragma unroll
    for (int r = j + 1; r < 5; ++r) {
      const bool swap = p == r;
#pragma unroll
      for (int k = j; k < 6; ++k) {
        const R a = M[j][k], b = M[r][k];
        M[j][k] = swap ? b : a;
        M[r][k] = swap ? a : b;
      }
    }
    const R piv = M[j][j];
#pragma unroll
    for (int k = j + 1; k < 6; ++k) M[j][k] = M[j][k] / piv;
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      if (r == j) continue;
      const R f = M[r][j];
#pragma unroll
      for (int k = j + 1; k < 6; ++k) M[r][k] = M[r][k] - f * M[j][k];
    }
  }
}

// Σ over the ion's transitions of n_upper A E (solve5x5's order)
template <typename R>
__device__ __forceinline__ R five_level_cooling(int ion, R Tinv, R prefactor,
                                                const Omega<R>& omega, const R* tab) {
  const R* A = tab + kFiveA + ion * 10;
  const R* E = tab + kFiveE + ion * 10;
  const R* iw = tab + kFiveInvw + ion * 5;
  R dn[10], up[10];
#pragma unroll
  for (int t = 0; t < 10; ++t) {
    dn[t] = prefactor * omega.five(ion, t);
    up[t] = dn[t] * m_exp(-E[t] * Tinv);
  }
  enum { T01, T02, T03, T04, T12, T13, T14, T23, T24, T34 };
  R M[5][6];
#pragma unroll
  for (int k = 0; k < 5; ++k) M[0][k] = R(1.0);
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
#pragma unroll
  for (int r = 0; r < 5; ++r) M[r][5] = r == 0 ? R(1.0) : R(0.0);
  gauss_jordan(M);
  constexpr int kUpper[10] = {1, 2, 3, 4, 2, 3, 4, 3, 4, 4};
  R total = M[kUpper[0]][5] * A[0] * E[0];
#pragma unroll
  for (int t = 1; t < 10; ++t) total = total + M[kUpper[t]][5] * A[t] * E[t];
  return total;
}

template <typename R>
__device__ __forceinline__ R two_level_cooling(int ion, R Tinv, R prefactor,
                                               const Omega<R>& omega, const R* tab) {
  const R A = tab[kTwoA + ion], E = tab[kTwoE + ion];
  const R iw0 = tab[kTwoInvw + 2 * ion], iw1 = tab[kTwoInvw + 2 * ion + 1];
  const R cs = prefactor * omega.two(ion);
  const R Texp = m_exp(-E * Tinv);
  const R pop = cs * Texp * iw0 / (A + cs * (iw1 + Texp * iw0));
  return pop * A * E;
}

// --- ops/temperature.py:cooling_heating_balance --------------------------------
template <typename R> struct Balance {
  R h0, he0, gain, loss;
  R metals[kMetals];
};

// The balance at T of one cell: its rates j[ion * js], its heating
// integrals hH, hHe and its density nd.
template <typename R>
__device__ __forceinline__ void balance(R T, const R* j, int64_t js, R hH, R hHe, R nd,
                                        const R* tab, const float* omega_table,
                                        Balance<R>& out) {
  constexpr R kTiny = Limits<R>::kTiny;
  const R AHe = tab[kAHe];
  R alpha[kIons];
  for (int ion = 0; ion < kIons; ++ion) alpha[ion] = recombination_rate(ion, T, tab);

  R h0, he0;
  hydrogen_helium(j[H_n * js], j[He_n * js], nd, T, alpha[H_n], alpha[He_n], tab, h0, he0);
  const R ne = nd * (R(1.0) - h0 + AHe * (R(1.0) - he0));
  const R nhp = nd * (R(1.0) - h0);
  const R nhep = nd * AHe * (R(1.0) - he0);
  const R nenhp = ne * nhp;
  const R nenhep = ne * nhep;
  const R sqrtT = m_sqrt(T);
  const R logT = m_log(T);
  const R T4 = T * R(1e-4);

  // heating
  const R scale = tab[kScale];
  R gain = nd * ((hH * scale) * h0 + (hHe * scale) * AHe * he0);
  const R alpha_e_2sP = R(4.17e-20) * pow_scalar(T4, R(-0.861));
  const R pHots = R(1.0) / (R(1.0) + R(77.0) * he0 / (sqrtT * nan_max(h0, kTiny)));
  gain = gain + pHots * tab[kHeLya] * alpha_e_2sP * nenhep;
  gain = gain + tab[kPah] * nd * ne * tab[kPahfac];
  if (tab[kCrfac] > R(0.0)) {
    gain = gain + tab[kCosmicRay] / m_sqrt(nan_max(ne, kTiny));
  }

  // metal ionization
  MetalInputs<R> in;
  in.j = j;
  in.js = js;
  in.safe_ne = nan_max(ne, R(1e-30));
  in.t4 = T * R(1.0e-4);
  in.nh0 = nd * h0;
  in.nhe0 = nd * he0 * AHe;
  in.nhp = nhp;
  in.alpha = alpha;
  in.tab = tab;
  R* m = out.metals;
  metal_fractions(in, m);

  // coolant abundances, line_cooling.COOLANT_NAMES order
  const R AC = tab[kAC], AN = tab[kAN], AO = tab[kAO], ANe = tab[kANe], AS = tab[kAS];
  const R abund[kFive + kTwo] = {
      AN * (R(1.0) - m[metal(N_n)] - m[metal(N_p1)] - m[metal(N_p2)]),  // NI
      AN * m[metal(N_n)],                                                // NII
      AO * (R(1.0) - m[metal(O_n)] - m[metal(O_p1)]),                    // OI
      AO * m[metal(O_n)],                                                // OII
      AO * m[metal(O_p1)],                                               // OIII
      ANe * m[metal(Ne_p1)],                                             // NeIII
      AS * (R(1.0) - m[metal(S_p1)] - m[metal(S_p2)] - m[metal(S_p3)]),  // SII
      AS * m[metal(S_p1)],                                               // SIII
      AC * (R(1.0) - m[metal(C_p1)] - m[metal(C_p2)]),                   // CII
      AC * m[metal(C_p1)],                                               // CIII
      AN * m[metal(N_p1)],                                               // NIII
      ANe * m[metal(Ne_n)],                                              // NeII
      AS * m[metal(S_p2)],                                               // SIV
  };

  // line cooling
  const R Tinv = R(1.0) / T;
  const R prefactor = tab[kCollision] * ne / sqrtT;
  const Omega<R> omega(T, Tinv, logT, tab, omega_table);
  R lines = abund[0] * five_level_cooling(0, Tinv, prefactor, omega, tab);
#pragma unroll 1
  for (int ion = 1; ion < kFive; ++ion) {
    lines = lines + abund[ion] * five_level_cooling(ion, Tinv, prefactor, omega, tab);
  }
#pragma unroll
  for (int ion = 0; ion < kTwo; ++ion) {
    lines = lines + abund[kFive + ion] * two_level_cooling(ion, Tinv, prefactor, omega, tab);
  }
  R loss = nan_max(tab[kBoltzmann] * lines, Limits<R>::kCoolingFloor) * nd;

  // bremsstrahlung and recombination cooling
  const R cgaunt = R(5.5) - logT;
  const R gff = R(1.1) + R(0.34) * m_exp(-cgaunt * cgaunt / R(3.0));
  loss = loss + tab[kFreeFree] * gff * sqrtT * (nenhp + nenhep);
  loss = loss + tab[kRecH] * nenhp * sqrtT *
                    (R(5.914) - R(0.5) * logT + R(0.01184) * pow_scalar(T, R(1.0 / 3.0)));
  loss = loss + tab[kRecHe] * nenhep * pow_scalar(T, R(0.3647));

  out.h0 = h0;
  out.he0 = he0;
  out.gain = nan_max(gain, R(0.0));
  out.loss = nan_max(loss, R(0.0));
}

template <typename R> __device__ __forceinline__ R log_ratio(R a, R b) {
  return b > R(0.0) ? (a > R(0.0) ? m_log(nan_max(a, Limits<R>::kTiny) / b) : R(-99.0))
                    : (a > R(0.0) ? R(99.0) : R(0.0));
}

// One cell's inputs and where its secant stands (_secant_start_state, then
// the loop's T and sweep count); the rest of its state is the last sweep's
// evaluation at T.
template <typename R> struct Cell {
  R hH, hHe, nd, T;
  int sweeps;
};

template <typename R>
__device__ __forceinline__ void load_cell(Cell<R>& c, int64_t i, int64_t n, const R* T_init,
                                          const R* h_in, const R* nd_in) {
  c.hH = h_in[i];
  c.hHe = h_in[n + i];
  c.nd = nd_in[i];
  const R Ti = T_init[i];
  c.T = Ti <= R(4000.0) ? R(8000.0) : Ti;
  c.sweeps = 0;
}

// The secant update of one sweep from its three evaluations (1.1T, 0.9T
// and bal0 at T): T moves, bal0 becomes the cell's state (forced where T
// left the bracket), and the return says whether the cell froze (the
// reference's top-of-loop exit test, on the values just computed).
template <typename R>
__device__ __forceinline__ bool update(Cell<R>& c, R gain1, R loss1, R gain2, R loss2,
                                       Balance<R>& bal0, const R* tab) {
  constexpr R kTiny = Limits<R>::kTiny;
  const R expdiff = log_ratio(gain1, gain2) - log_ratio(loss1, loss2);
  const bool good = bal0.gain > R(0.0) && expdiff != R(0.0);
  const R ratio = bal0.loss / nan_max(bal0.gain, kTiny);
  const R exponent =
      nan_clamp(tab[kLogBracket] / (good ? expdiff : R(1.0)), R(-50.0), R(50.0));
  R T_new = good ? c.T * m_exp(exponent * m_log(nan_max(ratio, kTiny))) : R(1.1) * c.T;

  const bool went_cold = T_new < tab[kMinT];
  const bool went_hot = T_new > R(1e10);
  T_new = went_cold ? R(500.0) : (went_hot ? R(1e10) : T_new);
  bal0.h0 = went_cold ? R(1.0) : (went_hot ? R(1e-10) : bal0.h0);
  bal0.he0 = went_cold ? R(1.0) : (went_hot ? R(1e-10) : bal0.he0);
  const bool forced = went_cold || went_hot;
  const R gain = forced ? R(1.0) : bal0.gain;
  const R loss = forced ? R(1.0) : bal0.loss;
  c.T = T_new;
  ++c.sweeps;
  return m_fabs(gain - loss) <= tab[kEpsilon] * nan_max(gain, kTiny);
}

// _temperature_fixups, and the cell's outputs; s is the cell's state
template <typename R>
__device__ __forceinline__ void store_cell(const Cell<R>& c, const Balance<R>& s, int64_t i,
                                           int64_t n, const R* j_in, R* T_out, R* h0_out,
                                           R* he0_out, R* metals_out, int32_t* sweeps_out) {
  const R jH = j_in[H_n * n + i], jHe = j_in[He_n * n + i];
  const bool no_jH = jH <= R(0.0);
  const R h0 = no_jH ? R(1.0) : s.h0;
  const bool clean = no_jH || h0 <= R(1e-10);
  T_out[i] = nan_min(c.T, R(30000.0));
  h0_out[i] = h0;
  he0_out[i] = jHe <= R(0.0) ? R(1.0) : s.he0;
#pragma unroll
  for (int k = 0; k < kMetals; ++k) metals_out[k * n + i] = clean ? R(0.0) : s.metals[k];
  sweeps_out[i] = c.sweeps;
}

// The kernel: a warp's lanes in groups of kLanes, each group on one cell at
// a time.  kLanes = 1: a lane runs the cell's three evaluations in turn;
// kLanes = 3: the group's lanes run one each (1.1T, 0.9T, T), and every
// lane of the group takes the three gains and losses by __shfl_sync and
// makes the same update (lanes 30 and 31 idle).  A group whose cell froze
// or reached max_iterations stores it (the lane of the evaluation at T)
// and, with the other groups of its warp that want one, takes the next cell
// from the counter: one atomicAdd a warp.
// K4 with one lane a cell is held to 168 registers, so that 6 blocks of 64
// stay resident on an SM (12 warps against 8 at its natural 220, with 184 B
// of spill stores): a large solve is as long as its sweeps over the card's
// warps.  The three-lane form, which serves small solves, is as long as one
// cell's chain of sweeps, and its spills would lengthen that chain.
template <typename R, int kLanes>
constexpr int kMinBlocks = sizeof(R) == 8 && kLanes == 1 ? 6 : 1;

template <typename R, int kLanes>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<R, kLanes>)) temperature_kernel(
    const R* __restrict__ tables, const float* __restrict__ omega_table,
    const R* __restrict__ T_init, const R* __restrict__ j_in, const R* __restrict__ h_in,
    const R* __restrict__ nd_in, R* __restrict__ T_out, R* __restrict__ h0_out,
    R* __restrict__ he0_out, R* __restrict__ metals_out, int32_t* __restrict__ sweeps_out,
    unsigned* __restrict__ next_cell, int n, int max_iterations) {
  __shared__ R tab[kTableSize];
  for (int k = threadIdx.x; k < kTableSize; k += blockDim.x) tab[k] = tables[k];
  __syncthreads();
  const unsigned lane = threadIdx.x % 32u;
  const int e = static_cast<int>(lane) % kLanes;  // this lane's place in its group
  const int head = static_cast<int>(lane) - e;     // the group's first lane
  const bool usable = lane < 32u / kLanes * kLanes;
  const unsigned lanes_below = (1u << lane) - 1u;
  Cell<R> c;
  int cell = -1;
  bool drained = false;  // the counter has passed n: the same in every lane
  for (;;) {
    // the groups without a cell take the next indices, one atomic a warp
    const unsigned want = __ballot_sync(kFullWarp, usable && e == 0 && cell < 0 && !drained);
    if (want != 0u) {
      const int leader = __ffs(want) - 1;
      unsigned first = 0u;
      if (static_cast<int>(lane) == leader) first = atomicAdd(next_cell, __popc(want));
      first = __shfl_sync(kFullWarp, first, leader);
      int taken = -1;
      if ((want >> lane) & 1u) {
        const unsigned k = first + __popc(want & lanes_below);
        if (k < static_cast<unsigned>(n)) taken = static_cast<int>(k);
      }
      if constexpr (kLanes > 1) taken = __shfl_sync(kFullWarp, taken, head);
      if (usable && cell < 0 && taken >= 0) {
        cell = taken;
        load_cell(c, cell, n, T_init, h_in, nd_in);
        if (max_iterations <= 0) {  // no sweep: the start state
          Balance<R> s;
          s.h0 = R(0.0);
          s.he0 = R(0.0);
#pragma unroll
          for (int k = 0; k < kMetals; ++k) s.metals[k] = R(0.0);
          if (e == kLanes - 1) {
            store_cell(c, s, cell, n, j_in, T_out, h0_out, he0_out, metals_out, sweeps_out);
          }
          cell = -1;
        }
      }
      drained = first + __popc(want) >= static_cast<unsigned>(n);
    }
    if (drained && __ballot_sync(kFullWarp, cell >= 0) == 0u) break;
    // the cell's rates are read from device memory at each evaluation
    // rather than held in 28 registers (f64) across the sweeps
    const R* j = j_in + cell;
    // this lane's evaluations of the sweep: all three in turn (1.1T, 0.9T,
    // then T, whose state the sweep keeps) on one lane a cell, one on three
    R gain1 = R(0.0), loss1 = R(0.0), gain2 = R(0.0), loss2 = R(0.0);
    Balance<R> bal;
    bal.gain = R(0.0);
    bal.loss = R(0.0);
    if (cell >= 0) {
#pragma unroll 1
      for (int k = e; k < 3; k += kLanes) {
        const R Te = k == 0 ? R(1.1) * c.T : (k == 1 ? R(0.9) * c.T : c.T);
        balance(Te, j, n, c.hH, c.hHe, c.nd, tab, omega_table, bal);
        if (k == 0) {
          gain1 = bal.gain;
          loss1 = bal.loss;
        } else if (k == 1) {
          gain2 = bal.gain;
          loss2 = bal.loss;
        }
      }
    }
    if constexpr (kLanes == 3) {  // every lane of a group takes the group's three
      gain1 = __shfl_sync(kFullWarp, gain1, head);
      loss1 = __shfl_sync(kFullWarp, loss1, head);
      gain2 = __shfl_sync(kFullWarp, gain2, head + 1);
      loss2 = __shfl_sync(kFullWarp, loss2, head + 1);
      bal.gain = __shfl_sync(kFullWarp, bal.gain, head + 2);
      bal.loss = __shfl_sync(kFullWarp, bal.loss, head + 2);
    }
    if (cell >= 0 &&
        (update(c, gain1, loss1, gain2, loss2, bal, tab) || c.sweeps >= max_iterations)) {
      if (e == kLanes - 1) {
        store_cell(c, bal, cell, n, j_in, T_out, h0_out, he0_out, metals_out, sweeps_out);
      }
      cell = -1;
    }
  }
}

template <typename R>
int launch(const R* tables, const float* omega, const R* T_init, const R* j, const R* h,
           const R* nd, R* T, R* h0, R* he0, R* metals, int32_t* sweeps, unsigned* next_cell,
           int n, int max_iterations, int table_size, int lanes, int blocks, void* stream) {
  if (table_size != kTableSize || (lanes != 1 && lanes != 3) || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t zeroed = cudaMemsetAsync(next_cell, 0, sizeof(unsigned), s);
    if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
    // warps of 32 cells, or of 10 groups of three lanes
    const int64_t warps = lanes == 3 ? (n + 9) / 10 : (n + 31) / 32;
    const int64_t needed = (warps * 32 + kThreads - 1) / kThreads;
    const int grid = static_cast<int>(blocks < needed ? blocks : needed);
    if (lanes == 3) {
      temperature_kernel<R, 3><<<grid, kThreads, 0, s>>>(tables, omega, T_init, j, h, nd, T,
                                                         h0, he0, metals, sweeps, next_cell,
                                                         n, max_iterations);
    } else {
      temperature_kernel<R, 1><<<grid, kThreads, 0, s>>>(tables, omega, T_init, j, h, nd, T,
                                                         h0, he0, metals, sweeps, next_cell,
                                                         n, max_iterations);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch K4 (f64) or K4f (f32) on `stream`; each returns the CUDA error (0 on
// success).  tables: the packed buffer (kTableSize values of the working
// precision); omega (K4f only): the f32 log-Omega table, kOmegaNodes x
// kOmegaRow values; T_init, nd, T, h0, he0 and sweeps: n values; j: [14][n];
// h: [2][n]; metals: [12][n]; next_cell: one unsigned int of scratch, the
// work counter, zeroed on the stream before the kernel; lanes: 1 or 3 lanes
// a cell; blocks: the persistent grid of that form (the blocks resident on
// the card), capped at what n needs.
extern "C" int cmi_temperature(const double* tables, const double* T_init,
                               const double* j, const double* h, const double* nd,
                               double* T, double* h0, double* he0, double* metals,
                               int32_t* sweeps, unsigned* next_cell, int n,
                               int max_iterations, int table_size, int lanes, int blocks,
                               void* stream) {
  return launch<double>(tables, nullptr, T_init, j, h, nd, T, h0, he0, metals, sweeps,
                        next_cell, n, max_iterations, table_size, lanes, blocks, stream);
}

extern "C" int cmi_temperature_f32(const float* tables, const float* omega,
                                   const float* T_init, const float* j, const float* h,
                                   const float* nd, float* T, float* h0, float* he0,
                                   float* metals, int32_t* sweeps, unsigned* next_cell,
                                   int n, int max_iterations, int table_size, int lanes,
                                   int blocks, void* stream) {
  return launch<float>(tables, omega, T_init, j, h, nd, T, h0, he0, metals, sweeps,
                       next_cell, n, max_iterations, table_size, lanes, blocks, stream);
}

// The registers a thread of K4 (K4f), with one lane a cell (temperature3:
// three), takes and its blocks of kThreads resident on one SM of the
// current device, and that device's SM count; returns the CUDA error (0 on
// success).
extern "C" int cmi_temperature_occupancy(int* registers, int* blocks_per_sm, int* sms) {
  return cmi_occupancy::query(temperature_kernel<double, 1>, kThreads, registers,
                              blocks_per_sm, sms);
}

extern "C" int cmi_temperature_f32_occupancy(int* registers, int* blocks_per_sm, int* sms) {
  return cmi_occupancy::query(temperature_kernel<float, 1>, kThreads, registers,
                              blocks_per_sm, sms);
}

extern "C" int cmi_temperature3_occupancy(int* registers, int* blocks_per_sm, int* sms) {
  return cmi_occupancy::query(temperature_kernel<double, 3>, kThreads, registers,
                              blocks_per_sm, sms);
}

extern "C" int cmi_temperature3_f32_occupancy(int* registers, int* blocks_per_sm, int* sms) {
  return cmi_occupancy::query(temperature_kernel<float, 3>, kThreads, registers,
                              blocks_per_sm, sms);
}
