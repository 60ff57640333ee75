// K13h, K13e, K13w and K13f: the in-kernel deposit and DDA-step probes of
// tools/probe_deposit.py and tools/probe_deposit2.py.
//
// K13h replaces the shifted histogram that nine Pallas bodies compute in
// different layouts and reductions: probe_deposit.py's make.run with D2-D7,
// probe_deposit2.py's make.run with D8 and D8b (the 128 cells as [16, 8]) and
// probe_cohort_kernel.py's run_d.  out[c] = sum over packets t and steps
// i < nstep of dep[t] where (lidx[t] + i) mod 128 == c.  The TPU bodies build
// a one-hot [packets, 128] block per step and reduce it (by a sum, a deferred
// sum, an MXU dot or a factored 16 x 8 contraction) in one core's loop; here a
// block takes a range of steps and of packets, each thread adds its packet's
// weight into the cell of each step in a 128-bin histogram in shared memory,
// and the block's bins are added atomically, in f64, into a scratch sum that
// the launcher zeroes on the stream and a last launch rounds once to f32.
// Every deposit is performed: the kernel does not use that a packet visits
// each cell nstep / 128 times.  What bounds it: one shared-memory atomic per
// deposit (the inputs are 8 bytes a packet).  The order of the additions is
// the atomics'; a block's f32 bins take 128 additions each and the f64 sum
// tens of thousands of partials without loss, so random weights sum within
// ~1e-7 of the exact sum and integer weights exactly.
//
// K13e replaces probe_deposit.py's make_e.run (e_kernel) and K13w
// probe_deposit2.py's make.run with w2_kernel: nstep loop-carried DDA steps
// per lane, the distances to the next integer planes recomputed each step
// (K13e) or stepped incrementally (Amanatides-Woo, K13w).  One thread per lane
// runs the whole loop in registers, so each is bound by its per-step
// dependent chain times nstep, not by bytes or the FP32 rate, at the probes'
// 1024 lanes.  K13e rounds the three position updates and the radicand
// 1 - dx^2 - dy^2 once (__fmaf_rn), as XLA fuses them on the CPU; everything
// else is one IEEE operation at a time (--fmad=false, IEEE division and
// square root), so both equal their plain versions bit for bit.
//
// K13e's step (redesigned): the first port's kernel took 612 cycles a step where its
// chain of floor, additions, a division, minima, the test, the select and
// an FMA models ~62.  An IEEE division (__fdiv_rn) is a reciprocal estimate,
// Newton and correction steps, a range test (FCHK) and a branch to a
// slow-path subroutine, which the test takes for a zero dividend: tau / chi
// with tau = 0, every step of a lane after its absorption.  And a branch a
// division keeps the step's divisions from overlapping.  So:
//   * the three wall distances divide by the loop-invariant sx, sy, sz: each
//     lane forms r = RN(1 / s) once and takes each quotient as q0 = a r,
//     e = fma(-s, q0, a), q = fma(e, r, q0), which Markstein's theorem makes
//     RN(a / s), the IEEE quotient bit for bit, for a = 0 and
//     2^-64 <= |a| <= 2 (an exact remainder and a normal quotient; the
//     divisors lie in 1e-12 <= |s| <= 1);
//   * tau / chi is tau itself where tau = 0 (chi > 0), so a step divides by
//     chi only where a lane is absorbed with tau > 0, once a lane;
//   * the steps run in blocks of kDdaBlockSteps without a division or a
//     branch, each step noting whether its quotients held (no numerator
//     below 2^-64, no absorption with tau > 0); a block where one did not is
//     run again from its start with IEEE divisions, so every step is the
//     body's bit for bit.  The chain of a step is floor, two additions, the
//     multiply and two FMAs, two minima, tau_cell, the test, the select and
//     the position FMA;
//   * blocks of kDdaThreads threads, one warp, spread the probe's 1024 lanes
//     over 32 SMs, so that no scheduler interleaves two warps' chains.
//
// K13f replaces probe_deposit2.py's make.run with d12_kernel: out[0, c] =
// dep[0] for the 128 cells (the TPU body checks a [16, 8] -> [1, 128] reshape
// of zeros + dep[0, 0]; XLA folds the addition of zero away, so a -0.0 stays
// -0.0, and K13f copies the bits).  Its 516 bytes take no time on the card:
// a call costs its host launch, so K13f's wrapper launches through the lean
// path of cmacionize_torch/kernels/launch.py.  The plain versions are
// cmacionize_torch/kernels/probe_deposit.py:*_reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCells = 128;
constexpr int kThreads = 256;
constexpr int kStepsPerBlock = 64;  // steps a block deposits; 122 step ranges at 7808

// blockIdx.x: a range of kThreads packets; blockIdx.y: a range of
// kStepsPerBlock steps.  Each thread deposits its packet's weight at each step
// of the range into the block's bins, which are then added into the f64 sum.
__global__ void __launch_bounds__(kThreads) shifted_histogram_kernel(
    const float* __restrict__ dep, const int* __restrict__ lidx, double* __restrict__ sum,
    int n, int nstep) {
  __shared__ float bins[kCells];
  if (threadIdx.x < kCells) bins[threadIdx.x] = 0.0f;
  __syncthreads();
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int first = blockIdx.y * kStepsPerBlock;
  const int last = min(first + kStepsPerBlock, nstep);
  if (t < n) {
    const float d = __ldg(dep + t);
    const int l = __ldg(lidx + t);
    for (int i = first; i < last; ++i) atomicAdd(bins + ((l + i) & (kCells - 1)), d);
  }
  __syncthreads();
  if (threadIdx.x < kCells) {
    atomicAdd(sum + threadIdx.x, static_cast<double>(bins[threadIdx.x]));
  }
}

__global__ void round_histogram_kernel(const double* __restrict__ sum, float* __restrict__ out) {
  out[threadIdx.x] = static_cast<float>(sum[threadIdx.x]);
}

constexpr int kDdaThreads = 32;
constexpr int kDdaBlockSteps = 32;  // steps between two checks of the fast form
// the least numerator whose quotient by a divisor in [1e-12, 1] the
// reciprocal form rounds as the IEEE division does (Markstein's theorem needs
// an exact remainder and a normal quotient)
constexpr float kLeastNumerator = 0x1p-64f;

// RN(a / s) from r = RN(1 / s) for a = 0 or kLeastNumerator <= |a| <= 2 and
// 1e-12 <= |s| <= 1: the product, its exact remainder and one correction
__device__ __forceinline__ float divide_by(float a, float s, float r) {
  const float q0 = a * r;
  const float e = __fmaf_rn(-s, q0, a);
  return __fmaf_rn(e, r, q0);
}

// One lane's DDA state, and e_kernel's step on it in two forms.
struct DdaLane {
  float px, py, pz, tau;

  // The step, every quotient the IEEE one: the wall distances in the
  // reciprocal form where their numerators allow it, else by __fdiv_rn, and
  // tau / chi by __fdiv_rn where tau != 0 (tau itself where tau = 0, as
  // chi > 0).
  __device__ __forceinline__ void exact_step(float dx, float dy, float dz, float sx, float sy,
                                             float sz, float rx, float ry, float rz) {
    const float nx = floorf(px) + 1.0f - px;
    const float ny = floorf(py) + 1.0f - py;
    const float nz = floorf(pz) + 1.0f - pz;
    float tx, ty, tz;
    if (fminf(nx, fminf(ny, nz)) >= kLeastNumerator) {
      tx = divide_by(nx, sx, rx);
      ty = divide_by(ny, sy, ry);
      tz = divide_by(nz, sz, rz);
    } else {
      tx = __fdiv_rn(nx, sx);
      ty = __fdiv_rn(ny, sy);
      tz = __fdiv_rn(nz, sz);
    }
    const float l_exit = fminf(fabsf(tx), fminf(fabsf(ty), fabsf(tz)));
    const float chi = fmaxf(px * 0.01f, 1e-30f);
    const float tau_cell = chi * l_exit;
    const bool absorbed = tau_cell >= tau;
    const float lt = absorbed ? (tau == 0.0f ? tau : __fdiv_rn(tau, chi)) : l_exit;
    px = __fmaf_rn(dx, lt, px);
    py = __fmaf_rn(dy, lt, py);
    pz = __fmaf_rn(dz, lt, pz);
    tau = absorbed ? 0.0f : tau - tau_cell;
  }

  // The same step without a division on its chain: the wall quotients in
  // the reciprocal form, and tau / chi taken as tau, which it is where
  // tau = 0 (chi > 0).  Returns whether that was the step's quotients: no
  // numerator below kLeastNumerator, and no absorption with tau > 0.
  __device__ __forceinline__ bool fast_step(float dx, float dy, float dz, float sx, float sy,
                                            float sz, float rx, float ry, float rz) {
    const float nx = floorf(px) + 1.0f - px;
    const float ny = floorf(py) + 1.0f - py;
    const float nz = floorf(pz) + 1.0f - pz;
    const float tx = divide_by(nx, sx, rx);
    const float ty = divide_by(ny, sy, ry);
    const float tz = divide_by(nz, sz, rz);
    const float l_exit = fminf(fabsf(tx), fminf(fabsf(ty), fabsf(tz)));
    const float chi = fmaxf(px * 0.01f, 1e-30f);
    const float tau_cell = chi * l_exit;
    const bool absorbed = tau_cell >= tau;
    const bool held = fminf(nx, fminf(ny, nz)) >= kLeastNumerator && !(absorbed && tau != 0.0f);
    const float lt = absorbed ? tau : l_exit;
    px = __fmaf_rn(dx, lt, px);
    py = __fmaf_rn(dy, lt, py);
    pz = __fmaf_rn(dz, lt, pz);
    tau = absorbed ? 0.0f : tau - tau_cell;
    return held;
  }
};

// one thread per lane: e_kernel's loop, the loop-invariant direction terms
// and their reciprocals formed once.  The steps run in blocks of
// kDdaBlockSteps in the fast form; a block in which it did not hold (a
// lane's one absorption with tau > 0, or a numerator within 2^-64 of 0) is
// run again from its start with IEEE divisions.
__global__ void __launch_bounds__(kDdaThreads) dda_math_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out, int n,
    int nstep) {
  const int lane = blockIdx.x * kDdaThreads + threadIdx.x;
  if (lane >= n) return;
  const float dx = __ldg(a + lane);
  const float dy = __ldg(b + lane);
  const float dz = __fsqrt_rn(fmaxf(__fmaf_rn(-dy, dy, __fmaf_rn(-dx, dx, 1.0f)), 0.0f));
  const float sx = fabsf(dx) > 1e-12f ? dx : 1e-12f;
  const float sy = fabsf(dy) > 1e-12f ? dy : 1e-12f;
  const float sz = fabsf(dz) > 1e-12f ? dz : 1e-12f;
  const float rx = __frcp_rn(sx), ry = __frcp_rn(sy), rz = __frcp_rn(sz);
  const float px = dx * 32.0f;
  DdaLane s{px, px + 1.0f, px + 2.0f, px * 9.0f};
  for (int i = 0; i < nstep; i += kDdaBlockSteps) {
    const int steps = min(kDdaBlockSteps, nstep - i);
    const DdaLane start = s;
    bool held = true;
    if (steps == kDdaBlockSteps) {
#pragma unroll
      for (int k = 0; k < kDdaBlockSteps; ++k) {
        held &= s.fast_step(dx, dy, dz, sx, sy, sz, rx, ry, rz);
      }
    } else {
      for (int k = 0; k < steps; ++k) held &= s.fast_step(dx, dy, dz, sx, sy, sz, rx, ry, rz);
    }
    if (!held) {
      s = start;
      for (int k = 0; k < steps; ++k) s.exact_step(dx, dy, dz, sx, sy, sz, rx, ry, rz);
    }
  }
  out[lane] = s.px + s.tau;
}

// one thread per lane: w2_kernel's loop
__global__ void __launch_bounds__(kThreads) dda_incremental_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out, int n,
    int nstep) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const float dx = __ldg(a + lane);
  const float dy = __ldg(b + lane);
  const float dz = __fsqrt_rn(fmaxf(1.0f - dx * dx - dy * dy, 1e-6f));
  const float td_x = fabsf(__fdiv_rn(1.0f, dx));
  const float td_y = fabsf(__fdiv_rn(1.0f, dy));
  const float td_z = fabsf(__fdiv_rn(1.0f, dz));
  float tmx = td_x;
  float tmy = td_y * 1.1f;
  float tmz = td_z * 1.2f;
  float tau = dx * 9.0f;
  float t_cur = 0.0f;
  for (int i = 0; i < nstep; ++i) {
    const float t_exit = fminf(tmx, fminf(tmy, tmz));
    const float chi = fmaxf(tmx * 0.01f, 1e-30f);
    const float tau_cell = chi * (t_exit - t_cur);
    const bool absorbed = tau_cell >= tau;
    const bool cx = t_exit == tmx;
    const bool cy = !cx && t_exit == tmy;
    if (cx) {
      tmx = tmx + td_x;
    } else if (cy) {
      tmy = tmy + td_y;
    } else {
      tmz = tmz + td_z;
    }
    tau = absorbed ? tau : tau - tau_cell;
    t_cur = t_exit;
  }
  out[lane] = tmx + tau;
}

__global__ void fill_first_kernel(const float* __restrict__ dep, float* __restrict__ out) {
  out[threadIdx.x] = __ldg(dep);
}

int blocks(int threads) { return (threads + kThreads - 1) / kThreads; }

}  // namespace

// Zeroes sum[0, 128) (f64 scratch), launches K13h on `stream` (sum[(lidx[t]
// + i) & 127] += dep[t] for t < n, i < nstep) and rounds sum into out[0,
// 128).  Returns the first CUDA error (0 on success).
extern "C" int cmi_shifted_histogram(const float* dep, const int* lidx, float* out, double* sum,
                                     int n, int nstep, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(sum, 0, kCells * sizeof(double), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  if (n > 0 && nstep > 0) {
    const dim3 grid(blocks(n), (nstep + kStepsPerBlock - 1) / kStepsPerBlock);
    shifted_histogram_kernel<<<grid, kThreads, 0, s>>>(dep, lidx, sum, n, nstep);
  }
  round_histogram_kernel<<<1, kCells, 0, s>>>(sum, out);
  return static_cast<int>(cudaGetLastError());
}

// Launches K13e on `stream`: out[lane] = px + tau after nstep steps of
// e_kernel for lane < n.  Returns cudaGetLastError() (0 on success).
extern "C" int cmi_dda_math(const float* a, const float* b, float* out, int n, int nstep,
                            void* stream) {
  if (n > 0) {
    dda_math_kernel<<<(n + kDdaThreads - 1) / kDdaThreads, kDdaThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a, b, out, n, nstep);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K13w on `stream`: out[lane] = tmx + tau after nstep steps of
// w2_kernel for lane < n.  Returns cudaGetLastError() (0 on success).
extern "C" int cmi_dda_incremental(const float* a, const float* b, float* out, int n,
                                   int nstep, void* stream) {
  if (n > 0) {
    dda_incremental_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        a, b, out, n, nstep);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K13f on `stream`: out[c] = dep[0] for c < 128.  Returns
// cudaGetLastError() (0 on success).
extern "C" int cmi_fill_first(const float* dep, float* out, void* stream) {
  fill_first_kernel<<<1, kCells, 0, static_cast<cudaStream_t>(stream)>>>(dep, out);
  return static_cast<int>(cudaGetLastError());
}
