// K13h, K13e, K13w and K13f: the in-kernel deposit and DDA-step probes of
// tools/probe_deposit.py and tools/probe_deposit2.py.
//
// K13h replaces the shifted histogram that nine Pallas bodies compute in
// different layouts and reductions: probe_deposit.py's make.run with D2-D7,
// probe_deposit2.py's make.run with D8 and D8b (the 128 cells as [16, 8]) and
// probe_cohort_kernel.py's run_d.  out[c] = sum over packets t and steps
// i < nstep of dep[t] where (lidx[t] + i) mod 128 == c.  The TPU bodies build
// a one-hot [packets, 128] block per step and reduce it (by a sum, a deferred
// sum, an MXU dot or a factored 16 x 8 contraction) in one core's loop.  Here
// one launch does it all (redesigned; the first port took a memset, the
// kernel and a rounding kernel, and one shared-memory float atomicAdd per
// deposit, which on this card is a compare-and-swap loop):
//   * a block takes kHistThreads packets and a range of steps, a grid of at
//     most kHistBlocks blocks where the packets allow it;
//   * two lanes of a warp meet in a cell at step i exactly when their lidx
//     are equal mod 128, at every i, so a warp groups its lanes once
//     (__match_any_sync); each group's leader sums the group's weights in
//     lane order and, at each step, adds that sum into its cell (l + i) & 127
//     of the warp's own f32 bins with a plain shared load, add and store:
//     the leaders' cells are distinct at every step, and a __syncwarp of the
//     leaders between steps orders one leader's store before another's load
//     of the same cell at a later step;
//   * at the block's end the warps' bins are summed in f64 in warp order into
//     the block's own row of an f64 scratch; the block that takes the last
//     ticket sums the rows in block order (kHistParts contiguous runs of rows,
//     each in order, its rows read kHistBatch at a time, then the runs in
//     order), rounds each cell once to f32 and resets the ticket for the
//     next call.
// Every (packet, step) deposit is made: the kernel does not use that a packet
// visits each cell nstep / 128 times.  The order of every addition is fixed,
// so two calls on the same inputs agree bit for bit; the warps' f32 bins take
// at most a block's steps / 128 additions of a group sum a cell, so random
// weights sum within ~1e-7 of the exact sum and integer weights exactly.

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

#include <algorithm>

namespace {

constexpr int kCells = 128;
constexpr int kThreads = 256;
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kHistThreads = 1024;  // packets a block of K13h
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistBlocks = 128;   // the most blocks that split the steps
constexpr int kHistMinSteps = 32;  // the fewest steps a block's range holds
constexpr int kHistParts = 8;      // runs of rows the last block sums apart
constexpr int kHistBatch = 16;     // rows of a run the last block reads at once
static_assert(kHistThreads >= kHistParts * kCells, "the last block sums its parts in one pass");

// The grid of K13h for n packets and nstep steps: blockIdx.x a range of
// kHistThreads packets, blockIdx.y a range of `steps` steps; at least one
// block, so that n = 0 or nstep = 0 still writes zeros.
struct HistogramGrid {
  int packet_blocks, step_blocks, steps;
};

HistogramGrid histogram_grid(int n, int nstep) {
  const int packet_blocks = n > 0 ? (n + kHistThreads - 1) / kHistThreads : 1;
  int step_blocks = kHistBlocks / packet_blocks;
  step_blocks = std::min(step_blocks, (nstep + kHistMinSteps - 1) / kHistMinSteps);
  step_blocks = std::max(step_blocks, 1);
  return {packet_blocks, step_blocks, (nstep + step_blocks - 1) / step_blocks};
}

__global__ void __launch_bounds__(kHistThreads) shifted_histogram_kernel(
    const float* __restrict__ dep, const int* __restrict__ lidx, double* __restrict__ rows,
    unsigned* __restrict__ ticket, float* __restrict__ out, int n, int nstep, int steps) {
  __shared__ float bins[kHistWarps][kCells];
  __shared__ float weights[kHistThreads];
  __shared__ double parts[kHistParts][kCells];
  __shared__ bool last_block;
  for (int k = threadIdx.x; k < kHistWarps * kCells; k += kHistThreads) (&bins[0][0])[k] = 0.0f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kHistThreads + threadIdx.x;
  const bool holds = t < n;
  const float d = holds ? __ldg(dep + t) : 0.0f;
  const int l = holds ? __ldg(lidx + t) & (kCells - 1) : 0;
  weights[threadIdx.x] = d;
  __syncthreads();
  const unsigned holding = __ballot_sync(kAllLanes, holds);
  if (holds) {
    const unsigned group = __match_any_sync(holding, l);
    const bool leads = lane == __ffs(group) - 1;
    const unsigned leaders = __ballot_sync(holding, leads);
    if (leads) {
      float sum = 0.0f;  // the group's weights in lane order
      for (unsigned m = group; m != 0u; m &= m - 1u) sum += weights[warp * 32 + __ffs(m) - 1];
      float* own = bins[warp];
      const int first = blockIdx.y * steps;
      const int last = min(first + steps, nstep);
      for (int i = first; i < last; ++i) {
        const int c = (l + i) & (kCells - 1);
        own[c] = own[c] + sum;
        __syncwarp(leaders);
      }
    }
  }
  __syncthreads();
  const int blocks = gridDim.x * gridDim.y;
  if (threadIdx.x < kCells) {
    double s = 0.0;
    for (int w = 0; w < kHistWarps; ++w) s += static_cast<double>(bins[w][threadIdx.x]);
    rows[static_cast<size_t>(blockIdx.y * gridDim.x + blockIdx.x) * kCells + threadIdx.x] = s;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last_block = atomicAdd(ticket, 1u) == static_cast<unsigned>(blocks - 1);
  __syncthreads();
  if (!last_block) return;
  // the last block: each of kHistParts threads a cell sums one run of rows in
  // block order (kHistBatch rows read at once, then added in order), then
  // thread c sums the runs in order and rounds once
  const int cell = threadIdx.x & (kCells - 1), part = threadIdx.x / kCells;
  if (part < kHistParts) {
    const int per_part = (blocks + kHistParts - 1) / kHistParts;
    const int first = part * per_part, last = min(first + per_part, blocks);
    double s = 0.0;
    for (int r0 = first; r0 < last; r0 += kHistBatch) {
      double row[kHistBatch];
#pragma unroll
      for (int k = 0; k < kHistBatch; ++k) {
        row[k] = r0 + k < last ? __ldcg(rows + static_cast<size_t>(r0 + k) * kCells + cell) : 0.0;
      }
#pragma unroll
      for (int k = 0; k < kHistBatch; ++k) {
        if (r0 + k < last) s += row[k];
      }
    }
    parts[part][cell] = s;
  }
  __syncthreads();
  if (threadIdx.x < kCells) {
    double s = 0.0;
    for (int p = 0; p < kHistParts; ++p) s += parts[p][threadIdx.x];
    out[threadIdx.x] = static_cast<float>(s);
  }
  if (threadIdx.x == 0) *ticket = 0u;
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

// Launches K13h on `stream`: out[0, 128) = the sums over t < n and i < nstep
// of dep[t] at cell (lidx[t] + i) & 127.  rows: capacity f64 rows of 128
// scratch, at least one a block of the grid (kernels/probe_deposit.py:
// histogram_scratch sizes it); ticket: one unsigned, 0 before the launch and
// 0 after it.
// Returns cudaErrorInvalidValue where the scratch is too small, else
// cudaGetLastError() (0 on success).
extern "C" int cmi_shifted_histogram(const float* dep, const int* lidx, float* out,
                                     double* rows, unsigned* ticket, int n, int nstep,
                                     int capacity, void* stream) {
  const HistogramGrid g = histogram_grid(n, nstep);
  if (g.packet_blocks * g.step_blocks > capacity) return static_cast<int>(cudaErrorInvalidValue);
  shifted_histogram_kernel<<<dim3(g.packet_blocks, g.step_blocks), kHistThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(dep, lidx, rows, ticket, out, n,
                                                                  nstep, g.steps);
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
