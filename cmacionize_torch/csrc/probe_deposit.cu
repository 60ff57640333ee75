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
// dependent chain (K13e: floor, two additions, an IEEE division, the minima,
// the absorption test and an FMA) times nstep, not by bytes or the FP32
// rate, at the probes' 1024 lanes.  K13e rounds the three position updates
// and the radicand 1 - dx^2 - dy^2 once (__fmaf_rn), as XLA fuses them on the
// CPU; everything else is one IEEE operation at a time (--fmad=false, IEEE
// division and square root), so both equal their plain versions bit for bit.
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

// one thread per lane: e_kernel's loop, the loop-invariant direction terms
// formed once
__global__ void __launch_bounds__(kThreads) dda_math_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out, int n,
    int nstep) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const float dx = __ldg(a + lane);
  const float dy = __ldg(b + lane);
  const float dz = __fsqrt_rn(fmaxf(__fmaf_rn(-dy, dy, __fmaf_rn(-dx, dx, 1.0f)), 0.0f));
  const float sx = fabsf(dx) > 1e-12f ? dx : 1e-12f;
  const float sy = fabsf(dy) > 1e-12f ? dy : 1e-12f;
  const float sz = fabsf(dz) > 1e-12f ? dz : 1e-12f;
  float px = dx * 32.0f;
  float py = px + 1.0f;
  float pz = px + 2.0f;
  float tau = px * 9.0f;
  for (int i = 0; i < nstep; ++i) {
    const float tx = __fdiv_rn(floorf(px) + 1.0f - px, sx);
    const float ty = __fdiv_rn(floorf(py) + 1.0f - py, sy);
    const float tz = __fdiv_rn(floorf(pz) + 1.0f - pz, sz);
    const float l_exit = fminf(fabsf(tx), fminf(fabsf(ty), fabsf(tz)));
    const float chi = fmaxf(px * 0.01f, 1e-30f);
    const float tau_cell = chi * l_exit;
    const bool absorbed = tau_cell >= tau;
    const float lt = absorbed ? __fdiv_rn(tau, chi) : l_exit;
    px = __fmaf_rn(dx, lt, px);
    py = __fmaf_rn(dy, lt, py);
    pz = __fmaf_rn(dz, lt, pz);
    tau = absorbed ? 0.0f : tau - tau_cell;
  }
  out[lane] = px + tau;
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
    dda_math_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, out, n,
                                                                                 nstep);
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
