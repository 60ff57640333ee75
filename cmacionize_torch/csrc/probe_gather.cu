// K12t, K12r, K12s and K12a: the dynamic-indexing probes of
// tools/probe_pallas_gather.py: one thread per element, K12r one float4.
//
// K12t replaces b_taa_lanes.run (take_along_axis on lanes: out[t, 0] =
// blk[t, idx[t, 0]] from a VMEM-resident [8192, 128] block), K12r
// b_row_gather.run (out[t, :] = tab[idx[t], :] from a [4096, 64] table),
// K12s b_sublane_gather.run (per-lane row selection: out[s, l] =
// tab[idx[s, l], l] from a [2048, 128] table) and K12a b_scatter_add.run
// (out = 0, then out.flat[idx.flat] += val.flat into a [2048, 128] output).
// The fifth probe, b_flat_gather_2d.run (tab[hi, lo]), is K11r's function
// and launches K11r (csrc/gather.cu).  The plain versions are
// cmacionize_torch/kernels/probe_gather.py:*_reference; the gathers copy bits
// and equal them exactly, K12a's atomics add duplicates in another order.
//
// What bounds them on an H100: the indices and the outputs stream at HBM rate,
// and each lookup reads one 32-byte sector of a table that stays in L2 (K12r
// reads whole 256-byte rows as float4, 16 lanes to a row, so its reads and
// writes coalesce; at 2^20 lookups its 256 MB of output bound it).  At the
// probe's shapes (8192 lookups, 1024 for K12s) the work is
// well under a microsecond of bytes, so one launch is most of the time.  The
// indices are not checked: an index outside the table reads (or, for K12a,
// adds) outside it, and the wrapper's caller keeps them in range.
//
// On the device alone the bodies beat the one PyTorch call: at 2^20 lookups on
// an H100 80GB HBM3 (700 W), K12s takes 0.0093-0.0095 ms to torch.gather's
// 0.0102-0.0108 and K12t 0.0360-0.0365 ms to take_along_dim's 0.0488-0.0491
// (a CUDA graph of 50 calls, tools/launch_cost.py), so they stay one thread
// per element; what they lost at the probe's shapes was the host's launch
// path (kernels/launch.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kUnroll = 4;  // K12r's float4 in flight per lane

// one thread per row t: out[t] = blk[t * width + idx[t]]
__global__ void __launch_bounds__(kThreads) take_along_lanes_kernel(
    const float* __restrict__ blk, const int* __restrict__ idx, float* __restrict__ out,
    int rows, int width) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t < rows) out[t] = __ldg(blk + static_cast<long long>(t) * width + __ldg(idx + t));
}

// K12r's scalar path, for a width that is not a multiple of 4 or a table
// that is not 16-byte aligned: one warp per output row t, lane l copies
// columns l, l + 32, ... of tab[idx[t], :]
__global__ void __launch_bounds__(kThreads) row_gather_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx, float* __restrict__ out,
    int rows, int width) {
  const long long t = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  if (t >= rows) return;
  const float* src = tab + static_cast<long long>(__ldg(idx + t)) * width;
  float* dst = out + t * width;
  for (int w = threadIdx.x % kWarp; w < width; w += kWarp) dst[w] = __ldg(src + w);
}

// K12r's vector path: a warp takes `per_warp` (at most 32) consecutive
// output rows of `vecs` float4 each, as many as make kUnroll float4 a lane,
// so that a small call still spreads over the card; lane l reads idx of row
// l once and the warp shares the indices by __shfl_sync.  The warp copies its
// rows' float4 as one flat run, kUnroll loads issued before their stores,
// which stream past L1 and L2 (__stcs): nothing re-reads the output in the
// call.  At width 64 that is 8 rows a warp, 16 lanes to a row.
__global__ void __launch_bounds__(kThreads) row_gather_vec_kernel(
    const float4* __restrict__ tab, const int* __restrict__ idx, float4* __restrict__ out,
    int rows, int vecs, int per_warp) {
  const long long first = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) /
                          kWarp * per_warp;
  if (first >= rows) return;  // the whole warp
  const int lane = threadIdx.x % kWarp;
  const int n_rows = static_cast<int>(min(static_cast<long long>(per_warp), rows - first));
  const int mine = lane < n_rows ? __ldg(idx + first + lane) : 0;
  const int n = n_rows * vecs;  // float4 of the warp's rows
  float4* dst = out + first * vecs;
  for (int e0 = 0; e0 < n; e0 += kWarp * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kWarp + lane;
      const int r = e / vecs;  // the row of the run
      const int row = __shfl_sync(0xffffffffu, mine, r % kWarp);
      if (e < n) v[u] = __ldg(tab + static_cast<long long>(row) * vecs + (e - r * vecs));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kWarp + lane;
      if (e < n) __stcs(dst + e, v[u]);
    }
  }
}

// one thread per output element i = s * width + l: out[i] = tab[idx[i], l]
__global__ void __launch_bounds__(kThreads) sublane_gather_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx, float* __restrict__ out,
    int n, int width) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = __ldg(tab + static_cast<long long>(__ldg(idx + i)) * width + i % width);
}

// one thread per input element: out[idx[i]] += val[i]
__global__ void __launch_bounds__(kThreads) scatter_add_kernel(
    const int* __restrict__ idx, const float* __restrict__ val, float* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) atomicAdd(out + __ldg(idx + i), __ldg(val + i));
}

int blocks(long long threads) { return static_cast<int>((threads + kThreads - 1) / kThreads); }

}  // namespace

// Launches K12t on `stream`: out[t] = blk[t * width + idx[t]] for t < rows.
// Returns cudaGetLastError() (0 on success).
extern "C" int cmi_take_along_lanes(const float* blk, const int* idx, float* out, int rows,
                                    int width, void* stream) {
  if (rows > 0) {
    take_along_lanes_kernel<<<blocks(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        blk, idx, out, rows, width);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K12r on `stream`: out[t * width + w] = tab[idx[t] * width + w] for
// t < rows, w < width; as float4 where width % 4 == 0 and tab and out are
// 16-byte aligned, else one float at a time.  Returns cudaGetLastError() (0 on
// success).
extern "C" int cmi_row_gather(const float* tab, const int* idx, float* out, int rows, int width,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vector = width % 4 == 0 && reinterpret_cast<uintptr_t>(tab) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (rows > 0 && width > 0 && vector) {
    const int vecs = width / 4;
    const int fill = kWarp * kUnroll / vecs;  // rows that make kUnroll float4 a lane
    const int per_warp = fill < 1 ? 1 : fill > kWarp ? kWarp : fill;
    const long long warps = (static_cast<long long>(rows) + per_warp - 1) / per_warp;
    row_gather_vec_kernel<<<blocks(warps * kWarp), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(tab), idx, reinterpret_cast<float4*>(out), rows, vecs,
        per_warp);
  } else if (rows > 0 && width > 0) {
    row_gather_kernel<<<blocks(static_cast<long long>(rows) * kWarp), kThreads, 0, s>>>(
        tab, idx, out, rows, width);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K12s on `stream`: out[i] = tab[idx[i] * width + i % width] for
// i < n.  Returns cudaGetLastError() (0 on success).
extern "C" int cmi_sublane_gather(const float* tab, const int* idx, float* out, int n, int width,
                                  void* stream) {
  if (n > 0) {
    sublane_gather_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        tab, idx, out, n, width);
  }
  return static_cast<int>(cudaGetLastError());
}

// Zeroes out[0, n_out) and launches K12a on `stream`: out[idx[i]] += val[i]
// for i < n.  Returns the first CUDA error (0 on success).
extern "C" int cmi_scatter_add(const int* idx, const float* val, float* out, int n, int n_out,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(out, 0, static_cast<size_t>(n_out) * sizeof(float), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  if (n > 0) scatter_add_kernel<<<blocks(n), kThreads, 0, s>>>(idx, val, out, n);
  return static_cast<int>(cudaGetLastError());
}
