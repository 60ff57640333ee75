// K14a, K14b and K14c: the mechanics probes of
// tools/probe_cohort_kernel.py for the cohort traversal.
//
// K14a replaces run_a: a sequential grid of one step per count, with the
// counts prefetched as scalars, that zeroes an [8, 128] block at step 0 and
// adds 1 to it at each step whose count is positive.  Blocks do not run in
// order on the card, so one block counts the positive entries
// (__syncthreads_count over a strided loop) and writes the count to every
// cell; bound by one read of the counts.
//
// K14b replaces run_b: 1000 steps of a lane gather, out[r, c] = sum over
// i < nsteps of tab[r, (idx[r, c] + i) mod 128], summed in the order of i from
// 0.0f as the Pallas loop sums.  One block per row holds its 128 floats in
// shared memory and one thread per column walks them; bound by the
// dependent chain of nsteps f32 additions per thread, not by bytes.
//
// K14c replaces run_c: 976 chunks of [8, 16, 128] f32 copied HBM -> VMEM ->
// HBM by DMA, one at a time, with row 2 of each [16, 128] item replaced by
// row 0 + row 1 and the scalar sum of row 0 * row 1.  Here each thread takes
// one 16-byte column of one item: it loads rows 0, 1 and 3-15 as float4
// (row 2 of the output does not read row 2), stores all 16, and adds its
// four products; the warps of a block reduce their sums in a fixed tree into
// one partial per block, and a second launch of one block sums the partials
// in a fixed order.  No float atomic, so repeated runs agree bit for bit.
// Bound by HBM: each byte is read once and written once.  The plain versions
// are cmacionize_torch/kernels/probe_cohort.py:*_reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;
constexpr int kRows = 16;                // rows of one [16, 128] item
constexpr int kColumns = kLanes / 4;     // float4 columns of a row
constexpr int kOutCells = 8 * kLanes;    // K14a's [8, 128]

__global__ void __launch_bounds__(kThreads) count_positive_kernel(
    const int* __restrict__ cnt, float* __restrict__ out, int n) {
  int total = 0;
  for (int first = 0; first < n; first += kThreads) {
    const int m = first + threadIdx.x;
    total += __syncthreads_count(m < n && __ldg(cnt + m) > 0);
  }
  const float value = static_cast<float>(total);
  for (int c = threadIdx.x; c < kOutCells; c += kThreads) out[c] = value;
}

__global__ void __launch_bounds__(kLanes) lane_gather_loop_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx, float* __restrict__ out,
    int nsteps) {
  __shared__ float row[kLanes];
  const long long cell = static_cast<long long>(blockIdx.x) * kLanes + threadIdx.x;
  row[threadIdx.x] = __ldg(tab + cell);
  __syncthreads();
  const int start = __ldg(idx + cell);
  float acc = 0.0f;
  for (int i = 0; i < nsteps; ++i) acc = acc + row[(start + i) & (kLanes - 1)];
  out[cell] = acc;
}

// the block's sum of `value` over its threads, in a fixed order; valid in
// thread 0
__device__ float block_sum(float value) {
  __shared__ float warp_sums[kWarps];
  for (int offset = 16; offset > 0; offset /= 2) {
    value = value + __shfl_down_sync(0xffffffffu, value, offset);
  }
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = value;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) total = total + warp_sums[w];
  }
  return total;
}

// thread g takes item g / kColumns, float4 column g % kColumns
__global__ void __launch_bounds__(kThreads) stream_rows_kernel(
    const float4* __restrict__ pk, float4* __restrict__ out, float* __restrict__ partials,
    int n_columns) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  float dot = 0.0f;
  if (g < n_columns) {
    const long long base =
        static_cast<long long>(g / kColumns) * kRows * kColumns + g % kColumns;
    const float4 x = __ldg(pk + base);
    const float4 y = __ldg(pk + base + kColumns);
    float4 rows[kRows - 3];
#pragma unroll
    for (int r = 3; r < kRows; ++r) rows[r - 3] = __ldg(pk + base + r * kColumns);
    out[base] = x;
    out[base + kColumns] = y;
    out[base + 2 * kColumns] = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
#pragma unroll
    for (int r = 3; r < kRows; ++r) out[base + r * kColumns] = rows[r - 3];
    dot = x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  const float total = block_sum(dot);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads) sum_partials_kernel(
    const float* __restrict__ partials, float* __restrict__ s, int n) {
  float value = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) value = value + partials[i];
  const float total = block_sum(value);
  if (threadIdx.x == 0) *s = total;
}

}  // namespace

// Launches K14a on `stream`: out[c] = #{m < n : cnt[m] > 0} for c < 1024.
// Returns cudaGetLastError() (0 on success).
extern "C" int cmi_count_positive(const int* cnt, float* out, int n, void* stream) {
  count_positive_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(cnt, out, n);
  return static_cast<int>(cudaGetLastError());
}

// Launches K14b on `stream` for `rows` rows of 128: out[r, c] = sum over
// i < nsteps of tab[r, (idx[r, c] + i) & 127].  Returns cudaGetLastError()
// (0 on success).
extern "C" int cmi_lane_gather_loop(const float* tab, const int* idx, float* out, int rows,
                                    int nsteps, void* stream) {
  if (rows > 0) {
    lane_gather_loop_kernel<<<rows, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        tab, idx, out, nsteps);
  }
  return static_cast<int>(cudaGetLastError());
}

// The number of partial sums K14c writes for `items` items of [16, 128]: the
// size of the scratch tensor its caller allocates.
extern "C" int cmi_stream_rows_partials(int items) {
  return (items * kColumns + kThreads - 1) / kThreads;
}

// Launches K14c on `stream` for `items` items of [16, 128] f32 (16-byte
// aligned): out = pk with row 2 of each item = row 0 + row 1, partials[b] =
// block b's sum of row 0 * row 1, then *s = the sum of the partials.  Returns
// cudaGetLastError() (0 on success).
extern "C" int cmi_stream_rows(const float* pk, float* out, float* partials, float* s,
                               int items, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = cmi_stream_rows_partials(items);
  if (n_blocks > 0) {
    stream_rows_kernel<<<n_blocks, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(pk), reinterpret_cast<float4*>(out), partials,
        items * kColumns);
  }
  sum_partials_kernel<<<1, kThreads, 0, st>>>(partials, s, n_blocks);
  return static_cast<int>(cudaGetLastError());
}
