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
// row 0 + row 1 and the scalar sum of row 0 * row 1.  Bound by HBM: each
// byte is read once and written once (row 2 of the input is not read).  Here
// the DMA is Hopper's bulk asynchronous copy: chunks of four items (32 KB)
// move through a ring of six shared-memory buffers, one thread issuing the
// cp.async.bulk loads of rows 0-1 and 3-15 of each item, which complete on
// the buffer's mbarrier with their byte count, and, once the block has formed
// row 2 in shared memory, the chunk's cp.async.bulk store; the loads of the
// next five chunks and the store of the last are in flight while the block
// works on one.  132 blocks of 128 threads, one on each SM, are one wave; the
// chunks are handed out by an atomic counter, so that no block is left with a
// tail.  The scalar is summed in the same launch and a fixed order: each
// chunk's products reduce in a fixed tree into the chunk's partial, and the
// last block to take a ticket (an integer atomic after a __threadfence) sums
// the partials in chunk order.  No float atomic, and which block took a chunk
// changes nothing, so repeated runs agree bit for bit on any card.  The
// launcher zeroes the two counters with a cudaMemsetAsync on the stream.
//
// On an H100 80GB HBM3 (700 W) the kernel alone is as fast as pk.clone(), a
// device-to-device copy of the same bytes; a call takes a little longer for
// the counters' memset (tools/launch_cost.py, PERF.md).  The plain versions are
// cmacionize_torch/kernels/probe_cohort.py:*_reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int kRows = 16;                // rows of one [16, 128] item
constexpr int kColumns = kLanes / 4;     // float4 columns of a row
constexpr int kItem = kRows * kColumns;  // float4 of one item
constexpr int kItemBytes = kItem * 16;   // 8 KB
constexpr int kRowBytes = kColumns * 16;  // 512 B
constexpr int kOutCells = 8 * kLanes;    // K14a's [8, 128]
// K14c: a block of kStreamThreads threads (one per float4 column of the
// chunk's row 0) streams chunks of kChunk items through a ring of kStages
// buffers (192 KB of shared memory, one block on an SM); at most
// kStreamBlocks blocks, one per SM of an H100, one wave
constexpr int kChunk = 4;
constexpr int kStages = 6;
constexpr int kStreamThreads = kChunk * kColumns;
constexpr int kStreamBlocks = 132;
constexpr int kRingBytes = kStages * kChunk * kItemBytes;
constexpr int kFinalLoads = 16;  // partials in flight per thread of the last block

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

// the block's sum of `value` over its kBlockThreads threads, in a fixed order;
// valid in thread 0
template <int kBlockThreads>
__device__ float block_sum(float value) {
  constexpr int kWarps = kBlockThreads / 32;
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

// Bulk asynchronous copies (TMA without a tensor map) and the mbarriers they
// complete on, as PTX.
__device__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(shared_address(bar)) : "memory");
}

// this thread's arrival on `bar`, whose phase then also waits for `bytes`
__device__ void arm(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(shared_address(bar)), "r"(bytes) : "memory");
}

// global -> shared, `bytes` (a multiple of 16), completing on `bar`
__device__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(shared_address(dst)), "l"(src), "r"(bytes), "r"(shared_address(bar)) : "memory");
}

__device__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = shared_address(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  }
}

// shared -> global, `bytes` (a multiple of 16), as one bulk group
__device__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(shared_address(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the phase of `bar` completes with no bytes: a chunk that is not coming
__device__ void barrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(shared_address(bar)) : "memory");
}

// K14c: the chunks of kChunk items are handed out in turn by an atomic
// counter (each block's first kStages fixed), so a block that gets less of
// the memory's rate takes fewer of them and none is left with a long tail.
// Thread 0 takes a chunk for each buffer of the ring and loads it; the block
// waits for its buffer, forms row 2 of each item there and reduces row 0 *
// row 1 into the chunk's partial sum (warp trees, then the warps in order),
// and thread 0 stores the chunk and, once the store before it has read its
// buffer, takes and loads that buffer's next chunk.  A chunk past the end
// completes the buffer's phase with no bytes, which ends the block.  The
// partials are kept per chunk, not per block, so which block took a chunk
// does not change the sum; the last block to take a ticket sums them in
// chunk order.
__global__ void __launch_bounds__(kStreamThreads, 1) stream_rows_kernel(
    const float4* __restrict__ pk, float4* __restrict__ out, float* __restrict__ partials,
    unsigned* __restrict__ counters, float* __restrict__ s, int items) {
  extern __shared__ __align__(128) float4 ring[];
  __shared__ uint64_t full[kStages];
  __shared__ int chunk_of[kStages];                   // the chunk in each buffer, or -1
  __shared__ float warp_sums[2][kStreamThreads / 32];  // by the parity of the turn
  __shared__ bool last;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int chunks = (items + kChunk - 1) / kChunk;
  unsigned* next = counters;       // the next chunk to hand out
  unsigned* ticket = counters + 1;  // blocks done
  auto size = [&](int c) { return min(kChunk, items - c * kChunk); };  // items of chunk c
  // thread 0: buffer `stage` takes chunk c and loads it, or ends
  auto take = [&](int stage, int c) {
    if (c < chunks) {
      chunk_of[stage] = c;
      // rows 0-1 and 3-15 of each item: row 2 of the output does not read
      // row 2, so it is not loaded
      float4* buf = ring + stage * kChunk * kItem;
      const float4* src = pk + static_cast<long long>(c) * kChunk * kItem;
      arm(&full[stage], size(c) * (kItemBytes - kRowBytes));
      for (int i = 0; i < size(c); ++i) {
        bulk_load(buf + i * kItem, src + i * kItem, 2 * kRowBytes, &full[stage]);
        bulk_load(buf + i * kItem + 3 * kColumns, src + i * kItem + 3 * kColumns,
                  (kRows - 3) * kRowBytes, &full[stage]);
      }
    } else {
      chunk_of[stage] = -1;
      barrier_arrive(&full[stage]);
    }
  };

  // the first turns' chunks are fixed (block b takes b, b + n, ...), the
  // later ones handed out in turn by the counter
  const int fixed = kStages * gridDim.x;
  if (t == 0) {
    for (int stage = 0; stage < kStages; ++stage) barrier_init(&full[stage]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int stage = 0; stage < kStages; ++stage) take(stage, blockIdx.x + stage * gridDim.x);
  }
  __syncthreads();
  for (int k = 0;; ++k) {  // turn k takes buffer k % kStages
    const int stage = k % kStages;
    barrier_wait(&full[stage], (k / kStages) & 1);
    const int c = chunk_of[stage];
    if (c < 0) break;
    float4* buf = ring + stage * kChunk * kItem;
    float dot = 0.0f;
    if (t < size(c) * kColumns) {  // item t / kColumns, float4 column t % kColumns
      float4* row = buf + (t / kColumns) * kItem + t % kColumns;
      const float4 x = row[0], y = row[kColumns];
      row[2 * kColumns] = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
      dot = x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    }
    for (int offset = 16; offset > 0; offset /= 2) {
      dot = dot + __shfl_down_sync(0xffffffffu, dot, offset);
    }
    if (lane == 0) warp_sums[k & 1][warp] = dot;
    // row 2 written by this proxy must be seen by the bulk store's
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (t == 0) {
      float partial = 0.0f;
      for (int w = 0; w < kStreamThreads / 32; ++w) partial = partial + warp_sums[k & 1][w];
      partials[c] = partial;
      bulk_store(out + static_cast<long long>(c) * kChunk * kItem, buf, size(c) * kItemBytes);
      // the buffer of turn k - 1 takes its next chunk once its store (all
      // but the newest bulk group) has read it
      if (k >= 1) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        take((k - 1) % kStages, fixed + static_cast<int>(atomicAdd(next, 1u)));
      }
    }
  }
  if (t == 0) {
    // the stores must have read the ring before the block leaves; their
    // writes are the kernel's and complete with it
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {  // every partial is written: sum them in index order
    __threadfence();
    float value = 0.0f;
    for (int base = t; base < chunks; base += kFinalLoads * kStreamThreads) {
      float v[kFinalLoads];  // loads issued together, added in order
#pragma unroll
      for (int u = 0; u < kFinalLoads; ++u) {
        const int i = base + u * kStreamThreads;
        v[u] = i < chunks ? __ldcg(partials + i) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kFinalLoads; ++u) value = value + v[u];
    }
    const float sum = block_sum<kStreamThreads>(value);
    if (t == 0) *s = sum;
  }
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

// Launches K14c on `stream` for `items` items of [16, 128] f32 (16-byte
// aligned): out = pk with row 2 of each item = row 0 + row 1, and *s = the
// sum of row 0 * row 1.  `scratch` holds ceil(items / 4) floats (the chunks'
// partial sums) and two 32-bit counters after them (the next chunk, the
// blocks done), which are zeroed here.  Returns the first CUDA error (0 on
// success).
extern "C" int cmi_stream_rows(const float* pk, float* out, float* scratch, float* s, int items,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (items <= 0) return static_cast<int>(cudaMemsetAsync(s, 0, sizeof(float), st));
  // the ring is past the 48 KB of shared memory a block gets unasked; once
  // per device (the launcher runs with the tensors' device current)
  static unsigned long long configured = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device < 64 && !(configured >> device & 1ull)) {
    err = cudaFuncSetAttribute(stream_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRingBytes);
    if (err == cudaSuccess) configured |= 1ull << device;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (items + kChunk - 1) / kChunk;
  unsigned* counters = reinterpret_cast<unsigned*>(scratch + chunks);
  err = cudaMemsetAsync(counters, 0, 2 * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_rows_kernel<<<chunks < kStreamBlocks ? chunks : kStreamBlocks, kStreamThreads,
                       kRingBytes, st>>>(reinterpret_cast<const float4*>(pk),
                                         reinterpret_cast<float4*>(out), scratch, counters, s,
                                         items);
  return static_cast<int>(cudaGetLastError());
}
