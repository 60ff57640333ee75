// K9c and K9p: the stable compaction and the bucketed send partition of the
// packet exchange between the shards of a domain-decomposed run.
//
// Replaces cmacionize_tpu/parallel/domain.py:_compact (the packed-key sort
// ((~mask) << 31) | iota, its gather, truncation and zero padding) and the
// two _compact calls over the same fields that build the two send buffers of
// one exchange (domain.py:240-249, the frame shift of :246-247, and
// parallel/domain3d.py:_exchange_axis :69-75).  The plain PyTorch versions
// are cmacionize_torch/parallel/domain.py:compact_reference and
// partition_reference (a stable argsort and a gather).
//
// What it computes.  Each lane g < n carries a code: for K9c a bool mask
// (member of bucket 0 or not), for K9p an int8 bucket in {-1, 0, 1}.  For
// every bucket b, the output is the stable partition of the lanes by
// membership: the members in input order, then the other lanes in input
// order, truncated to capacity[b] and, where capacity[b] > n, padded with
// zeros.  Every lane of the output equals the sort's, not only the members.
// Beside it: in_range[b][j] = j < count[b], and overflow[b] = max(count[b] -
// capacity[b], 0).  K9p adds shift[b] to field 0 of bucket b, padding
// included, as one f32 add (the receiver's frame: px + nx_loc, px - nx_loc).
//
// Design (simple and right first): one lane per thread, 1024 per block.
//   1. compact_count_kernel: a warp ballot and popcount per warp, the warp totals
//      summed in shared memory: members per block and bucket;
//   2. compact_scan_kernel, one block: the exclusive scan of the block counts, the
//      totals and the overflow counts;
//   3. compact_scatter_kernel: the same ballot gives a lane's rank inside its warp,
//      a scan of the 32 warp totals in shared memory its rank inside the
//      block, the block's offset its global rank r among the members before
//      it.  A member goes to r, any other lane to count + (g - r); a lane
//      whose slot is below the capacity writes its fields there.  Threads
//      past n write the zero padding, and every thread below the capacity
//      writes its in_range flag.
// No atomics, so the result is deterministic.
//
// What bounds it on an H100: bytes.  Each lane reads its code twice and its
// fields once and writes each of its fields once per bucket it lands in; the
// three launches and the host's enqueue dominate below ~1e5 lanes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFields = 8;
constexpr int kMaxBuckets = 2;

struct Inputs {
  const float* field[kMaxFields];
};

struct Outputs {
  float* field[kMaxBuckets][kMaxFields];
  bool* in_range[kMaxBuckets];
  int capacity[kMaxBuckets];
  float shift[kMaxBuckets];
  int has_shift[kMaxBuckets];
};

// membership of lane g in bucket b: a bool mask (K9c) or an int8 code (K9p)
template <bool kMask>
__device__ __forceinline__ bool member(const int8_t* codes, int g, int n,
                                       int b) {
  if (g >= n) return false;
  const int8_t c = codes[g];
  return kMask ? (c != 0) : (c == b);
}

template <int kBuckets, bool kMask>
__global__ void compact_count_kernel(const int8_t* __restrict__ codes, int n,
                             int* __restrict__ block_counts, int n_blocks) {
  __shared__ int warp_total[kBuckets][kWarps];
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < kBuckets; ++b) {
    const unsigned ballot = __ballot_sync(0xffffffffu, member<kMask>(codes, g, n, b));
    if (lane == 0) warp_total[b][warp] = __popc(ballot);
  }
  __syncthreads();
  if (warp == 0) {
    for (int b = 0; b < kBuckets; ++b) {
      int v = warp_total[b][lane];
      for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
      if (lane == 0) block_counts[b * n_blocks + blockIdx.x] = v;
    }
  }
}

// inclusive scan of v over the 32 lanes of a warp
__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// One block: block_offsets[b][i] = sum of block_counts[b][< i]; totals[b];
// counts[b] = {total, max(total - capacity, 0)} as int64.
template <int kBuckets>
__global__ void compact_scan_kernel(const int* __restrict__ block_counts, int n_blocks,
                            int* __restrict__ block_offsets,
                            int* __restrict__ totals,
                            long long* __restrict__ counts, Outputs out) {
  __shared__ int warp_sum[kWarps];
  __shared__ int carry;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < kBuckets; ++b) {
    if (threadIdx.x == 0) carry = 0;
    __syncthreads();
    for (int base = 0; base < n_blocks; base += kThreads) {
      const int i = base + threadIdx.x;
      const int v = i < n_blocks ? block_counts[b * n_blocks + i] : 0;
      const int incl = warp_inclusive_scan(v, lane);
      if (lane == 31) warp_sum[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        const int s = warp_sum[lane];
        warp_sum[lane] = warp_inclusive_scan(s, lane) - s;  // exclusive
      }
      __syncthreads();
      const int before = carry + warp_sum[warp] + incl - v;
      if (i < n_blocks) block_offsets[b * n_blocks + i] = before;
      __syncthreads();
      if (threadIdx.x == kThreads - 1) carry = before + v;
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      totals[b] = carry;
      const long long over = static_cast<long long>(carry) - out.capacity[b];
      counts[2 * b] = carry;
      counts[2 * b + 1] = over > 0 ? over : 0;
    }
    __syncthreads();
  }
}

template <int kBuckets, bool kMask>
__global__ void compact_scatter_kernel(Inputs in, int n_fields,
                               const int8_t* __restrict__ codes, int n,
                               const int* __restrict__ block_offsets,
                               int n_blocks, const int* __restrict__ totals,
                               Outputs out) {
  __shared__ int warp_before[kBuckets][kWarps];
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  bool flag[kBuckets];
  int rank[kBuckets];
  for (int b = 0; b < kBuckets; ++b) {
    flag[b] = member<kMask>(codes, g, n, b);
    const unsigned ballot = __ballot_sync(0xffffffffu, flag[b]);
    rank[b] = __popc(ballot & below);
    if (lane == 0) warp_before[b][warp] = __popc(ballot);
  }
  __syncthreads();
  if (warp == 0) {
    for (int b = 0; b < kBuckets; ++b) {
      const int s = warp_before[b][lane];
      warp_before[b][lane] = warp_inclusive_scan(s, lane) - s;
    }
  }
  __syncthreads();
  for (int b = 0; b < kBuckets; ++b) {
    const int total = totals[b];
    const int cap = out.capacity[b];
    const float shift = out.shift[b];
    const bool shifted = out.has_shift[b] != 0;
    if (g < n) {
      // members before g, over the whole input
      const int r = block_offsets[b * n_blocks + blockIdx.x] + warp_before[b][warp] + rank[b];
      const int dest = flag[b] ? r : total + (g - r);
      if (dest < cap) {
        for (int f = 0; f < n_fields; ++f) {
          float v = in.field[f][g];
          if (f == 0 && shifted) v = __fadd_rn(v, shift);
          out.field[b][f][dest] = v;
        }
      }
    } else if (g < cap) {
      for (int f = 0; f < n_fields; ++f) {
        out.field[b][f][g] = (f == 0 && shifted) ? __fadd_rn(0.0f, shift) : 0.0f;
      }
    }
    if (g < cap) out.in_range[b][g] = g < total;
  }
}

template <int kBuckets, bool kMask>
int launch(const Inputs& in, int n_fields, const int8_t* codes, int n,
           const Outputs& out, int* scratch, long long* counts,
           cudaStream_t s) {
  const int n_blocks = (n + kThreads - 1) / kThreads;
  int* block_counts = scratch;
  int* block_offsets = scratch + kBuckets * n_blocks;
  int* totals = scratch + 2 * kBuckets * n_blocks;
  if (n_blocks > 0) {
    compact_count_kernel<kBuckets, kMask><<<n_blocks, kThreads, 0, s>>>(
        codes, n, block_counts, n_blocks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  compact_scan_kernel<kBuckets><<<1, kThreads, 0, s>>>(block_counts, n_blocks,
                                               block_offsets, totals, counts,
                                               out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int width = n;
  for (int b = 0; b < kBuckets; ++b) width = out.capacity[b] > width ? out.capacity[b] : width;
  const int grid = (width + kThreads - 1) / kThreads;
  if (grid > 0) {
    compact_scatter_kernel<kBuckets, kMask><<<grid, kThreads, 0, s>>>(
        in, n_fields, codes, n, block_offsets, n_blocks, totals, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// K9c (n_buckets = 1, codes a bool mask) and K9p (n_buckets = 2, codes int8
// buckets).  fields_in: n_fields pointers of n floats; fields_out: n_buckets
// rows of n_fields pointers (capacities[b] floats each); in_range: n_buckets
// pointers (capacities[b] bools).  scratch: 2 * n_buckets * ceil(n / 1024) +
// n_buckets int32, which the wrapper allocates; counts: n_buckets x {count,
// overflow}, int64.
extern "C" int cmi_compact(const void* const* fields_in, int n_fields,
                           const void* codes, int n, int n_buckets,
                           void* const* fields_out, void* const* in_range,
                           const int* capacities, const float* shifts,
                           const int* has_shift, void* scratch, void* counts,
                           void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields || n < 0 || n_buckets < 1 ||
      n_buckets > kMaxBuckets) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Inputs in = {};
  Outputs out = {};
  for (int f = 0; f < n_fields; ++f) in.field[f] = static_cast<const float*>(fields_in[f]);
  for (int b = 0; b < n_buckets; ++b) {
    for (int f = 0; f < n_fields; ++f) {
      out.field[b][f] = static_cast<float*>(fields_out[b * n_fields + f]);
    }
    out.in_range[b] = static_cast<bool*>(in_range[b]);
    out.capacity[b] = capacities[b];
    out.shift[b] = shifts[b];
    out.has_shift[b] = has_shift[b];
  }
  const int8_t* c = static_cast<const int8_t*>(codes);
  int* sc = static_cast<int*>(scratch);
  long long* cn = static_cast<long long*>(counts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_buckets == 1) return launch<1, true>(in, n_fields, c, n, out, sc, cn, s);
  return launch<2, false>(in, n_fields, c, n, out, sc, cn, s);
}
