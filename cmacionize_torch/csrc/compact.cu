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
// A member goes to its rank r among the members, any other lane g to
// count + (g - r): no lane but a member can be placed before the bucket's
// count is known.
//
// K9c (three launches, one lane per thread, 1024 per block):
//   1. compact_count_kernel: a warp ballot and popcount per warp, the warp totals
//      summed in shared memory: members per block and bucket;
//   2. compact_scan_kernel, one block: the exclusive scan of the block counts, the
//      totals and the overflow counts;
//   3. compact_scatter_kernel: the same ballot gives a lane's rank inside its warp,
//      a scan of the 32 warp totals in shared memory its rank inside the
//      block, the block's offset its global rank r among the members before
//      it.  A lane whose slot is below the capacity writes its fields there.
//      Threads past n write the zero padding, and every thread below the
//      capacity writes its in_range flag.
//
// K9p (one launch, partition_kernel): a persistent grid, no more blocks than
// the card holds at once (the wrapper passes that count from
// cmi_partition_occupancy), each block a run of consecutive tiles of 256
// lanes over max(n, capacities); small blocks, so that the lanes that land
// (a bucket's first capacity lanes, near the front) spread over every SM:
//   1. each warp counts its lanes' members per bucket in each tile (a
//      ballot, 1 B a lane) into the wrapper's scratch, and the block its
//      own;
//   2. a grid-wide barrier (an arrival counter and a generation word in the
//      same scratch, kept per device and stream; every block is resident,
//      so none waits on a block that is not running);
//   3. each block sums the block counts from L2: the buckets' totals (block
//      0 writes the counts) and the members before it;
//   4. each warp on its own, with no block barrier: per tile, the members of
//      the warps before it from the tile's warp counts (a shuffle scan), its
//      lanes' ranks from a ballot; a lane reads its fields once, and only
//      where it lands in some bucket, and writes them to each bucket it
//      lands in.
// No atomics on positions, so the result is deterministic.
//
// What bounds it on an H100: bytes.  Each lane reads its code and the lanes
// that land read their fields; each output is written once.  K9c's three
// launches and the host's enqueue dominate below ~1e5 lanes; K9p's launch,
// its barrier and its output allocation (one buffer, sliced into views by
// the wrapper) are what is left of that.

#include <cuda_runtime.h>

#include <cstdint>

#include "occupancy.cuh"

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

// ---------------------------------------------------------------- K9p

constexpr int kPartitionBuckets = 2;
constexpr int kTile = 256;  // lanes a tile; threads a block of partition_kernel
constexpr int kTileWarps = kTile / 32;

struct PartitionArgs {
  const float* field[kMaxFields];
  const int8_t* codes;
  float* out[kPartitionBuckets][kMaxFields];
  bool* in_range[kPartitionBuckets];
  long long* counts;             // {count, overflow} per bucket
  unsigned* barrier;             // {arrivals, generation}
  int* block_counts;             // [bucket][block]
  int* warp_counts;              // [bucket][tile * kTileWarps + warp]
  int n, n_fields, n_tiles, tiles_per_block;
  int capacity[kPartitionBuckets];
  int has_shift[kPartitionBuckets];
  float shift[kPartitionBuckets];
};

// Every block of the grid waits here until all have arrived.  The last to
// arrive resets the arrivals and moves the generation on; the others spin on
// the generation they saw before arriving.  Needs every block resident.
__device__ __forceinline__ void grid_barrier(unsigned* barrier) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* generation = barrier + 1;
    const unsigned seen = *generation;
    __threadfence();
    if (atomicAdd(barrier, 1u) == gridDim.x - 1) {
      atomicExch(barrier, 0u);
      __threadfence();
      atomicAdd(barrier + 1, 1u);
    } else {
      while (*generation == seen) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// the sums over the block of two ints that lane 0 of each warp holds (every
// thread gets them)
__device__ __forceinline__ void block_sum2(int& a, int& b) {
  __shared__ int part[kPartitionBuckets][kTileWarps];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
  }
  __syncthreads();
  a = 0;
  b = 0;
#pragma unroll
  for (int w = 0; w < kTileWarps; ++w) {
    a += part[0][w];
    b += part[1][w];
  }
  __syncthreads();
}

// the sums of two ints over the 32 lanes of a warp (every lane gets them)
__device__ __forceinline__ void warp_sum2(int& a, int& b) {
  for (int d = 16; d > 0; d >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, d);
    b += __shfl_xor_sync(0xffffffffu, b, d);
  }
}

__global__ void __launch_bounds__(kTile) partition_kernel(PartitionArgs a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int first = blockIdx.x * a.tiles_per_block;
  const int last = min(first + a.tiles_per_block, a.n_tiles);

  // 1. each warp's members per bucket in each of the block's tiles, and the
  //    block's
  int c0 = 0, c1 = 0;
  for (int t = first; t < last; ++t) {
    const int g = t * kTile + threadIdx.x;
    const int code = g < a.n ? a.codes[g] : -1;
    const int w0 = __popc(__ballot_sync(0xffffffffu, code == 0));
    const int w1 = __popc(__ballot_sync(0xffffffffu, code == 1));
    if (lane == 0) {
      a.warp_counts[t * kTileWarps + warp] = w0;
      a.warp_counts[(a.n_tiles + t) * kTileWarps + warp] = w1;
    }
    c0 += w0;
    c1 += w1;
  }
  block_sum2(c0, c1);
  if (threadIdx.x == 0) {
    a.block_counts[blockIdx.x] = c0;
    a.block_counts[gridDim.x + blockIdx.x] = c1;
  }
  grid_barrier(a.barrier);

  // 2. the buckets' totals and the members before this block, from L2: each
  //    thread sums its share of the block counts, then the warps and the block
  int total0 = 0, total1 = 0, before0 = 0, before1 = 0;
  for (int j = threadIdx.x; j < static_cast<int>(gridDim.x); j += kTile) {
    const int v0 = __ldcg(a.block_counts + j);
    const int v1 = __ldcg(a.block_counts + gridDim.x + j);
    total0 += v0;
    total1 += v1;
    if (j < static_cast<int>(blockIdx.x)) {
      before0 += v0;
      before1 += v1;
    }
  }
  warp_sum2(total0, total1);
  warp_sum2(before0, before1);
  block_sum2(total0, total1);
  block_sum2(before0, before1);
  if (blockIdx.x == 0 && threadIdx.x < kPartitionBuckets) {
    const int total = threadIdx.x == 0 ? total0 : total1;
    const long long over = static_cast<long long>(total) - a.capacity[threadIdx.x];
    a.counts[2 * threadIdx.x] = total;
    a.counts[2 * threadIdx.x + 1] = over > 0 ? over : 0;
  }

  // 3. each warp on its own: its lanes' ranks from the warp counts of their
  //    tile, then each lane's fields to the buckets it lands in
  const int total[kPartitionBuckets] = {total0, total1};
  int running[kPartitionBuckets] = {before0, before1};  // members before tile t
  for (int t = first; t < last; ++t) {
    const int g = t * kTile + threadIdx.x;
    const int code = g < a.n ? a.codes[g] : -1;
    int dest[kPartitionBuckets];
    bool lands = false;
#pragma unroll
    for (int b = 0; b < kPartitionBuckets; ++b) {
      // lanes 0-7 hold the tile's warp counts; an inclusive scan over them
      const int count = lane < kTileWarps
                            ? __ldcg(a.warp_counts + (b * a.n_tiles + t) * kTileWarps + lane)
                            : 0;
      int inclusive = count;
#pragma unroll
      for (int d = 1; d < kTileWarps; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, inclusive, d);
        if (lane >= d) inclusive += up;
      }
      const int warps_before = __shfl_sync(0xffffffffu, inclusive - count, warp);
      const int tile_total = __shfl_sync(0xffffffffu, inclusive, kTileWarps - 1);
      const bool flag = code == b;
      const int r = running[b] + warps_before +
                    __popc(__ballot_sync(0xffffffffu, flag) & below);  // members before g
      dest[b] = g >= a.n ? a.capacity[b] : flag ? r : total[b] + (g - r);
      lands |= dest[b] < a.capacity[b];
      running[b] += tile_total;
    }
    float v[kMaxFields] = {};
    if (lands) {
#pragma unroll
      for (int f = 0; f < kMaxFields; ++f) {
        if (f < a.n_fields) v[f] = a.field[f][g];
      }
    }
#pragma unroll
    for (int b = 0; b < kPartitionBuckets; ++b) {
      const int cap = a.capacity[b];
      if (g < a.n) {
        if (dest[b] < cap) {
#pragma unroll
          for (int f = 0; f < kMaxFields; ++f) {
            if (f < a.n_fields) {
              a.out[b][f][dest[b]] =
                  (f == 0 && a.has_shift[b]) ? __fadd_rn(v[f], a.shift[b]) : v[f];
            }
          }
        }
      } else if (g < cap) {  // the zero padding past the input
#pragma unroll
        for (int f = 0; f < kMaxFields; ++f) {
          if (f < a.n_fields) {
            a.out[b][f][g] = (f == 0 && a.has_shift[b]) ? __fadd_rn(0.0f, a.shift[b]) : 0.0f;
          }
        }
      }
      if (g < cap) a.in_range[b][g] = g < total[b];
    }
  }
}

}  // namespace

// K9c: codes a bool mask, n_buckets = 1.  fields_in: n_fields pointers of n
// floats; fields_out: n_buckets rows of n_fields pointers (capacities[b]
// floats each); in_range: n_buckets pointers (capacities[b] bools).
// scratch: 2 * n_buckets * ceil(n / 1024) + n_buckets int32, which the
// wrapper allocates; counts: n_buckets x {count, overflow}, int64.
extern "C" int cmi_compact(const void* const* fields_in, int n_fields,
                           const void* codes, int n, int n_buckets,
                           void* const* fields_out, void* const* in_range,
                           const int* capacities, const float* shifts,
                           const int* has_shift, void* scratch, void* counts,
                           void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields || n < 0 || n_buckets != 1) {
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
  return launch<1, true>(in, n_fields, static_cast<const int8_t*>(codes), n, out,
                         static_cast<int*>(scratch), static_cast<long long*>(counts),
                         static_cast<cudaStream_t>(stream));
}

// K9p in one launch.  f0..f7: the n_fields input fields of n floats (the rest
// null); codes: n int8 buckets in {-1, 0, 1}; out: one buffer of 32 B of
// counts (int64 {count, overflow} of bucket 0, then of bucket 1), then the
// fields, bucket 0's n_fields rows of cap0 floats and bucket 1's of cap1,
// then in_range, cap0 and cap1 bools.  scratch: 2 + 2 * max_blocks + 16 *
// ceil(max(n, cap0, cap1) / 256) int32, its first two zero at the first call
// on a stream and left so by every call; max_blocks: the blocks of
// partition_kernel the device holds at once (cmi_partition_occupancy).
extern "C" int cmi_partition(const float* f0, const float* f1, const float* f2,
                             const float* f3, const float* f4, const float* f5,
                             const float* f6, const float* f7, const int8_t* codes,
                             void* out, int* scratch, int n, int n_fields, int cap0,
                             int cap1, int has_shift0, int has_shift1, int max_blocks,
                             float shift0, float shift1, void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields || n < 0 || cap0 < 0 || cap1 < 0 ||
      max_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PartitionArgs a = {{f0, f1, f2, f3, f4, f5, f6, f7}};
  a.codes = codes;
  a.counts = static_cast<long long*>(out);
  float* fields = reinterpret_cast<float*>(static_cast<char*>(out) + 32);
  bool* flags = reinterpret_cast<bool*>(fields + static_cast<int64_t>(n_fields) * (cap0 + cap1));
  const int caps[kPartitionBuckets] = {cap0, cap1};
  for (int b = 0; b < kPartitionBuckets; ++b) {
    for (int f = 0; f < n_fields; ++f) {
      a.out[b][f] = fields + static_cast<int64_t>(f) * caps[b];
    }
    a.in_range[b] = flags;
    fields += static_cast<int64_t>(n_fields) * caps[b];
    flags += caps[b];
  }
  int width = n > cap0 ? n : cap0;
  width = width > cap1 ? width : cap1;
  a.n_tiles = (width + kTile - 1) / kTile;
  const int most = a.n_tiles < max_blocks ? a.n_tiles : max_blocks;
  a.tiles_per_block = most > 0 ? (a.n_tiles + most - 1) / most : 0;
  // no empty block; one block writes the counts of an empty call
  const int grid =
      a.tiles_per_block > 0 ? (a.n_tiles + a.tiles_per_block - 1) / a.tiles_per_block : 1;
  a.barrier = reinterpret_cast<unsigned*>(scratch);
  a.block_counts = scratch + 2;
  a.warp_counts = scratch + 2 + 2 * grid;
  a.n = n;
  a.n_fields = n_fields;
  a.capacity[0] = cap0;
  a.capacity[1] = cap1;
  a.has_shift[0] = has_shift0;
  a.has_shift[1] = has_shift1;
  a.shift[0] = shift0;
  a.shift[1] = shift1;
  partition_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The registers a thread of K9p's partition_kernel takes and its blocks of
// 256 resident on one SM of the current device, and that device's SM count;
// returns the CUDA error (0 on success).
extern "C" int cmi_partition_occupancy(int* registers, int* blocks_per_sm, int* sms) {
  return cmi_occupancy::query(partition_kernel, kTile, registers, blocks_per_sm, sms);
}
