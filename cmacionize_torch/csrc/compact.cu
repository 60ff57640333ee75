// K9c and K9p: the stable compaction and the bucketed send partition of the
// packet exchange between the shards of a domain-decomposed run.
//
// Replaces cmacionize_tpu/parallel/domain.py:_compact (the packed-key sort
// ((~mask) << 31) | iota, its gather, truncation and zero padding), the
// jnp.concatenate in front of it in the slab merge (domain.py:254-272) and in
// parallel/domain3d.py:_exchange_axis (:76-91), and the two _compact calls
// over the same fields that build the two send buffers of one exchange
// (domain.py:240-249, the frame shift of :246-247, domain3d.py:69-75).  The
// plain PyTorch versions are cmacionize_torch/parallel/domain.py:
// compact_reference and partition_reference (a stable argsort and a gather).
//
// What it computes.  The input is the concatenation of one to three segments
// (K9c: the copy phase's one; the slab merge's two received buffers; the 3D
// exchange's kept lanes and its two received buffers), read in place: it is
// never formed.  Each lane g < n of the concatenation carries a code: for K9c
// a bool mask (member of bucket 0 or not), for K9p an int8 bucket in {-1, 0,
// 1}.  For every bucket b, the output is the stable partition of the lanes by
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
// One templated body, exchange_kernel<buckets, mask>, in one launch: K9c is
// its one-bucket case over a bool mask, K9p its two-bucket case over int8
// codes.  A persistent grid, no more blocks than the card holds at once (the
// wrapper passes that count from the instance's *_occupancy query), each
// block a run of consecutive tiles of 256 lanes over max(n, capacities);
// small blocks, so that the lanes that land (a bucket's first capacity lanes,
// near the front) spread over every SM:
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
//      lands in.  (Loading K9c's fields with the codes, before the ranks,
//      since nearly all of its lanes land, took 6-7% longer at the slab
//      merge on an H100.)
// A lane finds its segment by two compares of its index with the segments'
// first lanes and reads from that segment's pointers, picked by selects over
// the kernel's parameters (no dynamic indexing, so no copy to local memory).
// No atomics on positions, so the result is deterministic.  Each call writes
// one output buffer: the counts, each bucket's fields as [n_fields, capacity]
// rows, then in_range.
//
// What bounds it on an H100: bytes.  Each lane reads its code and the lanes
// that land read their fields; each output is written once.  At the slab
// merge (1,062,500 lanes received, capacity 1e6, 8 fields) nearly every lane
// lands, so the fields of 1e6 lanes are read and written: 64 MB.  What is
// left above that is the launch, the barrier and the host's enqueue.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "occupancy.cuh"

namespace {

constexpr int kMaxFields = 8;
constexpr int kMaxSegments = 3;
constexpr int kSegmentWords = 2 + kMaxFields;  // a row of cmi_compact's segment table
constexpr int kTile = 256;  // lanes a tile; threads a block
constexpr int kTileWarps = kTile / 32;

struct Segment {
  const float* field[kMaxFields];
  const int8_t* codes;
  int start;  // its first lane in the concatenation; INT_MAX where it is absent
};

template <int kBuckets>
struct Args {
  Segment seg[kMaxSegments];
  float* out[kBuckets][kMaxFields];
  bool* in_range[kBuckets];
  long long* counts;  // {count, overflow} per bucket
  unsigned* barrier;  // {arrivals, generation}
  int* block_counts;  // [bucket][block]
  int* warp_counts;   // [bucket][tile * kTileWarps + warp]
  int n, n_fields, n_tiles, tiles_per_block;
  int capacity[kBuckets];
  int has_shift[kBuckets];
  float shift[kBuckets];
};

// membership of a lane's code in bucket b: a bool mask (K9c) or an int8
// bucket (K9p); kNone is the code of a lane past the input
template <bool kMask>
__device__ __forceinline__ bool member(int code, int b) {
  return kMask ? code != 0 : code == b;
}

// lane g < n of the concatenation: its code, its segment s and its index in
// that segment
template <int kBuckets>
__device__ __forceinline__ int lane_code(const Args<kBuckets>& a, int g, int& s, int& local) {
  s = (g >= a.seg[1].start) + (g >= a.seg[2].start);
  local = g - (s == 0 ? 0 : s == 1 ? a.seg[1].start : a.seg[2].start);
  const int8_t* codes = s == 0 ? a.seg[0].codes : s == 1 ? a.seg[1].codes : a.seg[2].codes;
  return codes[local];
}

// the fields of lane `local` of segment s
template <int kBuckets>
__device__ __forceinline__ void load_fields(const Args<kBuckets>& a, int s, int local,
                                            float (&v)[kMaxFields]) {
#pragma unroll
  for (int f = 0; f < kMaxFields; ++f) {
    if (f < a.n_fields) {
      const float* p = s == 0 ? a.seg[0].field[f] : s == 1 ? a.seg[1].field[f] : a.seg[2].field[f];
      v[f] = p[local];
    }
  }
}

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

// the sums over the block of the ints that lane 0 of each warp holds (every
// thread gets them)
template <int kBuckets>
__device__ __forceinline__ void block_sum(int (&v)[kBuckets]) {
  __shared__ int part[kBuckets][kTileWarps];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int b = 0; b < kBuckets; ++b) part[b][warp] = v[b];
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < kBuckets; ++b) {
    v[b] = 0;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) v[b] += part[b][w];
  }
  __syncthreads();
}

// the sums of ints over the 32 lanes of a warp (every lane gets them)
template <int kBuckets>
__device__ __forceinline__ void warp_sum(int (&v)[kBuckets]) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int b = 0; b < kBuckets; ++b) v[b] += __shfl_xor_sync(0xffffffffu, v[b], d);
  }
}

template <int kBuckets, bool kMask>
__global__ void __launch_bounds__(kTile) exchange_kernel(Args<kBuckets> a) {
  constexpr int kNone = kMask ? 0 : -1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int first = blockIdx.x * a.tiles_per_block;
  const int last = min(first + a.tiles_per_block, a.n_tiles);

  // 1. each warp's members per bucket in each of the block's tiles, and the
  //    block's
  int count[kBuckets] = {};
  for (int t = first; t < last; ++t) {
    const int g = t * kTile + threadIdx.x;
    int s = 0, local = 0;
    const int code = g < a.n ? lane_code(a, g, s, local) : kNone;
#pragma unroll
    for (int b = 0; b < kBuckets; ++b) {
      const int w = __popc(__ballot_sync(0xffffffffu, member<kMask>(code, b)));
      if (lane == 0) a.warp_counts[(b * a.n_tiles + t) * kTileWarps + warp] = w;
      count[b] += w;
    }
  }
  block_sum(count);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < kBuckets; ++b) a.block_counts[b * gridDim.x + blockIdx.x] = count[b];
  }
  grid_barrier(a.barrier);

  // 2. the buckets' totals and the members before this block, from L2: each
  //    thread sums its share of the block counts, then the warps and the block
  int total[kBuckets] = {}, running[kBuckets] = {};  // running: members before tile t
  for (int j = threadIdx.x; j < static_cast<int>(gridDim.x); j += kTile) {
#pragma unroll
    for (int b = 0; b < kBuckets; ++b) {
      const int v = __ldcg(a.block_counts + b * gridDim.x + j);
      total[b] += v;
      if (j < static_cast<int>(blockIdx.x)) running[b] += v;
    }
  }
  warp_sum(total);
  warp_sum(running);
  block_sum(total);
  block_sum(running);
  if (blockIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < kBuckets; ++b) {
      if (static_cast<int>(threadIdx.x) == b) {
        const long long over = static_cast<long long>(total[b]) - a.capacity[b];
        a.counts[2 * b] = total[b];
        a.counts[2 * b + 1] = over > 0 ? over : 0;
      }
    }
  }

  // 3. each warp on its own: its lanes' ranks from the warp counts of their
  //    tile, then each lane's fields to the buckets it lands in
  for (int t = first; t < last; ++t) {
    const int g = t * kTile + threadIdx.x;
    int s = 0, local = 0;
    const int code = g < a.n ? lane_code(a, g, s, local) : kNone;
    int dest[kBuckets];
    bool lands = false;
#pragma unroll
    for (int b = 0; b < kBuckets; ++b) {
      // lanes 0-7 hold the tile's warp counts; an inclusive scan over them
      const int count_w = lane < kTileWarps
                              ? __ldcg(a.warp_counts + (b * a.n_tiles + t) * kTileWarps + lane)
                              : 0;
      int inclusive = count_w;
#pragma unroll
      for (int d = 1; d < kTileWarps; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, inclusive, d);
        if (lane >= d) inclusive += up;
      }
      const int warps_before = __shfl_sync(0xffffffffu, inclusive - count_w, warp);
      const int tile_total = __shfl_sync(0xffffffffu, inclusive, kTileWarps - 1);
      const bool flag = member<kMask>(code, b);
      const int r = running[b] + warps_before +
                    __popc(__ballot_sync(0xffffffffu, flag) & below);  // members before g
      dest[b] = g >= a.n ? a.capacity[b] : flag ? r : total[b] + (g - r);
      lands |= dest[b] < a.capacity[b];
      running[b] += tile_total;
    }
    float v[kMaxFields] = {};
    if (lands) load_fields(a, s, local, v);  // lands implies g < n
#pragma unroll
    for (int b = 0; b < kBuckets; ++b) {
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

// The output buffer's layout: 16 B of counts a bucket, then each bucket's
// n_fields rows of capacity floats, then each bucket's capacity bools; the
// barrier and the counts in scratch.  Sizes the persistent grid from
// max_blocks and launches.
template <int kBuckets, bool kMask>
int launch(Args<kBuckets>& a, void* out, int* scratch, int max_blocks, cudaStream_t stream) {
  a.counts = static_cast<long long*>(out);
  float* fields = reinterpret_cast<float*>(static_cast<char*>(out) + 16 * kBuckets);
  int width = a.n;
  for (int b = 0; b < kBuckets; ++b) {
    for (int f = 0; f < a.n_fields; ++f) {
      a.out[b][f] = fields + static_cast<int64_t>(f) * a.capacity[b];
    }
    fields += static_cast<int64_t>(a.n_fields) * a.capacity[b];
    width = a.capacity[b] > width ? a.capacity[b] : width;
  }
  bool* flags = reinterpret_cast<bool*>(fields);
  for (int b = 0; b < kBuckets; ++b) {
    a.in_range[b] = flags;
    flags += a.capacity[b];
  }
  a.n_tiles = (width + kTile - 1) / kTile;
  const int most = a.n_tiles < max_blocks ? a.n_tiles : max_blocks;
  a.tiles_per_block = most > 0 ? (a.n_tiles + most - 1) / most : 0;
  // no empty block; one block writes the counts of an empty call
  const int grid =
      a.tiles_per_block > 0 ? (a.n_tiles + a.tiles_per_block - 1) / a.tiles_per_block : 1;
  a.barrier = reinterpret_cast<unsigned*>(scratch);
  a.block_counts = scratch + 2;
  a.warp_counts = scratch + 2 + kBuckets * grid;
  exchange_kernel<kBuckets, kMask><<<grid, kTile, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K9c in one launch.  segments: a HOST table of n_segments rows of
// kSegmentWords int64 (1-3 rows): the address of the segment's bool mask, its
// lanes, then the addresses of its n_fields f32 fields (the rest unread).
// out: one buffer of 16 B of counts (int64 {count, overflow}), the fields as
// n_fields rows of capacity floats, then in_range, capacity bools.  scratch:
// 2 + max_blocks + 8 * ceil(max(n, capacity) / 256) int32 (n the segments'
// lanes in all), its first two zero at the first call on a stream and left so
// by every call; max_blocks: the blocks of the instance the device holds at
// once (cmi_compact_occupancy).
extern "C" int cmi_compact(const long long* segments, void* out, int* scratch, int n_segments,
                           int n_fields, int capacity, int max_blocks, void* stream) {
  if (n_segments < 1 || n_segments > kMaxSegments || n_fields < 1 || n_fields > kMaxFields ||
      capacity < 0 || max_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args<1> a = {};
  long long n = 0;
  for (int s = 0; s < kMaxSegments; ++s) {
    if (s >= n_segments) {
      a.seg[s].start = INT_MAX;
      continue;
    }
    const long long* row = segments + s * kSegmentWords;
    if (row[1] < 0) return static_cast<int>(cudaErrorInvalidValue);
    a.seg[s].codes = reinterpret_cast<const int8_t*>(row[0]);
    a.seg[s].start = static_cast<int>(n);
    for (int f = 0; f < n_fields; ++f) {
      a.seg[s].field[f] = reinterpret_cast<const float*>(row[2 + f]);
    }
    n += row[1];
  }
  if (n > INT_MAX - kTile || capacity > INT_MAX - kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.n = static_cast<int>(n);
  a.n_fields = n_fields;
  a.capacity[0] = capacity;
  return launch<1, true>(a, out, scratch, max_blocks, static_cast<cudaStream_t>(stream));
}

// K9p in one launch.  f0..f7: the n_fields input fields of n floats (the rest
// null); codes: n int8 buckets in {-1, 0, 1}; out: one buffer of 32 B of
// counts (int64 {count, overflow} of bucket 0, then of bucket 1), then the
// fields, bucket 0's n_fields rows of cap0 floats and bucket 1's of cap1,
// then in_range, cap0 and cap1 bools.  scratch: 2 + 2 * max_blocks + 16 *
// ceil(max(n, cap0, cap1) / 256) int32, its first two zero at the first call
// on a stream and left so by every call; max_blocks: the blocks of the
// instance the device holds at once (cmi_partition_occupancy).
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
  Args<2> a = {};
  const float* fields[kMaxFields] = {f0, f1, f2, f3, f4, f5, f6, f7};
  for (int f = 0; f < kMaxFields; ++f) a.seg[0].field[f] = fields[f];
  a.seg[0].codes = codes;
  a.seg[1].start = a.seg[2].start = INT_MAX;
  a.n = n;
  a.n_fields = n_fields;
  a.capacity[0] = cap0;
  a.capacity[1] = cap1;
  a.has_shift[0] = has_shift0;
  a.has_shift[1] = has_shift1;
  a.shift[0] = shift0;
  a.shift[1] = shift1;
  return launch<2, false>(a, out, scratch, max_blocks, static_cast<cudaStream_t>(stream));
}

// The registers a thread of K9c's (one bucket, a mask) or K9p's (two
// buckets) exchange_kernel takes and its blocks of 256 resident on one SM of
// the current device, and that device's SM count; return the CUDA error (0
// on success).
extern "C" int cmi_compact_occupancy(int* registers, int* blocks_per_sm, int* sms) {
  return cmi_occupancy::query(exchange_kernel<1, true>, kTile, registers, blocks_per_sm, sms);
}

extern "C" int cmi_partition_occupancy(int* registers, int* blocks_per_sm, int* sms) {
  return cmi_occupancy::query(exchange_kernel<2, false>, kTile, registers, blocks_per_sm, sms);
}
