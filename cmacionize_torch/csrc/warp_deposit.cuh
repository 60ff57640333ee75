// The run-summed warp deposit of the packet marches K5 (trace_octree.cu) and
// K6 (trace_voronoi.cu).
//
// Lanes of a warp that march neighbouring rays (K5 sorts its packets by
// direction) often deposit into one cell in the same step, and every packet
// of a point source deposits into the source's cell on its first step.  One
// atomicAdd per lane would then queue up at one address; here each run of
// consecutive lanes with one cell adds the sum of its deposits once.
#pragma once

#include <cuda_runtime.h>

namespace cmi_warp {

constexpr unsigned kAll = 0xffffffffu;

// tally[id] += dep for every lane of the warp (all 32 lanes must call it; a
// lane with no deposit passes id -1): each run of consecutive lanes with one
// id adds the sum of its deposits once, a segmented suffix sum in five
// shuffles, which the run's first lane holds at the end.
__device__ __forceinline__ void run_deposit(float* __restrict__ tally, int id, float dep,
                                            unsigned lane) {
  const int prev = __shfl_up_sync(kAll, id, 1);
  const bool head = lane == 0u || prev != id;
  // the first lane of the next run (2u << 31 wraps to 0, so the mask of the
  // lanes at or below this one holds for lane 31 too)
  const unsigned later_heads = __ballot_sync(kAll, head) & ~((2u << lane) - 1u);
  const int run_end = later_heads != 0u ? __ffs(later_heads) - 1 : 32;
  float sum = dep;  // after the loop: the sum over lanes [lane, run_end)
#pragma unroll
  for (int offset = 1; offset < 32; offset *= 2) {
    const float other = __shfl_down_sync(kAll, sum, offset);
    if (static_cast<int>(lane) + offset < run_end) sum += other;
  }
  if (head && id >= 0) atomicAdd(tally + id, sum);
}

}  // namespace cmi_warp
