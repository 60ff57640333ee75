// K11 and K11r: per-index gathers from a table, one thread per index.
//
// K11 replaces tools/microbench_scatter.py:pallas_gather (out[i] =
// tbl[idx[i]] from a VMEM-resident [262144] f32 table, blocks of 8192
// indices); K11r replaces pallas_gather2d (a row gather from a [2048, 128]
// table followed by a one-hot pick of the lane, out[i] = tbl2[rows[i],
// lanes[i]]) and tools/probe_pallas_gather.py:b_flat_gather_2d.run
// (tab[hi, lo] on [64, 128] index blocks).  The one-hot pick works around the
// TPU's lane layout and is not part of the function, so K11r reads the one
// element.  The plain versions are cmacionize_torch/kernels/gather.py:
// gather_reference and gather2d_reference; both kernels copy bits and equal
// them exactly.
//
// What bounds them on an H100: the 4-byte index (8 bytes for K11r) read and
// the 4-byte output written per lookup stream through HBM (K11r's 12 bytes a
// lookup: 0.0038 ms at 2^20 lookups and 3.35 TB/s); the table (1 MB at 64^3)
// stays in L2, so each lookup's random read costs one 32-byte L2 sector (33.5
// MB of sectors at 2^20), not HBM bandwidth.  The sectors bind: at 2^20
// lookups on an H100 80GB HBM3 (700 W) K11r takes 0.0097 ms on the device
// alone, 2.4x the bytes' bound, and four or eight lookups a thread, int4 index
// loads, a float4 store or __ldcg table reads took no less (PERF.md, section
// 6).  So both take one lookup a thread, in blocks of 256.  K11r's
// offsets are 32-bit: the wrapper keeps the table below 2^31 elements.  The
// indices are not checked: an index outside the table reads outside it (the
// wrapper's caller keeps them in range).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) gather_kernel(
    const float* __restrict__ tbl, const int* __restrict__ idx, float* __restrict__ out,
    int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = __ldg(tbl + __ldg(idx + i));
}

__global__ void __launch_bounds__(kThreads) gather2d_kernel(
    const float* __restrict__ tbl2, const int* __restrict__ rows,
    const int* __restrict__ lanes, float* __restrict__ out, int n, int width) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = __ldg(tbl2 + __ldg(rows + i) * width + __ldg(lanes + i));
}

}  // namespace

// Launches K11 on `stream`: out[i] = tbl[idx[i]] for i < n.  Returns
// cudaGetLastError() (0 on success).
extern "C" int cmi_gather(const float* tbl, const int* idx, float* out, int n, void* stream) {
  if (n > 0) {
    gather_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(tbl, idx, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K11r on `stream`: out[i] = tbl2[rows[i] * width + lanes[i]] for
// i < n.  Returns cudaGetLastError() (0 on success).
extern "C" int cmi_gather2d(const float* tbl2, const int* rows, const int* lanes, float* out,
                            int n, int width, void* stream) {
  if (n > 0) {
    gather2d_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(tbl2, rows, lanes, out, n, width);
  }
  return static_cast<int>(cudaGetLastError());
}
