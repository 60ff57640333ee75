// The occupancy query behind the kernels' *_occupancy launchers (K1, K2,
// K3, K5, K6 and others): a kernel's registers per thread and its blocks
// resident on one SM of the current device, and that device's SM count.
#pragma once

#include <cuda_runtime.h>

namespace cmi_occupancy {

// Fills the three counts for `kernel` launched in blocks of `threads`
// threads with `dynamic_smem` bytes of dynamic shared memory; returns the
// CUDA error (0 on success).
template <class Kernel>
inline int query(Kernel kernel, int threads, int* registers, int* blocks_per_sm, int* sms,
                 size_t dynamic_smem = 0) {
  cudaFuncAttributes attributes;
  int device = 0;
  cudaError_t err = cudaFuncGetAttributes(&attributes, kernel);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads,
                                                        dynamic_smem);
  }
  *registers = attributes.numRegs;
  return static_cast<int>(err);
}

}  // namespace cmi_occupancy
