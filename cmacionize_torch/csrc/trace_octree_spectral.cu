// K5s: the spectral photon-packet march through a flattened AMR octree, one
// thread per packet.
//
// Replaces cmacionize_tpu/ops/amr_traversal.py:trace_packets_octree_spectral
// (the march of the multi-frequency driver on deep AMR grids).  The plain
// PyTorch version is
// cmacionize_torch/ops/amr_traversal.py:trace_packets_octree_spectral_reference.
//
// It is K5 (trace_octree.cu, with the descent and the step in
// octree_march.cuh) with two changes, step for step as in the JAX march:
//   * the opacity is per packet, chi = max(chi_H[leaf] sigma_H +
//     chi_He[leaf] sigma_He, 1e-30), rounded as XLA on the CPU fuses it:
//     the He product rounded, then the H product added with one FMA (the
//     form of K2 and K6s, and of the plain version);
//   * the deposit ell * w goes to tally[fbin * C + leaf], a frequency-binned
//     tally of n_bins * C floats.
// A packet handed in inactive returns at once: a re-emission generation
// passes the whole batch with its re-emission mask as the active flags.
//
// What bounds it on an H100: as K5, plus a second 4-byte chi gather per
// step; the binned tally (2.1M leaves x 64 bins: 538 MB on the deep
// multi-frequency grid) is far larger than the L2, so each deposit is an
// atomic to HBM.

#include "octree_march.cuh"

namespace {

using namespace cmi_octree;

__global__ void __launch_bounds__(kThreads) trace_octree_spectral_kernel(
    const int* __restrict__ root, const int* __restrict__ children,
    const float* __restrict__ chi_h, const float* __restrict__ chi_he,
    float* __restrict__ tally, float* __restrict__ px_io,
    float* __restrict__ py_io, float* __restrict__ pz_io,
    const float* __restrict__ dx_in, const float* __restrict__ dy_in,
    const float* __restrict__ dz_in, float* __restrict__ tau_io,
    const float* __restrict__ weight_in, const float* __restrict__ sig_h_in,
    const float* __restrict__ sig_he_in, const int* __restrict__ fbin_in,
    uint8_t* __restrict__ active_io, uint8_t* __restrict__ absorbed_io,
    int n, int nx, int ny, int nz, int n_leaves, int max_level, float eps,
    int max_steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool active = active_io[i] != 0;
  if (!active) return;  // frozen: state stays as handed in

  float px = px_io[i], py = py_io[i], pz = pz_io[i];
  const float dx = dx_in[i], dy = dy_in[i], dz = dz_in[i];
  float tau_left = tau_io[i];
  const float w = weight_in[i];
  const float sig_h = sig_h_in[i], sig_he = sig_he_in[i];
  float* const bin_tally = tally + static_cast<int64_t>(fbin_in[i]) * n_leaves;
  bool absorbed = absorbed_io[i] != 0;

  for (int s = 0; active && s < max_steps; ++s) {
    const Leaf b = current_leaf(root, children, px, py, pz, dx, dy, dz, eps,
                                nx, ny, nz, max_level);
    float tx, ty;
    const float l_exit = exit_distance(b, px, py, pz, dx, dy, dz, &tx, &ty);
    const float he = __ldg(chi_he + b.id) * sig_he;
    const float chi = __fmaf_rn(__ldg(chi_h + b.id), sig_h, he);
    const float ell = step(b, l_exit, tx, ty, chi, eps, nx, ny, nz, px, py,
                           pz, dx, dy, dz, tau_left, active, absorbed);
    atomicAdd(bin_tally + b.id, ell * w);
  }

  px_io[i] = px;
  py_io[i] = py;
  pz_io[i] = pz;
  tau_io[i] = tau_left;
  active_io[i] = active ? 1 : 0;
  absorbed_io[i] = absorbed ? 1 : 0;
}

}  // namespace

// Launches K5s on `stream`; returns cudaGetLastError() (0 on success).
// As cmi_trace_octree, plus chi_he (n_leaves floats), sig_h, sig_he and
// fbin (n values each, fbin in [0, n_bins)) and a tally of n_bins*n_leaves
// floats.
extern "C" int cmi_trace_octree_spectral(
    const int* root, const int* children, const float* chi_h,
    const float* chi_he, float* tally, float* px, float* py, float* pz,
    const float* dx, const float* dy, const float* dz, float* tau,
    const float* weight, const float* sig_h, const float* sig_he,
    const int* fbin, uint8_t* active, uint8_t* absorbed, int n, int nx,
    int ny, int nz, int n_leaves, int n_bins, int max_level, float eps,
    int max_steps, void* stream) {
  if (n > 0 && n_leaves > 0 && n_bins > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    trace_octree_spectral_kernel<<<blocks, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        root, children, chi_h, chi_he, tally, px, py, pz, dx, dy, dz, tau,
        weight, sig_h, sig_he, fbin, active, absorbed, n, nx, ny, nz,
        n_leaves, max_level, eps, max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}
