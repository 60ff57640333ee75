// K6s: the spectral face-plane march over a Voronoi cell graph, one thread
// per packet.
//
// Replaces cmacionize_tpu/models/voronoi.py:_trace_voronoi_spectral_jit (the
// march of the multi-frequency Voronoi driver).  The plain PyTorch version
// is cmacionize_torch/models/voronoi.py:trace_packets_voronoi_spectral_reference.
//
// It is K6 (trace_voronoi.cu, with the step in voronoi_march.cuh) with two
// changes, step for step as in the JAX march:
//   * the opacity is per packet, chi = max(chi_H[cell] sigma_H +
//     chi_He[cell] sigma_He, 1e-30), rounded as XLA on the CPU fuses it:
//     the He product rounded, then the H product added with one FMA (the
//     form a bit-parity test found for the Cartesian spectral march, K2, and
//     the plain version's on the cell graph);
//   * the deposit ell * w goes to tally[fbin * C + cell], a frequency-binned
//     tally of n_bins * C floats.
// A packet handed in inactive returns at once: a re-emission generation
// passes the whole batch with its re-emission mask as the active flags.
//
// What bounds it on an H100: as K6, plus a second 4-byte chi gather per
// step; the binned tally (12000 cells x 64 bins: 3 MB) sits in L2.

#include "voronoi_march.cuh"

namespace {

using namespace cmi_voronoi;

__global__ void __launch_bounds__(kThreads) trace_voronoi_spectral_kernel(
    const int* __restrict__ nbr, const float* __restrict__ normals,
    const float* __restrict__ offsets, const float* __restrict__ shifts,
    const float* __restrict__ chi_h, const float* __restrict__ chi_he,
    float* __restrict__ tally, float* __restrict__ pos_io,
    const float* __restrict__ dirn, int* __restrict__ cell_io,
    float* __restrict__ tau_io, const float* __restrict__ weight,
    const float* __restrict__ sig_h_in, const float* __restrict__ sig_he_in,
    const int* __restrict__ fbin_in, uint8_t* __restrict__ active_io,
    uint8_t* __restrict__ absorbed_io, int n, int n_cells, int K, float eps,
    int max_steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool active = active_io[i] != 0;
  if (!active) return;  // frozen: state stays as handed in

  float px = pos_io[3 * i], py = pos_io[3 * i + 1], pz = pos_io[3 * i + 2];
  const float dx = dirn[3 * i], dy = dirn[3 * i + 1], dz = dirn[3 * i + 2];
  int cell = cell_io[i];
  float tau_left = tau_io[i];
  const float w = weight[i];
  const float sig_h = sig_h_in[i], sig_he = sig_he_in[i];
  float* const bin_tally = tally + static_cast<int64_t>(fbin_in[i]) * n_cells;
  bool absorbed = absorbed_io[i] != 0;

  for (int s = 0; active && s < max_steps; ++s) {
    const int64_t row = cell;
    float t_exit;
    const int k_exit = exit_face(nbr, normals, offsets, row, K, px, py, pz,
                                 dx, dy, dz, &t_exit);
    const float he = __ldg(chi_he + row) * sig_he;
    const float chi = __fmaf_rn(__ldg(chi_h + row), sig_h, he);
    const float ell =
        step(nbr, shifts, row, K, k_exit, t_exit, chi, eps, px, py, pz, dx,
             dy, dz, cell, tau_left, active, absorbed);
    atomicAdd(bin_tally + row, ell * w);
  }

  pos_io[3 * i] = px;
  pos_io[3 * i + 1] = py;
  pos_io[3 * i + 2] = pz;
  cell_io[i] = cell;
  tau_io[i] = tau_left;
  active_io[i] = active ? 1 : 0;
  absorbed_io[i] = absorbed ? 1 : 0;
}

}  // namespace

// Launches K6s on `stream`; returns cudaGetLastError() (0 on success).
// As cmi_trace_voronoi, plus chi_he (n_cells floats), sig_h, sig_he and fbin
// (n values each, fbin in [0, n_bins)) and a tally of n_bins*n_cells floats.
extern "C" int cmi_trace_voronoi_spectral(
    const int* nbr, const float* normals, const float* offsets,
    const float* shifts, const float* chi_h, const float* chi_he,
    float* tally, float* pos, const float* dirn, int* cell, float* tau,
    const float* weight, const float* sig_h, const float* sig_he,
    const int* fbin, uint8_t* active, uint8_t* absorbed, int n, int n_cells,
    int K, int n_bins, float eps, int max_steps, void* stream) {
  if (n > 0 && n_cells > 0 && K > 0 && n_bins > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    trace_voronoi_spectral_kernel<<<blocks, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        nbr, normals, offsets, shifts, chi_h, chi_he, tally, pos, dirn, cell,
        tau, weight, sig_h, sig_he, fbin, active, absorbed, n, n_cells, K,
        eps, max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}
