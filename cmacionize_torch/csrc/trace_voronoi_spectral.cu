// K6s: the spectral face-plane march over a Voronoi cell graph, one thread
// per packet.
//
// Replaces cmacionize_tpu/models/voronoi.py:_trace_voronoi_spectral_jit (the
// march of the multi-frequency Voronoi driver).  The plain PyTorch version
// is cmacionize_torch/models/voronoi.py:trace_packets_voronoi_spectral_reference.
//
// It is K6 (trace_voronoi.cu, with the face loop and the step in
// voronoi_march.cuh) with two changes, step for step as in the JAX march:
//   * the opacity is per packet, chi = max(chi_H[cell] sigma_H +
//     chi_He[cell] sigma_He, 1e-30), rounded as XLA on the CPU fuses it:
//     the He product rounded, then the H product added with one FMA (the
//     form a bit-parity test found for the Cartesian spectral march, K2, and
//     the plain version's on the cell graph);
//   * the deposit ell * w goes to tally[fbin * C + cell], a frequency-binned
//     tally of n_bins * C floats.
// Flags, cells, positions and tau_left match the plain version bit for bit;
// only the order in which the deposits are summed into the tally differs.
// A packet handed in inactive is left as it is: a re-emission generation
// passes the whole batch with its re-emission mask as the active flags.
//
// What bounds it on an H100: as K6, per step a lane reads its cell's face
// rows, gathers chi_H and chi_He and deposits once; lanes of a warp sit in
// different cells, so no row read coalesces (at 12000 cells the rows and the
// binned tally, 12000 x 64 bins = 3 MB, sit in L2), and every packet of the
// point source starts in the source's cell.  K6's design answers that
// (PERF.md, section 6, has what each piece took off here):
//
// - packed face rows: a face's normal and offset in one float4
//   (VoronoiTables.faces), the face loop stopped at the row's count
//   (voronoi_march.cuh:exit_face_packed); the neighbour and shift rows are
//   read for the exit face only;
// - warp deposits: each run of consecutive lanes whose step deposits into
//   one slot fbin * C + cell sums its deposits in five shuffles and adds them
//   with one atomicAdd (warp_deposit.cuh, shared with K5, K5s and K6); on the
//   first step of a source march the lanes of a bin deposit into one slot.
// Thread k marches packet k in place: an order of the active packets by bin
// and then direction (K5s's packet_order) took device time off the marches
// but cost more host time than it saved on phase 19 (PERF.md, section 6).

#include "occupancy.cuh"
#include "voronoi_march.cuh"
#include "warp_deposit.cuh"

namespace {

using namespace cmi_voronoi;
using cmi_warp::kAll;

__global__ void __launch_bounds__(kThreads) trace_voronoi_spectral_kernel(
    const float4* __restrict__ faces, const int* __restrict__ face_count,
    const int* __restrict__ nbr, const float* __restrict__ shifts,
    const float* __restrict__ chi_h, const float* __restrict__ chi_he,
    float* __restrict__ tally, float* __restrict__ pos_io,
    const float* __restrict__ dirn, int* __restrict__ cell_io,
    float* __restrict__ tau_io, const float* __restrict__ weight,
    const float* __restrict__ sig_h_in, const float* __restrict__ sig_he_in,
    const int* __restrict__ fbin_in, uint8_t* __restrict__ active_io,
    uint8_t* __restrict__ absorbed_io, int n, int n_cells, int K, int max_steps,
    float eps) {
  const unsigned lane = threadIdx.x % 32u;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  // a packet handed in inactive stays as it is (frozen)
  bool active = i < n && active_io[i] != 0 && max_steps > 0;
  if (__ballot_sync(kAll, active) == 0u) return;  // the warp has no packet
  float px = 0.0f, py = 0.0f, pz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float tau_left = 0.0f, w = 0.0f, sig_h = 0.0f, sig_he = 0.0f;
  int cell = 0;
  int bin_base = 0;  // fbin * C: the slot of the packet's tally plane
  bool absorbed = false;
  if (active) {
    px = pos_io[3 * i];
    py = pos_io[3 * i + 1];
    pz = pos_io[3 * i + 2];
    dx = dirn[3 * i];
    dy = dirn[3 * i + 1];
    dz = dirn[3 * i + 2];
    cell = cell_io[i];
    tau_left = tau_io[i];
    w = weight[i];
    sig_h = sig_h_in[i];
    sig_he = sig_he_in[i];
    bin_base = fbin_in[i] * n_cells;
    absorbed = absorbed_io[i] != 0;
  }
  // the warp steps until its last packet ends (the deposits are warp-wide)
  for (int s = 0; __ballot_sync(kAll, active) != 0u; ++s) {
    int slot = -1;  // the tally slot of this step's deposit; -1: no packet
    float dep = 0.0f;
    if (active) {
      const int64_t row = cell;
      float t_exit;
      const int k_exit = exit_face_packed(faces, __ldg(face_count + row), row, K,
                                          px, py, pz, dx, dy, dz, &t_exit);
      const float he = __ldg(chi_he + row) * sig_he;
      const float chi = __fmaf_rn(__ldg(chi_h + row), sig_h, he);
      const float ell =
          step(nbr, shifts, row, K, k_exit, t_exit, chi, eps, px, py, pz, dx,
               dy, dz, cell, tau_left, active, absorbed);
      slot = bin_base + static_cast<int>(row);
      dep = ell * w;
      if (!active || s + 1 >= max_steps) {
        pos_io[3 * i] = px;
        pos_io[3 * i + 1] = py;
        pos_io[3 * i + 2] = pz;
        cell_io[i] = cell;
        tau_io[i] = tau_left;
        active_io[i] = active ? 1 : 0;
        absorbed_io[i] = absorbed ? 1 : 0;
        active = false;  // this lane is done; the flag written is the packet's
      }
    }
    cmi_warp::run_deposit(tally, slot, dep, lane);
  }
}

}  // namespace

// Launches K6s on `stream`; returns cudaGetLastError() (0 on success).  As
// cmi_trace_voronoi, plus chi_he (n_cells floats), sig_h, sig_he and fbin (n
// values each, fbin in [0, n_bins)) and a tally of n_bins * n_cells floats
// (fbin * n_cells + cell must fit int32).  Packet state and the tally are
// updated in place.
extern "C" int cmi_trace_voronoi_spectral(
    const float* faces, const int* face_count, const int* nbr,
    const float* shifts, const float* chi_h, const float* chi_he, float* tally,
    float* pos, const float* dirn, int* cell, float* tau, const float* weight,
    const float* sig_h, const float* sig_he, const int* fbin, uint8_t* active,
    uint8_t* absorbed, int n, int n_cells, int K, int max_steps, float eps,
    void* stream) {
  if (n > 0 && n_cells > 0 && K > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    trace_voronoi_spectral_kernel<<<blocks, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(faces), face_count, nbr, shifts, chi_h,
        chi_he, tally, pos, dirn, cell, tau, weight, sig_h, sig_he, fbin, active,
        absorbed, n, n_cells, K, max_steps, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// The registers a thread of K6s takes and its blocks resident on one SM of
// the current device, and that device's SM count; returns the CUDA error (0
// on success).
extern "C" int cmi_trace_voronoi_spectral_occupancy(int* registers,
                                                    int* blocks_per_sm, int* sms) {
  return cmi_occupancy::query(trace_voronoi_spectral_kernel, kThreads,
                              registers, blocks_per_sm, sms);
}
