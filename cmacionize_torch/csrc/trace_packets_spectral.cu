// K2: the spectral photon-packet march, one thread per packet.
//
// Replaces cmacionize_tpu/ops/traversal.py:trace_packets_spectral (the
// lockstep lax.while_loop march of the multi-frequency path) and its TPU
// layouts trace_packets_spectral_blocked and trace_packets_spectral_auto
// (blocked rows and the batch split, bookkeeping for the TPU's memory system
// that is not carried over).  The plain PyTorch version is
// cmacionize_torch/ops/traversal.py:trace_packets_spectral_reference.
//
// It is K1 (csrc/trace_packets.cu, on the step of cartesian_march.cuh) with
// two changes, step for step as in the JAX march:
//   * the opacity is per packet, chi = max(chi_H[cell] sigma_H +
//     chi_He[cell] sigma_He, 1e-30);
//   * the deposit l * w goes to tally[fbin * ncell + cell], a frequency-binned
//     tally of n_bins * ncell floats.
// Everything else is K1's: wall distances with the degenerate-direction
// guard, absorption inside the cell, the crossed axis snapped onto its wall,
// periodic wrap, escape at the walls, at most max_steps steps, and the final
// state (position, cell, tau_left, absorbed) written back for re-emission.
// A packet handed in inactive returns at once: a re-emission generation
// passes the whole batch with its re-emission mask as the active flags.
//
// Precision: built with --fmad=false and without fast math.  Where XLA on
// the CPU fuses the JAX march, K2 rounds once with an explicit FMA, and only
// there: the position advance p + d*l, and chi_H*sigma_H + (chi_He*sigma_He)
// (the He product rounded, then one fused multiply-add; a bit-parity test
// of the plain version against the JAX march at 16^3 chose this form over
// plain and He-fused sums).  Only the order in which atomics add into the
// tally differs from the plain version.
//
// What bounds it on an H100: per step, two random 4-byte gathers (chi_H,
// chi_He; 1 MB each at 64^3, L2-resident) and one 4-byte atomicAdd into a
// tally of 134 MB at 64^3 x 128 bins, which does not fit the 50 MB L2, so
// the atomics go to HBM unless packets of one bin crowd the same cells.
// Atomics contend at the source cells, and warps diverge as packets
// terminate.  K5s's pieces, tried here (PERF.md, section 6), did not pay:
// run-summed warp deposits took more registers (55 against 40) and time on
// the generations, and an order of the active packets, by bin or by bin and
// direction, made the march slower and added a sort.  Privatising the tally
// per block is untried.

#include "cartesian_march.cuh"
#include "occupancy.cuh"

namespace {

__global__ void __launch_bounds__(cart::kThreads) trace_packets_spectral_kernel(
    const float* __restrict__ chi_h, const float* __restrict__ chi_he,
    float* __restrict__ tally, float* __restrict__ px_io,
    float* __restrict__ py_io, float* __restrict__ pz_io,
    int* __restrict__ cx_io, int* __restrict__ cy_io, int* __restrict__ cz_io,
    const float* __restrict__ dx_in, const float* __restrict__ dy_in,
    const float* __restrict__ dz_in, float* __restrict__ tau_io,
    const float* __restrict__ weight_in, const float* __restrict__ sig_h_in,
    const float* __restrict__ sig_he_in, const int* __restrict__ fbin_in,
    uint8_t* __restrict__ active_io, uint8_t* __restrict__ absorbed_io, int n,
    int nx, int ny, int nz, int periodic_mask, int max_steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool active = active_io[i] != 0;
  if (!active) return;  // frozen: state stays as handed in

  cart::Ray r{px_io[i], py_io[i], pz_io[i], cx_io[i], cy_io[i], cz_io[i],
              dx_in[i],  dy_in[i],  dz_in[i],  tau_io[i]};
  const cart::Grid g = cart::make_grid(nx, ny, nz, periodic_mask);
  const float w = weight_in[i];
  const float sig_h = sig_h_in[i], sig_he = sig_he_in[i];
  const int64_t ncell = static_cast<int64_t>(nx) * ny * nz;
  float* const bin_tally = tally + static_cast<int64_t>(fbin_in[i]) * ncell;
  bool absorbed = absorbed_io[i] != 0;
  // chi_h * sig_h + chi_he * sig_he, fused as XLA fuses it
  const auto chi = [&](int flat) {
    return __fmaf_rn(__ldg(chi_h + flat), sig_h, __ldg(chi_he + flat) * sig_he);
  };
  const auto deposit = [&](int flat, float l) { atomicAdd(bin_tally + flat, l * w); };

  active = cart::inside(r, g);
  for (int step = 0; active && step < max_steps; ++step) {
    if (cart::step(r, g, chi, deposit)) {
      absorbed = true;
      active = false;
      break;
    }
    active = cart::inside(r, g);
  }

  px_io[i] = r.px;
  py_io[i] = r.py;
  pz_io[i] = r.pz;
  cx_io[i] = r.cx;
  cy_io[i] = r.cy;
  cz_io[i] = r.cz;
  tau_io[i] = r.tau_left;
  active_io[i] = active ? 1 : 0;
  absorbed_io[i] = absorbed ? 1 : 0;
}

}  // namespace

// Launches K2 on `stream`; returns cudaGetLastError() (0 on success).
// Packet arrays are device pointers of length n; chi_h and chi_he hold
// nx*ny*nz floats, tally n_bins*nx*ny*nz.  Packet state is updated in place;
// flags are bytes holding 0 or 1; fbin must lie in [0, n_bins).
extern "C" int cmi_trace_packets_spectral(
    const float* chi_h, const float* chi_he, float* tally, float* px, float* py,
    float* pz, int* cx, int* cy, int* cz, const float* dx, const float* dy,
    const float* dz, float* tau_left, const float* weight, const float* sig_h,
    const float* sig_he, const int* fbin, uint8_t* active, uint8_t* absorbed,
    int n, int nx, int ny, int nz, int n_bins, int periodic_mask, int max_steps,
    void* stream) {
  if (n > 0 && n_bins > 0) {
    const int blocks = (n + cart::kThreads - 1) / cart::kThreads;
    trace_packets_spectral_kernel<<<blocks, cart::kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        chi_h, chi_he, tally, px, py, pz, cx, cy, cz, dx, dy, dz, tau_left,
        weight, sig_h, sig_he, fbin, active, absorbed, n, nx, ny, nz,
        periodic_mask, max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}

// The registers a thread of K2 takes and its blocks resident on one SM of the
// current device, and that device's SM count; returns the CUDA error (0 on
// success).
extern "C" int cmi_trace_packets_spectral_occupancy(int* registers, int* blocks_per_sm,
                                                    int* sms) {
  return cmi_occupancy::query(trace_packets_spectral_kernel, cart::kThreads, registers,
                              blocks_per_sm, sms);
}
