// K1: the Cartesian photon-packet march, one thread per packet.
//
// Replaces cmacionize_tpu/ops/traversal.py:trace_packets (the lockstep
// lax.while_loop march) and trace_packets_blocked_cascade (the same estimator
// with blocked rows and a shrinking width cascade, which are bookkeeping for
// the TPU's memory system and are not carried over).  The plain PyTorch
// version is cmacionize_torch/ops/traversal.py:trace_packets_reference.
//
// The step is cartesian_march.cuh's, step for step as in the JAX march.  On
// top of it K1 deposits l * weight into the tally at every step, stops a
// packet after max_steps steps (the number of lockstep iterations a packet
// takes part in, so the cut-off is the same), and keeps a terminated
// packet's final state (position, cell, tau_left).  A packet that is handed
// in active with a cell outside the grid is treated as escaped (the plain
// version does the same; make_packets never makes one).  Absorbed flags and
// final positions match the plain version; only the order in which atomics
// add into the tally differs, which changes the tally at f32 round-off.
//
// What bounds it on an H100: each step is one random 4-byte gather of chi
// and one 4-byte atomicAdd into the tally.  At 64^3 the f32 chi and tally
// are 1 MB each and stay in the 50 MB L2, so the march is bound by L2
// gather and atomic throughput, not by HBM bandwidth.  Atomics contend
// heavily in the few cells around the point source, where all packets
// start, and warps diverge as their packets terminate at different steps.
// The simple design is deliberate: warp-aggregated or shared-memory
// privatised atomics and sorting packets by direction are later work.

#include "cartesian_march.cuh"

namespace {

__global__ void __launch_bounds__(cart::kThreads) trace_packets_kernel(
    const float* __restrict__ opacity, float* __restrict__ tally,
    float* __restrict__ px_io, float* __restrict__ py_io,
    float* __restrict__ pz_io, int* __restrict__ cx_io,
    int* __restrict__ cy_io, int* __restrict__ cz_io,
    const float* __restrict__ dx_in, const float* __restrict__ dy_in,
    const float* __restrict__ dz_in, float* __restrict__ tau_io,
    const float* __restrict__ weight_in, uint8_t* __restrict__ active_io,
    uint8_t* __restrict__ absorbed_io, int n, int nx, int ny, int nz,
    int periodic_mask, int max_steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool active = active_io[i] != 0;
  if (!active) return;  // frozen: state stays as handed in

  cart::Ray r{px_io[i], py_io[i], pz_io[i], cx_io[i], cy_io[i], cz_io[i],
              dx_in[i],  dy_in[i],  dz_in[i],  tau_io[i]};
  const cart::Grid g = cart::make_grid(nx, ny, nz, periodic_mask);
  const float w = weight_in[i];
  bool absorbed = absorbed_io[i] != 0;
  const auto chi = [&](int flat) { return __ldg(opacity + flat); };
  const auto deposit = [&](int flat, float l) { atomicAdd(tally + flat, l * w); };

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

// Launches K1 on `stream`; returns cudaGetLastError() (0 on success).
// All arrays are device pointers of length n (opacity and tally: nx*ny*nz).
// Packet state is updated in place; flags are bytes holding 0 or 1.
extern "C" int cmi_trace_packets(
    const float* opacity, float* tally, float* px, float* py, float* pz,
    int* cx, int* cy, int* cz, const float* dx, const float* dy,
    const float* dz, float* tau_left, const float* weight, uint8_t* active,
    uint8_t* absorbed, int n, int nx, int ny, int nz, int periodic_mask,
    int max_steps, void* stream) {
  if (n > 0) {
    const int blocks = (n + cart::kThreads - 1) / cart::kThreads;
    trace_packets_kernel<<<blocks, cart::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        opacity, tally, px, py, pz, cx, cy, cz, dx, dy, dz, tau_left, weight,
        active, absorbed, n, nx, ny, nz, periodic_mask, max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}
