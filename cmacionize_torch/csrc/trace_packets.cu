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
// final positions match the plain version bit for bit; only the order in
// which the deposits are summed into the tally differs, which changes the
// tally at f32 round-off.
//
// What bounds it on an H100: each step is one random 4-byte gather of chi
// and one 4-byte deposit into the tally.  At 64^3 the f32 chi and tally are
// 1 MB each and stay in the 50 MB L2, so the march is bound by L2 gather and
// atomic throughput and by the longest lane of each warp, not by HBM.  Every
// packet of a point source starts in the few cells at the source, and the
// next steps crowd the cells around them: one atomicAdd a deposit queues the
// whole launch's deposits there on a few L2 addresses (PERF.md, section 6:
// without its deposits the parent's K1 took a third of its time).  So each
// block keeps a kWindow^3 tally of the cells around its first packet's start
// cell in shared memory: a deposit into that window is a shared-memory
// atomic, any other an atomicAdd into the tally, and the block adds its
// window's non-zero sums into the tally once its packets are done, one atomic
// a cell.  A sort of the packets by direction, which K5 takes, cost K1 more
// than it saved (PERF.md, section 6), so a thread marches packet i in place.

#include "cartesian_march.cuh"
#include "occupancy.cuh"

namespace {

constexpr int kWindow = 16;  // side of a block's shared tally, in cells (16 KB)
constexpr int kWindowCells = kWindow * kWindow * kWindow;

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
  __shared__ float window[kWindowCells];
  __shared__ int corner[3];  // the window's lowest cell
  for (int c = threadIdx.x; c < kWindowCells; c += cart::kThreads) window[c] = 0.0f;
  if (threadIdx.x == 0) {
    const int first = blockIdx.x * cart::kThreads;
    corner[0] = cx_io[first] - kWindow / 2;
    corner[1] = cy_io[first] - kWindow / 2;
    corner[2] = cz_io[first] - kWindow / 2;
  }
  __syncthreads();
  const int wx = corner[0], wy = corner[1], wz = corner[2];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // a packet handed in inactive stays as it is (frozen)
  if (i < n && active_io[i] != 0) {
    cart::Ray r{px_io[i], py_io[i], pz_io[i], cx_io[i], cy_io[i], cz_io[i],
                dx_in[i],  dy_in[i],  dz_in[i],  tau_io[i]};
    const cart::Grid g = cart::make_grid(nx, ny, nz, periodic_mask);
    const float w = weight_in[i];
    bool absorbed = absorbed_io[i] != 0;
    int cx = 0, cy = 0, cz = 0;  // the cell of the step's deposit
    const auto chi = [&](int flat) { return __ldg(opacity + flat); };
    const auto deposit = [&](int flat, float l) {
      const unsigned ux = cx - wx, uy = cy - wy, uz = cz - wz;
      if (ux < kWindow && uy < kWindow && uz < kWindow) {
        atomicAdd(window + (ux * kWindow + uy) * kWindow + uz, l * w);
      } else {
        atomicAdd(tally + flat, l * w);
      }
    };

    bool active = cart::inside(r, g);
    for (int step = 0; active && step < max_steps; ++step) {
      cx = r.cx;
      cy = r.cy;
      cz = r.cz;
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

  __syncthreads();
  for (int c = threadIdx.x; c < kWindowCells; c += cart::kThreads) {
    const float sum = window[c];
    if (sum != 0.0f) {  // only cells of the grid take deposits
      const int x = wx + c / (kWindow * kWindow), y = wy + (c / kWindow) % kWindow,
                z = wz + c % kWindow;
      atomicAdd(tally + (x * ny + y) * nz + z, sum);
    }
  }
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() (0 on success).
// opacity and tally hold nx*ny*nz floats, the packet arrays n values each
// (cell units), flags as bytes holding 0 or 1.  Packet state and the tally
// are updated in place.
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

// The registers a thread of K1 takes and its blocks resident on one SM of the
// current device, and that device's SM count; returns the CUDA error (0 on
// success).
extern "C" int cmi_trace_packets_occupancy(int* registers, int* blocks_per_sm,
                                           int* sms) {
  return cmi_occupancy::query(trace_packets_kernel, cart::kThreads, registers,
                              blocks_per_sm, sms);
}
