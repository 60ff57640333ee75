// K1: the Cartesian photon-packet march, one thread per packet.
//
// Replaces cmacionize_tpu/ops/traversal.py:trace_packets (the lockstep
// lax.while_loop march) and trace_packets_blocked_cascade (the same estimator
// with blocked rows and a shrinking width cascade, which are bookkeeping for
// the TPU's memory system and are not carried over).  The plain PyTorch
// version is cmacionize_torch/ops/traversal.py:trace_packets_reference.
//
// Semantics, step for step as in the JAX march:
//   * wall distance per axis with a degenerate-direction guard (|d| <= 1e-12
//     never crosses its wall: +inf), clamped at 0;
//   * chi floored at 1e-30; absorption when chi * l_exit >= tau_left, the
//     packet then travels tau_left / chi and stops inside the cell;
//   * the crossed axis is the first of x, y, z whose wall distance equals
//     l_exit exactly, and that coordinate is snapped onto the wall;
//   * periodic axes wrap position and cell; a cell outside the grid escapes;
//   * at most max_steps steps per packet, which is the number of lockstep
//     iterations a packet takes part in, so the cut-off is the same;
//   * a terminated packet keeps its final state (position, cell, tau_left).
// A packet that is handed in active with a cell outside the grid is treated
// as escaped (the plain version does the same; make_packets never makes one).
//
// Precision: built with --fmad=false and without fast math, the compiler
// contracts nothing, and each packet's arithmetic is the same sequence of
// IEEE f32 operations (mul, sub, div.rn, min, max) as the plain version's
// separate elementwise ops.  The one fused multiply-add is explicit: the
// position advance p + d*l is __fmaf_rn, because XLA on the CPU fuses the
// JAX march's advance that way and the plain version rounds it once too.
// So absorbed flags and final positions match the plain version; only the
// order in which atomics add into the tally differs, which changes the
// tally at f32 round-off.
//
// What bounds it on an H100: each step is one random 4-byte gather of chi
// and one 4-byte atomicAdd into the tally.  At 64^3 the f32 chi and tally
// are 1 MB each and stay in the 50 MB L2, so the march is bound by L2
// gather and atomic throughput, not by HBM bandwidth.  Atomics contend
// heavily in the few cells around the point source, where all packets
// start, and warps diverge as their packets terminate at different steps.
// The simple design is deliberate: warp-aggregated or shared-memory
// privatised atomics and sorting packets by direction are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEpsDir = 1e-12f;  // _EPS_DIR of the JAX march
constexpr float kChiFloor = 1e-30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float wall_distance(float pos, int cell, float dirn) {
  if (!(fabsf(dirn) > kEpsDir)) return __int_as_float(0x7f800000);  // +inf
  const float wall = static_cast<float>(cell + (dirn > 0.0f ? 1 : 0));
  return fmaxf((wall - pos) / dirn, 0.0f);
}

// Periodic wrap of one axis: a step leaves the range by at most one cell.
__device__ __forceinline__ void wrap(float& p, int& c, int n) {
  if (c < 0) {
    p = p + static_cast<float>(n);
    c += n;
  } else if (c >= n) {
    p = p - static_cast<float>(n);
    c -= n;
  }
}

__global__ void __launch_bounds__(kThreads) trace_packets_kernel(
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

  float px = px_io[i], py = py_io[i], pz = pz_io[i];
  int cx = cx_io[i], cy = cy_io[i], cz = cz_io[i];
  const float dx = dx_in[i], dy = dy_in[i], dz = dz_in[i];
  float tau_left = tau_io[i];
  const float w = weight_in[i];
  bool absorbed = absorbed_io[i] != 0;
  const bool per_x = periodic_mask & 1, per_y = periodic_mask & 2,
             per_z = periodic_mask & 4;
  const int step_x = dx > 0.0f ? 1 : -1;
  const int step_y = dy > 0.0f ? 1 : -1;
  const int step_z = dz > 0.0f ? 1 : -1;

  active = cx >= 0 && cx < nx && cy >= 0 && cy < ny && cz >= 0 && cz < nz;
  for (int step = 0; active && step < max_steps; ++step) {
    const float tx = wall_distance(px, cx, dx);
    const float ty = wall_distance(py, cy, dy);
    const float tz = wall_distance(pz, cz, dz);
    const float l_exit = fminf(tx, fminf(ty, tz));

    const int flat = (cx * ny + cy) * nz + cz;
    const float chi = fmaxf(__ldg(opacity + flat), kChiFloor);
    const float tau_cell = chi * l_exit;
    const bool absorbed_now = tau_cell >= tau_left;
    const float l_travel = absorbed_now ? tau_left / chi : l_exit;
    atomicAdd(tally + flat, l_travel * w);

    px = __fmaf_rn(dx, l_travel, px);
    py = __fmaf_rn(dy, l_travel, py);
    pz = __fmaf_rn(dz, l_travel, pz);
    if (absorbed_now) {
      tau_left = 0.0f;
      absorbed = true;
      active = false;
      break;
    }
    // snap the crossed coordinate onto the wall (x, then y, then z on ties)
    if (l_exit == tx) {
      px = static_cast<float>(dx > 0.0f ? cx + 1 : cx);
      cx += step_x;
    } else if (l_exit == ty) {
      py = static_cast<float>(dy > 0.0f ? cy + 1 : cy);
      cy += step_y;
    } else {
      pz = static_cast<float>(dz > 0.0f ? cz + 1 : cz);
      cz += step_z;
    }
    if (per_x) wrap(px, cx, nx);
    if (per_y) wrap(py, cy, ny);
    if (per_z) wrap(pz, cz, nz);
    tau_left = tau_left - tau_cell;
    active = cx >= 0 && cx < nx && cy >= 0 && cy < ny && cz >= 0 && cz < nz;
  }

  px_io[i] = px;
  py_io[i] = py;
  pz_io[i] = pz;
  cx_io[i] = cx;
  cy_io[i] = cy;
  cz_io[i] = cz;
  tau_io[i] = tau_left;
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
    const int blocks = (n + kThreads - 1) / kThreads;
    trace_packets_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        opacity, tally, px, py, pz, cx, cy, cz, dx, dy, dz, tau_left, weight,
        active, absorbed, n, nx, ny, nz, periodic_mask, max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}
