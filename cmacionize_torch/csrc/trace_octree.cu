// K5: the photon-packet march through a flattened AMR octree, one thread per
// packet, the packets taken in the order the wrapper gives; and K5d, the leaf
// descent alone, one thread per point.
//
// K5 replaces cmacionize_tpu/ops/amr_traversal.py:trace_packets_octree (the
// lockstep lax.while_loop march of deep AMR grids, those without a dense
// finest lattice), K5d leaf_of_positions (the absorption sites' leaves in the
// deep re-emission generations).  The plain PyTorch versions are
// cmacionize_torch/ops/amr_traversal.py:trace_packets_octree_reference and
// leaf_of_positions_reference.
//
// Per step, as in the JAX march (the helpers are in octree_march.cuh, shared
// with K5s): the leaf holding the packet's point nudged by eps along its
// direction is found by a descent from root through at most max_level rows of
// children; the wall distances of the leaf's box give l_exit; chi of the leaf
// (floored at 1e-30) absorbs the packet inside the leaf if chi * l_exit >=
// tau_left; ell * w is added to tally[leaf]; a crossing packet lands on the
// crossed wall and stays active while its nudged point is inside the box.  A
// packet handed in inactive is left as it is; at most max_steps steps; the
// final state (position, tau_left, flags) is written back, since re-emission
// and the coarse-to-fine rescale read it.
//
// Precision: built with --fmad=false and without fast math; the FMAs that
// XLA on the CPU forms are written out (octree_march.cuh).  Flags and
// positions match the plain version bit for bit; only the order in which the
// deposits are summed into the tally differs.
//
// What bounds it on an H100: each step is a chain of dependent gathers, root
// then one children row per level, then chi and a deposit, from tables (on
// the deep stromgren grid, 17M leaves: 76 MB of children, 68 MB of chi and
// 68 MB of tally) past the 50 MB L2; and a warp runs until its longest packet
// ends.  Three pieces of the design answer that (PERF.md, section 6, has the
// time each one took off on that grid, and the designs that lost there):
//
// - a fixed point: a step that leaves position, tau_left and the flags bit for
//   bit as they were, with a deposit of +0.0, would repeat itself until
//   max_steps, since the step is a pure function of that state; the lane
//   ends the packet there, active, as max_steps would.  Bits are compared,
//   so NaN and -0.0 never pass for a fixed point.  The JAX march's nudge
//   quirk (ops/amr_traversal.py) leaves such packets on a wall; on the deep
//   stromgren grid 1.1% of them, all at the source, ran 6144 steps each;
// - the order: the wrapper sorts the packets by their direction, so that the
//   lanes of a warp march neighbouring rays through the same rows of the
//   tables; a lane reads and writes its packet's state in the packet's own
//   slot, order[k];
// - warp deposits: each run of consecutive lanes whose step ends in one leaf
//   sums its deposits in five shuffles and adds them with one atomicAdd
//   (warp_deposit.cuh, shared with K6).

#include "occupancy.cuh"
#include "octree_march.cuh"
#include "warp_deposit.cuh"

namespace {

using namespace cmi_octree;

using cmi_warp::kAll;

__global__ void __launch_bounds__(kThreads) trace_octree_kernel(
    const int* __restrict__ root, const int* __restrict__ children,
    const float* __restrict__ chi, float* __restrict__ tally,
    float* __restrict__ px_io, float* __restrict__ py_io,
    float* __restrict__ pz_io, const float* __restrict__ dx_in,
    const float* __restrict__ dy_in, const float* __restrict__ dz_in,
    float* __restrict__ tau_io, const float* __restrict__ weight_in,
    uint8_t* __restrict__ active_io, uint8_t* __restrict__ absorbed_io,
    const int* __restrict__ order, int n, int nx, int ny, int nz,
    int max_level, float eps, int max_steps) {
  const unsigned lane = threadIdx.x % 32u;
  // the lane's packet and its state, in the packet's own slot i
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int i = k >= n ? -1 : __ldg(order + k);
  bool active = i >= 0 && active_io[i] != 0 && max_steps > 0;
  float px = 0.0f, py = 0.0f, pz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float tau_left = 0.0f, w = 0.0f;
  bool absorbed = false;
  if (active) {
    px = px_io[i];
    py = py_io[i];
    pz = pz_io[i];
    dx = dx_in[i];
    dy = dy_in[i];
    dz = dz_in[i];
    tau_left = tau_io[i];
    w = weight_in[i];
    absorbed = absorbed_io[i] != 0;
  }
  // the warp steps until its last packet ends (the deposits are warp-wide)
  for (int s = 0; __ballot_sync(kAll, active) != 0u; ++s) {
    int id = -1;  // the leaf of this step's deposit; -1: no packet
    float dep = 0.0f;
    if (active) {
      const Leaf b = current_leaf(root, children, px, py, pz, dx, dy, dz, eps,
                                  nx, ny, nz, max_level);
      float tx, ty;
      const float l_exit = exit_distance(b, px, py, pz, dx, dy, dz, &tx, &ty);
      const float px0 = px, py0 = py, pz0 = pz, tau0 = tau_left;
      const float ell = step(b, l_exit, tx, ty, __ldg(chi + b.id), eps, nx,
                             ny, nz, px, py, pz, dx, dy, dz, tau_left, active,
                             absorbed);
      id = b.id;
      dep = ell * w;
      const bool fixed =
          active && __float_as_uint(dep) == 0u &&
          __float_as_uint(px) == __float_as_uint(px0) &&
          __float_as_uint(py) == __float_as_uint(py0) &&
          __float_as_uint(pz) == __float_as_uint(pz0) &&
          __float_as_uint(tau_left) == __float_as_uint(tau0);
      if (!active || fixed || s + 1 >= max_steps) {
        px_io[i] = px;
        py_io[i] = py;
        pz_io[i] = pz;
        tau_io[i] = tau_left;
        active_io[i] = active ? 1 : 0;
        absorbed_io[i] = absorbed ? 1 : 0;
        active = false;  // this lane is done; the flag written is the packet's
      }
    }
    cmi_warp::run_deposit(tally, id, dep, lane);
  }
}

__global__ void __launch_bounds__(kThreads) leaf_of_positions_kernel(
    const int* __restrict__ root, const int* __restrict__ children,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, int* __restrict__ leaf, int n, int nx,
    int ny, int nz, int max_level) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  leaf[i] = descend(root, children, px[i], py[i], pz[i], nx, ny, nz,
                    max_level).id;
}

}  // namespace

// Launches K5 on `stream`; returns cudaGetLastError() (0 on success).  root
// holds nx*ny*nz ints, children n_internal*8, chi and tally one float per
// leaf (coarse cell units); the packet arrays n values each, flags as bytes
// holding 0 or 1.  Packet state and the tally are updated in place.  `order`
// is a permutation of the n packets: thread k marches packet order[k], in its
// own slot.
extern "C" int cmi_trace_octree(const int* root, const int* children,
                                const float* chi, float* tally, float* px,
                                float* py, float* pz, const float* dx,
                                const float* dy, const float* dz, float* tau,
                                const float* weight, uint8_t* active,
                                uint8_t* absorbed, const int* order, int n,
                                int nx, int ny, int nz, int max_level,
                                float eps, int max_steps, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    trace_octree_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        root, children, chi, tally, px, py, pz, dx, dy, dz, tau, weight,
        active, absorbed, order, n, nx, ny, nz, max_level, eps, max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}

// The registers a thread of K5 takes and its blocks resident on one SM of the
// current device, and that device's SM count; returns the CUDA error (0 on
// success).
extern "C" int cmi_trace_octree_occupancy(int* registers, int* blocks_per_sm,
                                          int* sms) {
  return cmi_occupancy::query(trace_octree_kernel, kThreads, registers,
                              blocks_per_sm, sms);
}

// Launches K5d on `stream`; returns cudaGetLastError() (0 on success).
// Writes the leaf id of each of the n points (coarse cell units) into leaf.
extern "C" int cmi_leaf_of_positions(const int* root, const int* children,
                                     const float* px, const float* py,
                                     const float* pz, int* leaf, int n, int nx,
                                     int ny, int nz, int max_level,
                                     void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    leaf_of_positions_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        root, children, px, py, pz, leaf, n, nx, ny, nz, max_level);
  }
  return static_cast<int>(cudaGetLastError());
}
