// K5: the photon-packet march through a flattened AMR octree, one thread
// per packet; and K5d, the leaf descent alone, one thread per point.
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
// tau_left; ell * w is added to tally[leaf] with atomicAdd; a crossing packet
// lands on the crossed wall and stays active while its nudged point is
// inside the box.  A packet handed in inactive returns at once; at most
// max_steps steps; the final state (position, tau_left, flags) is written
// back, since re-emission and the coarse-to-fine rescale read it.
//
// Precision: built with --fmad=false and without fast math; the FMAs that
// XLA on the CPU forms are written out (octree_march.cuh).  Flags and
// positions match the plain version; only the order in which atomics add
// into the tally differs.
//
// What bounds it on an H100: each step is a chain of dependent gathers, root
// then one children row per level (max_level of them in the refined zone),
// then chi and one atomicAdd.  On the deep stromgren grid (17M leaves) the
// 76 MB children table, the 68 MB chi and the 68 MB tally exceed the 50 MB
// L2, so the descent's gathers come from HBM where packets have spread out;
// packets near the source share rows.  The march is latency bound: a thread
// waits max_level + 2 memory round trips per step, and warps diverge as
// packets terminate.  Caching the top of the tree in shared memory, sorting
// packets by leaf and warp-aggregated deposits are later work.

#include "octree_march.cuh"

namespace {

using namespace cmi_octree;

__global__ void __launch_bounds__(kThreads) trace_octree_kernel(
    const int* __restrict__ root, const int* __restrict__ children,
    const float* __restrict__ chi, float* __restrict__ tally,
    float* __restrict__ px_io, float* __restrict__ py_io,
    float* __restrict__ pz_io, const float* __restrict__ dx_in,
    const float* __restrict__ dy_in, const float* __restrict__ dz_in,
    float* __restrict__ tau_io, const float* __restrict__ weight_in,
    uint8_t* __restrict__ active_io, uint8_t* __restrict__ absorbed_io,
    int n, int nx, int ny, int nz, int max_level, float eps, int max_steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool active = active_io[i] != 0;
  if (!active) return;  // frozen: state stays as handed in

  float px = px_io[i], py = py_io[i], pz = pz_io[i];
  const float dx = dx_in[i], dy = dy_in[i], dz = dz_in[i];
  float tau_left = tau_io[i];
  const float w = weight_in[i];
  bool absorbed = absorbed_io[i] != 0;

  for (int s = 0; active && s < max_steps; ++s) {
    const Leaf b = current_leaf(root, children, px, py, pz, dx, dy, dz, eps,
                                nx, ny, nz, max_level);
    float tx, ty;
    const float l_exit = exit_distance(b, px, py, pz, dx, dy, dz, &tx, &ty);
    const float ell =
        step(b, l_exit, tx, ty, __ldg(chi + b.id), eps, nx, ny, nz, px, py,
             pz, dx, dy, dz, tau_left, active, absorbed);
    atomicAdd(tally + b.id, ell * w);
  }

  px_io[i] = px;
  py_io[i] = py;
  pz_io[i] = pz;
  tau_io[i] = tau_left;
  active_io[i] = active ? 1 : 0;
  absorbed_io[i] = absorbed ? 1 : 0;
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

// Launches K5 on `stream`; returns cudaGetLastError() (0 on success).
// root holds nx*ny*nz ints, children n_internal*8, chi and tally one float
// per leaf (coarse cell units); the packet arrays n values each, flags as
// bytes holding 0 or 1.  Packet state and the tally are updated in place.
extern "C" int cmi_trace_octree(const int* root, const int* children,
                                const float* chi, float* tally, float* px,
                                float* py, float* pz, const float* dx,
                                const float* dy, const float* dz, float* tau,
                                const float* weight, uint8_t* active,
                                uint8_t* absorbed, int n, int nx, int ny,
                                int nz, int max_level, float eps,
                                int max_steps, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    trace_octree_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        root, children, chi, tally, px, py, pz, dx, dy, dz, tau, weight,
        active, absorbed, n, nx, ny, nz, max_level, eps, max_steps);
  }
  return static_cast<int>(cudaGetLastError());
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
