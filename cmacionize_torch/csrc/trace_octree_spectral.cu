// K5s: the spectral photon-packet march through a flattened AMR octree, one
// thread per packet, the active packets taken in the order the wrapper gives.
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
// Flags and positions match the plain version bit for bit; only the order in
// which the deposits are summed into the tally differs.
//
// What bounds it on an H100: as K5, a chain of dependent gathers per step
// (root, a children row per level, chi_H and chi_He) from tables past the
// L2, and a deposit into the binned tally (2.1M leaves x 64 bins: 538 MB on
// the deep multi-frequency grid), and a warp runs until its longest packet
// ends.  The design is K5's (PERF.md section 6 has what each piece took off
// on the multi-frequency AMR run):
//
// - a fixed point: a step that leaves position, tau_left and the flags bit
//   for bit as they were, with a deposit of +0.0, repeats itself until
//   max_steps; the lane ends the packet there, active, as max_steps would.
//   The source of the multi-frequency AMR run sits on walls of every level,
//   where the JAX march's nudge quirk (ops/amr_traversal.py) stalls packets;
// - the order: the wrapper sorts the active packets by their frequency bin,
//   then their direction (kernels/trace_octree_spectral.py:packet_order),
//   and puts the inactive ones last; thread k marches packet order[k] in its
//   own slot, and threads at or past the active count (a device scalar) do
//   nothing, so that the lanes of a warp march neighbouring rays into one
//   tally plane, and a re-emission generation, which passes the whole batch
//   with its re-emission mask as the active flags, fills its warps with
//   live packets;
// - warp deposits: each run of consecutive lanes whose step deposits into one
//   slot sums its deposits in five shuffles and adds them with one atomicAdd
//   (warp_deposit.cuh, on the full slot fbin * C + leaf).

#include "occupancy.cuh"
#include "octree_march.cuh"
#include "warp_deposit.cuh"

namespace {

using namespace cmi_octree;

using cmi_warp::kAll;

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
    const int* __restrict__ order, const long long* __restrict__ n_active,
    int n, int nx, int ny, int nz, int n_leaves, int max_level, int max_steps,
    float eps) {
  const unsigned lane = threadIdx.x % 32u;
  // the lane's packet and its state, in the packet's own slot i
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int i = k >= n || k >= *n_active ? -1 : __ldg(order + k);
  bool active = i >= 0 && active_io[i] != 0 && max_steps > 0;
  if (__ballot_sync(kAll, active) == 0u) return;  // the warp has no packet
  float px = 0.0f, py = 0.0f, pz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float tau_left = 0.0f, w = 0.0f, sig_h = 0.0f, sig_he = 0.0f;
  int bin_base = 0;  // fbin * C: the slot of the packet's tally plane
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
    sig_h = sig_h_in[i];
    sig_he = sig_he_in[i];
    bin_base = fbin_in[i] * n_leaves;
    absorbed = absorbed_io[i] != 0;
  }
  // the warp steps until its last packet ends (the deposits are warp-wide)
  for (int s = 0; __ballot_sync(kAll, active) != 0u; ++s) {
    int slot = -1;  // the tally slot of this step's deposit; -1: no packet
    float dep = 0.0f;
    if (active) {
      const Leaf b = current_leaf(root, children, px, py, pz, dx, dy, dz, eps,
                                  nx, ny, nz, max_level);
      float tx, ty;
      const float l_exit = exit_distance(b, px, py, pz, dx, dy, dz, &tx, &ty);
      const float he = __ldg(chi_he + b.id) * sig_he;
      const float chi = __fmaf_rn(__ldg(chi_h + b.id), sig_h, he);
      const float px0 = px, py0 = py, pz0 = pz, tau0 = tau_left;
      const float ell = step(b, l_exit, tx, ty, chi, eps, nx, ny, nz, px, py,
                             pz, dx, dy, dz, tau_left, active, absorbed);
      slot = bin_base + b.id;
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
    cmi_warp::run_deposit(tally, slot, dep, lane);
  }
}

}  // namespace

// Launches K5s on `stream`; returns cudaGetLastError() (0 on success).  As
// cmi_trace_octree, plus chi_he (n_leaves floats), sig_h, sig_he and fbin (n
// values each, fbin in [0, n_bins)) and a tally of n_bins * n_leaves floats
// (fbin * n_leaves + leaf must fit int32).  `order` is a permutation of the n
// packets whose first *n_active entries are the active ones: thread k
// marches packet order[k], in its own slot.
extern "C" int cmi_trace_octree_spectral(
    const int* root, const int* children, const float* chi_h,
    const float* chi_he, float* tally, float* px, float* py, float* pz,
    const float* dx, const float* dy, const float* dz, float* tau,
    const float* weight, const float* sig_h, const float* sig_he,
    const int* fbin, uint8_t* active, uint8_t* absorbed, const int* order,
    const long long* n_active, int n, int nx, int ny, int nz, int n_leaves,
    int max_level, int max_steps, float eps, void* stream) {
  if (n > 0 && n_leaves > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    trace_octree_spectral_kernel<<<blocks, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        root, children, chi_h, chi_he, tally, px, py, pz, dx, dy, dz, tau,
        weight, sig_h, sig_he, fbin, active, absorbed, order, n_active, n, nx,
        ny, nz, n_leaves, max_level, max_steps, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// The registers a thread of K5s takes and its blocks resident on one SM of
// the current device, and that device's SM count; returns the CUDA error (0
// on success).
extern "C" int cmi_trace_octree_spectral_occupancy(int* registers,
                                                   int* blocks_per_sm,
                                                   int* sms) {
  return cmi_occupancy::query(trace_octree_spectral_kernel, kThreads,
                              registers, blocks_per_sm, sms);
}
