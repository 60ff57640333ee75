// K6: the face-plane photon-packet march over a Voronoi cell graph, one
// thread per packet.
//
// Replaces cmacionize_tpu/models/voronoi.py:_trace_voronoi_jit (the lockstep
// lax.while_loop march of the H-only and RHD Voronoi drivers) and its TPU
// width cascade trace_packets_voronoi_cascade / _compact_live_voronoi
// (bookkeeping for the TPU's lockstep width, not carried over).  The plain
// PyTorch version is
// cmacionize_torch/models/voronoi.py:trace_packets_voronoi_reference.
//
// Per step, as in the JAX march: the exit face of the packet's cell is the
// first of least plane distance, the packet is absorbed inside the cell if
// chi * t >= tau_left, ell * w is added to tally[cell], and a crossing packet
// moves ell + eps along its direction, takes the face's shift and enters the
// neighbour (-1: it escapes).  A packet handed in inactive is left as it is;
// at most max_steps steps; the final state (position, cell, tau_left, flags)
// is written back.  The move is voronoi_march.cuh's step, shared with K6s.
//
// Precision: built with --fmad=false and without fast math; the FMAs that
// XLA on the CPU forms are written out (voronoi_march.cuh's dot3 and step).
// Flags, cells, positions and tau_left match the plain version bit for bit;
// only the order in which the deposits are summed into the tally differs.
//
// What bounds it on an H100: per step a lane reads its cell's face rows and
// gathers chi, and deposits once.  Lanes of a warp sit in different cells, so
// no row read coalesces; at 40000 cells the rows live in the 50 MB L2.  Every
// packet of the point source starts in the source's cell.  Two pieces of the
// design answer that (PERF.md, section 6, has what each took off):
//
// - packed face rows: voronoi_tables packs each face's normal and offset into
//   one float4 ([C, K], padding faces with a zero normal) and counts each
//   row's faces up to its last real one; the face loop reads one 16-byte load
//   per face and stops at the count, since a padding face has t = +inf, which
//   the strict < of the least distance never picks.  The neighbour and shift
//   rows are read for the exit face only.  K6s reads the same rows;
// - warp deposits: each run of consecutive lanes whose step ends in one cell
//   sums its deposits in five shuffles and adds them with one atomicAdd
//   (warp_deposit.cuh, shared with K5); on the first step every lane of a
//   warp deposits into the source's cell.
// A sort of the packets by direction, which K5 takes, made K6's face loop
// faster on long marches but cost the main path more host time than it saved
// (PERF.md, section 6), so a thread marches packet i in place.

#include "occupancy.cuh"
#include "voronoi_march.cuh"
#include "warp_deposit.cuh"

namespace {

using namespace cmi_voronoi;
using cmi_warp::kAll;

__global__ void __launch_bounds__(kThreads) trace_voronoi_kernel(
    const float4* __restrict__ faces, const int* __restrict__ face_count,
    const int* __restrict__ nbr, const float* __restrict__ shifts,
    const float* __restrict__ chi, float* __restrict__ tally,
    float* __restrict__ pos_io, const float* __restrict__ dirn,
    int* __restrict__ cell_io, float* __restrict__ tau_io,
    const float* __restrict__ weight, uint8_t* __restrict__ active_io,
    uint8_t* __restrict__ absorbed_io, int n, int K, int max_steps, float eps) {
  const unsigned lane = threadIdx.x % 32u;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  // a packet handed in inactive stays as it is (frozen)
  bool active = i < n && active_io[i] != 0 && max_steps > 0;
  float px = 0.0f, py = 0.0f, pz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float tau_left = 0.0f, w = 0.0f;
  int cell = 0;
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
    absorbed = absorbed_io[i] != 0;
  }
  // the warp steps until its last packet ends (the deposits are warp-wide)
  for (int s = 0; __ballot_sync(kAll, active) != 0u; ++s) {
    int id = -1;  // the cell of this step's deposit; -1: no packet
    float dep = 0.0f;
    if (active) {
      const int64_t row = cell;
      float t_exit;
      const int k_exit = exit_face_packed(faces, __ldg(face_count + row), row, K,
                                          px, py, pz, dx, dy, dz, &t_exit);
      const float ell =
          step(nbr, shifts, row, K, k_exit, t_exit, __ldg(chi + row), eps, px,
               py, pz, dx, dy, dz, cell, tau_left, active, absorbed);
      id = static_cast<int>(row);
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
    cmi_warp::run_deposit(tally, id, dep, lane);
  }
}

}  // namespace

// Launches K6 on `stream`; returns cudaGetLastError() (0 on success).
// faces holds n_cells*K float4 (normal, offset), face_count n_cells ints,
// nbr n_cells*K ints, shifts n_cells*K*3 floats; chi and tally n_cells floats
// (box units); pos/dirn 3n floats ([P, 3]); cell, tau, weight and the byte
// flags n values.  Packet state and the tally are updated in place.
extern "C" int cmi_trace_voronoi(const float* faces, const int* face_count,
                                 const int* nbr, const float* shifts,
                                 const float* chi, float* tally, float* pos,
                                 const float* dirn, int* cell, float* tau,
                                 const float* weight, uint8_t* active,
                                 uint8_t* absorbed, int n, int n_cells, int K,
                                 int max_steps, float eps, void* stream) {
  if (n > 0 && n_cells > 0 && K > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    trace_voronoi_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(faces), face_count, nbr, shifts, chi,
        tally, pos, dirn, cell, tau, weight, active, absorbed, n, K, max_steps,
        eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// The registers a thread of K6 takes and its blocks resident on one SM of the
// current device, and that device's SM count; returns the CUDA error (0 on
// success).
extern "C" int cmi_trace_voronoi_occupancy(int* registers, int* blocks_per_sm,
                                           int* sms) {
  return cmi_occupancy::query(trace_voronoi_kernel, kThreads, registers,
                              blocks_per_sm, sms);
}
