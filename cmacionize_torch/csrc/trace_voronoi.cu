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
// Per step, as in the JAX march: the K faces of the packet's cell are read
// from the padded [C, K] rows (neighbours int32, normals f32 x 3, offsets,
// shifts f32 x 3), the exit face is the first of least plane distance, the
// packet is absorbed inside the cell if chi * t >= tau_left, ell * w is added
// to tally[cell] with atomicAdd, and a crossing packet moves ell + eps along
// its direction, takes the face's shift and enters the neighbour (-1: it
// escapes).  A packet handed in inactive returns at once; at most max_steps
// steps; the final state (position, cell, tau_left, flags) is written back.
// The step itself is in voronoi_march.cuh, shared with K6s.
//
// Precision: built with --fmad=false and without fast math; the FMAs that
// XLA on the CPU forms are written out (voronoi_march.cuh).  Only the order
// in which atomics add into the tally differs from the plain version.
//
// What bounds it on an H100: per step a packet reads its cell's K rows,
// 32 B per face (25 faces: 800 B), plus one chi gather and one atomicAdd.
// At 40000 cells x K = 25 the four tables hold 32 MB, which fits the 50 MB
// L2, so the rows come from L2, not HBM; the face loop is ~25 x 10 f32
// operations.  Threads of a warp sit in different cells, so the row reads
// do not coalesce, and warps diverge as packets terminate.  Staging rows in
// shared memory, packing a face into 16 B, or sorting packets by cell are
// later work.

#include "voronoi_march.cuh"

namespace {

using namespace cmi_voronoi;

__global__ void __launch_bounds__(kThreads) trace_voronoi_kernel(
    const int* __restrict__ nbr, const float* __restrict__ normals,
    const float* __restrict__ offsets, const float* __restrict__ shifts,
    const float* __restrict__ chi, float* __restrict__ tally,
    float* __restrict__ pos_io, const float* __restrict__ dirn,
    int* __restrict__ cell_io, float* __restrict__ tau_io,
    const float* __restrict__ weight, uint8_t* __restrict__ active_io,
    uint8_t* __restrict__ absorbed_io, int n, int K, float eps,
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
  bool absorbed = absorbed_io[i] != 0;

  for (int s = 0; active && s < max_steps; ++s) {
    const int64_t row = cell;
    float t_exit;
    const int k_exit = exit_face(nbr, normals, offsets, row, K, px, py, pz,
                                 dx, dy, dz, &t_exit);
    const float ell =
        step(nbr, shifts, row, K, k_exit, t_exit, __ldg(chi + row), eps, px,
             py, pz, dx, dy, dz, cell, tau_left, active, absorbed);
    atomicAdd(tally + row, ell * w);
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

// Launches K6 on `stream`; returns cudaGetLastError() (0 on success).
// nbr/offsets hold n_cells*K values, normals/shifts n_cells*K*3; chi and
// tally n_cells floats (box units); pos/dirn 3n floats ([P, 3]); cell, tau,
// weight and the byte flags n values.  Packet state is updated in place.
extern "C" int cmi_trace_voronoi(const int* nbr, const float* normals,
                                 const float* offsets, const float* shifts,
                                 const float* chi, float* tally, float* pos,
                                 const float* dirn, int* cell, float* tau,
                                 const float* weight, uint8_t* active,
                                 uint8_t* absorbed, int n, int n_cells, int K,
                                 float eps, int max_steps, void* stream) {
  if (n > 0 && n_cells > 0 && K > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    trace_voronoi_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        nbr, normals, offsets, shifts, chi, tally, pos, dirn, cell, tau,
        weight, active, absorbed, n, K, eps, max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}
