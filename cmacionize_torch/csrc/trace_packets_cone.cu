// K10: the cone march, one block per chunk of 512 direction-coherent packets,
// one thread per packet.
//
// Replaces tools/experimental_cone_kernel.py:trace_packets_cone (its Pallas
// kernel, _make_kernel).  The plain PyTorch version is cmacionize_torch/tools/
// experimental_cone_kernel.py:trace_packets_cone_reference, a transcription
// of the Pallas kernel's arithmetic.
//
// Each phase of a chunk:
//   * the lagging active lane, the least signed cell sum (sx*cx + sy*cy +
//     sz*cz) with ties to the highest lane, is found by a block-wide minimum
//     of the exact key (metric, 511 - lane); its cell and signs place the 8^3
//     slab, clamped into the grid;
//   * the slab's chi is loaded into shared memory;
//   * every lane whose cell lies in the slab walks its own ray through the
//     slab cells whose path length l is positive.  l comes from the plain
//     version's formula (per-axis entry and exit plane times, max of the
//     entries clamped at 0, min of the exits), so each l equals the plain
//     version's.  The cells are visited in lexicographic travel order, a
//     linear extension of the componentwise order that the Pallas prefix
//     scans follow, so a running sum gives the optical depth at each cell's
//     entry.  The walk enumerates the l > 0 set from the per-axis plane times
//     (which are monotone along travel) and does not start from the lane's
//     cell index: the nudged cell of the last phase may lie one cell past the
//     position, and the sliver before it has l > 0.  The first cell whose
//     running sum passes tau_left absorbs the lane, at t_lo + (tau -
//     entry tau) / max(chi, 1e-30), with the deposit l * frac * w;
//   * deposits are summed in shared buffers, then each nonzero slab cell is
//     added to the tally with one atomicAdd;
//   * lanes advance to the absorption point or the slab exit (p + d*t as an
//     FMA, as XLA fuses the Pallas kernel's on the CPU), and their new cells
//     are floor(q + ds*t +- 1e-4) (the same FMA), with the state codes of the
//     Pallas kernel (0 active, 1 absorbed, 2 escaped).
// The loop runs while phase < max_phases and any lane of the chunk is active.
//
// What differs from the plain version: the running sum adds a lane's cells
// in travel order, where the plain version takes a sum over the slab and
// prefix scans, so tau_left differs at f32 round-off, and a lane whose
// tau_left lies within round-off of the slab's total may change state or be
// absorbed one slab earlier or later; where round-off lets two cells'
// prefix-scan intervals overlap at tau_left, the plain version (as the Pallas
// kernel) adds both cells' absorption times, and K10 takes the first cell's,
// which the plain version records; the plain version scales a non-absorbed
// lane's deposits by a clamped fraction that can round below 1 in a chunk
// with an absorption; the blocks of chunks run concurrently and add into the
// tally with atomics, where the TPU grid added chunk after chunk.  The tally
// therefore agrees to f32 reassociation.
//
// What bounds it on an H100: each phase waits for the chunk's slowest lane,
// and a lane's walk is a dependent chain of plane times, compares and a
// deposit per candidate cell (about 20-30 per slab); chi and the tally (1 MB
// each at 64^3) stay in L2.  The lanes of a warp take loops of their own
// lengths, so a warp runs its lanes' walks largely one after another.  The first
// port's kernel spent ~2400 cycles of a warp per candidate cell on phase 32's final
// chi (13000 where every lane of a chunk is absorbed in the source's cell):
// direction-coherent lanes deposit into the same cells, and a float
// atomicAdd on shared memory is a compare-and-swap loop (ATOMS.CAST.SPIN)
// that one contending lane at a time leaves.  The design (redesigned from
// the first port's):
//   * each warp deposits into an 8^3 buffer of its own, so that a shared
//     atomic meets no other warp's; the flush sums the 16 buffers of a cell
//     in warp order (summing a warp's lanes by shuffles first, or walking the
//     three loops as one loop so that a warp's lanes stay together, cost
//     more than they saved: PERF.md §6);
//   * a plane time is (g + e - q) / ds with ds, the lane's clamped direction,
//     fixed for the whole march.  Each lane forms r = RN(1 / ds) once, and
//     each quotient is q0 = a r, e = fma(-ds, q0, a), t = fma(e, r, q0), which
//     Markstein's theorem makes RN(a / ds), the IEEE quotient, bit for bit,
//     for a = 0 and for |a| >= 2^-64 (the exact remainder and a normal
//     quotient: 1e-9 <= |ds| <= 1); a smaller numerator, a plane within
//     2^-64 of a position, divides with __fdiv_rn.  So every plane time, and
//     every state and position, is the first port's kernel's bit for bit, without an
//     IEEE division's range test, branch and Newton steps;
//   * a phase has two barriers: the lag keys (a warp's __reduce_min_sync,
//     then one over the 16 warps' minima, which every thread takes) and the
//     corner that each lane would give are published together, so the corner
//     needs no barrier of its own, and the last phase's deposits are flushed
//     after the next phase's first barrier, each thread its own slab cell;
//     the first port's kernel had five (an any-active vote, the keys, the corner, the
//     slab, the walk);
//   * a lane's direction and weight sit in shared memory, read where the walk
//     and the advance need them, so that the kernel fits kBlocksPerSm blocks
//     of 512 an SM (the first port's: 59 registers, 2 blocks).
// Built with --fmad=false: the only fused multiply-adds are the explicit
// __fmaf_rn.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"

namespace {

constexpr int kS = 8;
constexpr int kS3 = kS * kS * kS;
constexpr int kC = 512;
constexpr int kWarps = kC / 32;
constexpr int kBlocksPerSm = 3;
// deposit buffers in shared memory: one a warp, so that a shared atomic meets
// no other warp's (a float atomicAdd on shared memory retries a
// compare-and-swap while another lane holds the word)
constexpr int kDepositBuffers = kWarps;
constexpr float kEpsDir = 1e-9f;
constexpr float kNudge = 1e-4f;
constexpr float kTiny = 1e-30f;
// the least nonzero numerator whose quotient by a clamped direction the
// reciprocal form rounds as the IEEE division does
constexpr float kLeastNumerator = 0x1p-64f;
constexpr int kIdle = INT_MAX;  // the lag key of a lane that is not active

// RN(a / ds) from r = RN(1 / ds), 1e-9 <= |ds| <= 1
__device__ __forceinline__ float quotient(float a, float ds, float r) {
  if (fabsf(a) >= kLeastNumerator || a == 0.0f) {
    const float q0 = a * r;
    const float e = __fmaf_rn(-ds, q0, a);
    return __fmaf_rn(e, r, q0);
  }
  return __fdiv_rn(a, ds);
}

// the clamped direction component of a lane
__device__ __forceinline__ float clamped(float d) {
  return d > 0.0f ? fmaxf(d, kEpsDir) : fminf(d, -kEpsDir);
}

// One axis of a lane's ray in slab-local cell units.
struct Axis {
  float q;   // position
  float ds;  // direction, magnitude clamped to >= 1e-9
  float r;   // RN(1 / ds)
  bool pos;  // travelling +

  __device__ __forceinline__ Axis(float p, int b, float d, float rcp)
      : q(p - static_cast<float>(b)), ds(clamped(d)), r(rcp), pos(d > 0.0f) {}
  // exit time minus entry time of a cell: (+1 or -1) / ds
  __device__ __forceinline__ float inv() const { return pos ? r : -r; }
  // the cell at the k-th place in travel order
  __device__ __forceinline__ int cell(int k) const { return pos ? k : kS - 1 - k; }
  // entry-plane time of cell g: its plane is g for + travel, g + 1 for -
  __device__ __forceinline__ float t_in(int g) const {
    return quotient(static_cast<float>(g) + (pos ? 0.0f : 1.0f) - q, ds, r);
  }
  __device__ __forceinline__ float t_exit() const {
    return quotient((pos ? static_cast<float>(kS) : 0.0f) - q, ds, r);
  }
  __device__ __forceinline__ int next_cell(float t) const {
    return static_cast<int>(floorf(__fmaf_rn(ds, t, q) + (pos ? kNudge : -kNudge)));
  }
};

__global__ void __launch_bounds__(kC, kBlocksPerSm) trace_packets_cone_kernel(
    const float* __restrict__ chi, float* __restrict__ tally, float* __restrict__ pf,
    int* __restrict__ pi, int nx, int ny, int nz, int max_phases) {
  __shared__ float s_chi[kS3];
  __shared__ float s_dep[kDepositBuffers][kS3];
  __shared__ float4 s_dir[kC];  // dx, dy, dz, weight
  __shared__ int2 s_corner[kC];  // the corner each lane would give: x | y << 16, z
  __shared__ int s_key[kWarps];

  const int lane = threadIdx.x;
  const long long row = (static_cast<long long>(blockIdx.x) * kC + lane) * 8;
  const float4 f0 = reinterpret_cast<const float4*>(pf + row)[0];
  const float4 f1 = reinterpret_cast<const float4*>(pf + row)[1];
  const int4 i0 = reinterpret_cast<const int4*>(pi + row)[0];
  float px = f0.x, py = f0.y, pz = f0.z, tau = f1.z;
  int cx = i0.x, cy = i0.y, cz = i0.z, state = i0.w;
  s_dir[lane] = make_float4(f0.w, f1.x, f1.y, f1.w);
  const bool sx = f0.w > 0.0f, sy = f1.x > 0.0f, sz = f1.y > 0.0f;
  const float rx = __frcp_rn(clamped(f0.w));
  const float ry = __frcp_rn(clamped(f1.x));
  const float rz = __frcp_rn(clamped(f1.y));
  // the lag metric lies in [-(nx + ny + nz), nx + ny + nz]: shifted by that,
  // (metric, 511 - lane) orders as one non-negative int
  const int offset = nx + ny + nz;
  for (int w = 0; w < kDepositBuffers; ++w) s_dep[w][lane] = 0.0f;
  float* const my_dep = s_dep[(lane >> 5) % kDepositBuffers];
  int bx = 0, by = 0, bz = 0;  // the last phase's slab, whose deposits wait
  bool pending = false;

  for (int phase = 0;; ++phase) {
    // --- publish this lane's lag key and the corner it would give; the last
    // phase's walks end at the barrier
    int key = kIdle;
    if (state == 0 && phase < max_phases) {
      const int metric = (sx ? cx : -cx) + (sy ? cy : -cy) + (sz ? cz : -cz);
      key = (metric + offset) * kC + (kC - 1 - lane);
    }
    key = __reduce_min_sync(0xffffffffu, key);
    if ((lane & 31) == 0) s_key[lane >> 5] = key;
    s_corner[lane] = make_int2(min(max(sx ? cx : cx - (kS - 1), 0), nx - kS) |
                                   (min(max(sy ? cy : cy - (kS - 1), 0), ny - kS) << 16),
                               min(max(sz ? cz : cz - (kS - 1), 0), nz - kS));
    __syncthreads();

    // --- the last phase's deposits into the tally, one atomic per nonzero
    // slab cell, each thread its own cell (the buffers summed in warp order)
    if (pending) {
      float v = 0.0f;
      for (int w = 0; w < kDepositBuffers; ++w) {
        v += s_dep[w][lane];
        s_dep[w][lane] = 0.0f;
      }
      if (v != 0.0f) {
        const int i = lane / (kS * kS), j = (lane / kS) % kS, k = lane % kS;
        atomicAdd(tally + (static_cast<long long>(bx + i) * ny + (by + j)) * nz + (bz + k), v);
      }
    }
    // --- the lagging lane: the least key of the 16 warps' minima; its
    // corner places the slab
    const int best = __reduce_min_sync(0xffffffffu, s_key[lane & (kWarps - 1)]);
    if (best == kIdle) break;
    const int2 corner = s_corner[kC - 1 - (best & (kC - 1))];
    bx = corner.x & 0xffff;
    by = corner.x >> 16;
    bz = corner.y;
    pending = true;

    // --- the slab's chi, one cell per thread
    {
      const int i = lane / (kS * kS), j = (lane / kS) % kS, k = lane % kS;
      s_chi[lane] = __ldg(chi + (static_cast<long long>(bx + i) * ny + (by + j)) * nz + (bz + k));
    }
    __syncthreads();

    const int gx = cx - bx, gy = cy - by, gz = cz - bz;
    const bool march = state == 0 && gx >= 0 && gx < kS && gy >= 0 && gy < kS && gz >= 0 &&
                       gz < kS;
    if (march) {
      const float4 dir = s_dir[lane];
      const Axis X(px, bx, dir.x, rx), Y(py, by, dir.y, ry), Z(pz, bz, dir.z, rz);
      // exit times of the last cells in travel order: an entry at or past
      // one of them leaves l = 0 for every later cell
      const float toy_last = Y.t_in(Y.cell(kS - 1)) + Y.inv();
      const float toz_last = Z.t_in(Z.cell(kS - 1)) + Z.inv();
      float run = 0.0f;  // optical depth at the entry of the current cell
      float t_abs = 0.0f;
      bool absorbed = false;
      int ky0 = 0, kz0 = 0;  // places before these are behind every later cell
      for (int kx = 0; kx < kS && !absorbed; ++kx) {
        const int cgx = X.cell(kx);
        const float txi = X.t_in(cgx);
        const float txo = txi + X.inv();
        if (!(txo > 0.0f)) continue;
        if (txi >= toy_last || txi >= toz_last) break;
        const float lo_x = fmaxf(txi, 0.0f);
        int kz_lb = kz0;
        bool first_y = true;
        for (int ky = ky0; ky < kS && !absorbed; ++ky) {
          const int cgy = Y.cell(ky);
          const float tyi = Y.t_in(cgy);
          const float tyo = tyi + Y.inv();
          if (!(tyo > lo_x)) {
            ky0 = ky + 1;
            continue;
          }
          if (tyi >= txo || tyi >= toz_last) break;
          const float lo_xy = fmaxf(lo_x, tyi);
          const float hi_xy = fminf(txo, tyo);
          for (int kz = kz_lb; kz < kS; ++kz) {
            const int cgz = Z.cell(kz);
            const float tzi = Z.t_in(cgz);
            const float tzo = tzi + Z.inv();
            if (!(tzo > lo_xy)) {
              kz_lb = kz + 1;
              continue;
            }
            if (tzi >= hi_xy) break;
            // the plain version's l of this cell
            const float t_lo = fmaxf(fmaxf(txi, fmaxf(tyi, tzi)), 0.0f);
            const float ell = fmaxf(fminf(txo, fminf(tyo, tzo)) - t_lo, 0.0f);
            if (!(ell > 0.0f)) continue;
            const int slot = (cgx * kS + cgy) * kS + cgz;
            const float c = s_chi[slot];
            const float chiell = ell * c;
            const float cum = run + chiell;
            if (tau < cum) {  // absorbed in this cell
              const float frac = fminf(fmaxf((tau - run) / fmaxf(chiell, kTiny), 0.0f), 1.0f);
              atomicAdd(my_dep + slot, ell * frac * dir.w);
              t_abs = t_lo + (tau - run) / fmaxf(c, kTiny);
              absorbed = true;
              break;
            }
            atomicAdd(my_dep + slot, ell * dir.w);
            run = cum;
          }
          if (first_y) kz0 = kz_lb;
          first_y = false;
        }
      }
      const float t_use = absorbed ? t_abs : fminf(X.t_exit(), fminf(Y.t_exit(), Z.t_exit()));
      px = __fmaf_rn(dir.x, t_use, px);
      py = __fmaf_rn(dir.y, t_use, py);
      pz = __fmaf_rn(dir.z, t_use, pz);
      cx = X.next_cell(t_use) + bx;
      cy = Y.next_cell(t_use) + by;
      cz = Z.next_cell(t_use) + bz;
      const bool outside = cx < 0 || cx >= nx || cy < 0 || cy >= ny || cz < 0 || cz >= nz;
      tau = absorbed ? 0.0f : tau - run;
      state = absorbed ? 1 : (outside ? 2 : 0);
    }
  }

  reinterpret_cast<float2*>(pf + row)[0] = make_float2(px, py);
  pf[row + 2] = pz;
  pf[row + 6] = tau;
  reinterpret_cast<int4*>(pi + row)[0] = make_int4(cx, cy, cz, state);
  reinterpret_cast<int4*>(pi + row)[1] = make_int4(0, 0, 0, 0);
}

}  // namespace

// Launches K10 on `stream`; returns cudaGetLastError() (0 on success).
// chi and tally are [nx, ny, nz] f32 (the tally zeroed by the caller), pf and
// pi the [n, 8] f32 / i32 packet rows, updated in place (the directions and
// weights of pf are left as they are); n % 512 == 0, every grid side in
// [8, 2^15) and nx + ny + nz < 2^21.
extern "C" int cmi_trace_packets_cone(const float* chi, float* tally, float* pf, int* pi,
                                      int n, int nx, int ny, int nz, int max_phases,
                                      void* stream) {
  if (n > 0) {
    trace_packets_cone_kernel<<<n / kC, kC, 0, static_cast<cudaStream_t>(stream)>>>(
        chi, tally, pf, pi, nx, ny, nz, max_phases);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and resident blocks of 512 per SM of K10, and the SM
// count (csrc/occupancy.cuh).
extern "C" int cmi_trace_packets_cone_occupancy(int* registers, int* blocks_per_sm, int* sms) {
  return cmi_occupancy::query(trace_packets_cone_kernel, kC, registers, blocks_per_sm, sms);
}
