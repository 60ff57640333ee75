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
//     of the exact 64-bit key (metric, 511 - lane); its cell and signs place
//     the 8^3 slab, clamped into the grid;
//   * the slab's chi is loaded into shared memory beside an 8^3 deposit
//     buffer;
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
//   * deposits are summed in the shared buffer, then each nonzero slab cell
//     is added to the tally with one atomicAdd;
//   * lanes advance to the absorption point or the slab exit (p + d*t as an
//     FMA, as XLA fuses the Pallas kernel's on the CPU), and their new cells
//     are floor(q + ds*t +- 1e-4) (the same FMA), with the state codes of the
//     Pallas kernel (0 active, 1 absorbed, 2 escaped).
// The loop runs while phase < max_phases and any lane of the chunk is active.
//
// What differs from the plain version: the running sum adds a lane's cells
// in travel order, where the plain version takes a sum over the slab and
// prefix scans, so tau_left differs at f32 round-off, and a lane whose
// tau_left lies within round-off of the slab's total may change state; the
// plain version scales a non-absorbed lane's deposits by a clamped fraction
// that can round below 1 in a chunk with an absorption; the blocks of chunks
// run concurrently and add into the tally with atomics, where the TPU grid
// added chunk after chunk.  The tally therefore agrees to f32 reassociation.
//
// What bounds it on an H100: the lane's walk, a dependent chain of IEEE
// divisions and compares per candidate cell (about 20-30 per slab), and the
// shared-memory atomics of coherent lanes that deposit into the same few
// cells; chi and the tally (1 MB each at 64^3) stay in L2.  A chunk's blocks
// run as long as its slowest lane, and lanes on the chunk's lagging edge set
// the slab.  Built with --fmad=false: the only fused multiply-adds are the
// explicit __fmaf_rn.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kS = 8;
constexpr int kS3 = kS * kS * kS;
constexpr int kC = 512;
constexpr int kWarps = kC / 32;
constexpr float kEpsDir = 1e-9f;
constexpr float kNudge = 1e-4f;
constexpr float kTiny = 1e-30f;
constexpr int kBig = 1 << 30;

// One axis of a lane's ray in slab-local cell units.
struct Axis {
  float q;    // position
  float ds;   // direction, magnitude clamped to >= 1e-9
  float e;    // entry-plane offset of a cell: 0 for + travel, 1 for -
  float inv;  // (+1 or -1) / ds: exit time minus entry time
  bool pos;   // travelling +

  __device__ __forceinline__ Axis(float p, int b, float d) {
    pos = d > 0.0f;
    ds = pos ? fmaxf(d, kEpsDir) : fminf(d, -kEpsDir);
    q = p - static_cast<float>(b);
    e = pos ? 0.0f : 1.0f;
    inv = (pos ? 1.0f : -1.0f) / ds;
  }
  // the cell at the k-th place in travel order
  __device__ __forceinline__ int cell(int k) const { return pos ? k : kS - 1 - k; }
  __device__ __forceinline__ float t_in(int g) const {
    return (static_cast<float>(g) + e - q) / ds;
  }
  __device__ __forceinline__ float t_exit() const {
    return ((pos ? static_cast<float>(kS) : 0.0f) - q) / ds;
  }
  __device__ __forceinline__ int next_cell(float t) const {
    return static_cast<int>(floorf(__fmaf_rn(ds, t, q) + (pos ? kNudge : -kNudge)));
  }
};

__global__ void __launch_bounds__(kC) trace_packets_cone_kernel(
    const float* __restrict__ chi, float* __restrict__ tally,
    float* __restrict__ pf, int* __restrict__ pi, int nx, int ny, int nz,
    int max_phases) {
  __shared__ float s_chi[kS3];
  __shared__ float s_dep[kS3];
  __shared__ long long s_key[kWarps];
  __shared__ int s_corner[3];

  const int lane = threadIdx.x;
  const long long row = (static_cast<long long>(blockIdx.x) * kC + lane) * 8;
  const float4 f0 = reinterpret_cast<const float4*>(pf + row)[0];
  const float4 f1 = reinterpret_cast<const float4*>(pf + row)[1];
  const int4 i0 = reinterpret_cast<const int4*>(pi + row)[0];
  float px = f0.x, py = f0.y, pz = f0.z;
  const float dx = f0.w, dy = f1.x, dz = f1.y;
  float tau = f1.z;
  const float w = f1.w;
  int cx = i0.x, cy = i0.y, cz = i0.z, state = i0.w;
  const bool sx = dx > 0.0f, sy = dy > 0.0f, sz = dz > 0.0f;

  for (int phase = 0; phase < max_phases && __syncthreads_or(state == 0); ++phase) {
    // --- the lagging active lane: least metric, ties to the highest lane
    const int metric = state == 0 ? (sx ? cx : -cx) + (sy ? cy : -cy) + (sz ? cz : -cz) : kBig;
    long long key = static_cast<long long>(metric) * 4294967296LL + (kC - 1 - lane);
    for (int off = 16; off > 0; off >>= 1) {
      const long long other = __shfl_xor_sync(0xffffffffu, key, off);
      key = other < key ? other : key;
    }
    if ((lane & 31) == 0) s_key[lane >> 5] = key;
    __syncthreads();
    long long best = s_key[0];
    for (int k = 1; k < kWarps; ++k) best = s_key[k] < best ? s_key[k] : best;
    if (lane == kC - 1 - static_cast<int>(best & 0xffffffffLL)) {
      s_corner[0] = min(max(sx ? cx : cx - (kS - 1), 0), nx - kS);
      s_corner[1] = min(max(sy ? cy : cy - (kS - 1), 0), ny - kS);
      s_corner[2] = min(max(sz ? cz : cz - (kS - 1), 0), nz - kS);
    }
    __syncthreads();
    const int bx = s_corner[0], by = s_corner[1], bz = s_corner[2];

    // --- the slab's chi and a zeroed deposit buffer, one cell per thread
    {
      const int i = lane / (kS * kS), j = (lane / kS) % kS, k = lane % kS;
      s_chi[lane] = __ldg(chi + (static_cast<long long>(bx + i) * ny + (by + j)) * nz + (bz + k));
      s_dep[lane] = 0.0f;
    }
    __syncthreads();

    const int gx = cx - bx, gy = cy - by, gz = cz - bz;
    const bool march = state == 0 && gx >= 0 && gx < kS && gy >= 0 && gy < kS && gz >= 0 &&
                       gz < kS;
    if (march) {
      const Axis X(px, bx, dx), Y(py, by, dy), Z(pz, bz, dz);
      // exit times of the last cells in travel order: an entry at or past
      // one of them leaves l = 0 for every later cell
      const float toy_last = Y.t_in(Y.cell(kS - 1)) + Y.inv;
      const float toz_last = Z.t_in(Z.cell(kS - 1)) + Z.inv;
      float run = 0.0f;  // optical depth at the entry of the current cell
      float t_abs = 0.0f;
      bool absorbed = false;
      int ky0 = 0, kz0 = 0;  // places before these are behind every later cell
      for (int kx = 0; kx < kS && !absorbed; ++kx) {
        const int cgx = X.cell(kx);
        const float txi = X.t_in(cgx);
        const float txo = txi + X.inv;
        if (!(txo > 0.0f)) continue;
        if (txi >= toy_last || txi >= toz_last) break;
        const float lo_x = fmaxf(txi, 0.0f);
        int kz_lb = kz0;
        bool first_y = true;
        for (int ky = ky0; ky < kS && !absorbed; ++ky) {
          const int cgy = Y.cell(ky);
          const float tyi = Y.t_in(cgy);
          const float tyo = tyi + Y.inv;
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
            const float tzo = tzi + Z.inv;
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
              atomicAdd(s_dep + slot, ell * frac * w);
              t_abs = t_lo + (tau - run) / fmaxf(c, kTiny);
              absorbed = true;
              break;
            }
            atomicAdd(s_dep + slot, ell * w);
            run = cum;
          }
          if (first_y) kz0 = kz_lb;
          first_y = false;
        }
      }
      const float t_use = absorbed ? t_abs : fminf(X.t_exit(), fminf(Y.t_exit(), Z.t_exit()));
      px = __fmaf_rn(dx, t_use, px);
      py = __fmaf_rn(dy, t_use, py);
      pz = __fmaf_rn(dz, t_use, pz);
      cx = X.next_cell(t_use) + bx;
      cy = Y.next_cell(t_use) + by;
      cz = Z.next_cell(t_use) + bz;
      const bool outside = cx < 0 || cx >= nx || cy < 0 || cy >= ny || cz < 0 || cz >= nz;
      tau = absorbed ? 0.0f : tau - run;
      state = absorbed ? 1 : (outside ? 2 : 0);
    }
    __syncthreads();

    // --- the slab's deposits into the tally, one atomic per nonzero cell
    {
      const float v = s_dep[lane];
      if (v != 0.0f) {
        const int i = lane / (kS * kS), j = (lane / kS) % kS, k = lane % kS;
        atomicAdd(tally + (static_cast<long long>(bx + i) * ny + (by + j)) * nz + (bz + k), v);
      }
    }
  }

  reinterpret_cast<float4*>(pf + row)[0] = make_float4(px, py, pz, dx);
  reinterpret_cast<float4*>(pf + row)[1] = make_float4(dy, dz, tau, w);
  reinterpret_cast<int4*>(pi + row)[0] = make_int4(cx, cy, cz, state);
  reinterpret_cast<int4*>(pi + row)[1] = make_int4(0, 0, 0, 0);
}

}  // namespace

// Launches K10 on `stream`; returns cudaGetLastError() (0 on success).
// chi and tally are [nx, ny, nz] f32 (the tally zeroed by the caller), pf and
// pi the [n, 8] f32 / i32 packet rows, updated in place; n % 512 == 0 and
// every grid side >= 8.
extern "C" int cmi_trace_packets_cone(const float* chi, float* tally, float* pf, int* pi,
                                      int n, int nx, int ny, int nz, int max_phases,
                                      void* stream) {
  if (n > 0) {
    trace_packets_cone_kernel<<<n / kC, kC, 0, static_cast<cudaStream_t>(stream)>>>(
        chi, tally, pf, pi, nx, ny, nz, max_phases);
  }
  return static_cast<int>(cudaGetLastError());
}
