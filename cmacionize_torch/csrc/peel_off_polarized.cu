// K8p: the polarized dust peel-off, one thread per scattering event: the
// march toward the observer, the CCD pixel, the White (1979) matrix toward
// the observer, the rotation of Q/U into the CCD frame and the four Stokes
// deposits, fused.
//
// Replaces the peel-off of cmacionize_tpu/models/dust_simulation.py:
// run_polarized (:509-518): peel_off_polarized
// (cmacionize_tpu/ops/polarization.py:156, with scattering_matrix :64 and
// rotate_stokes :87), _peel_off_tau (:243), _ccd_pixel (:268) and the four
// ccd[k].at[pix].add.  The plain PyTorch version is
// cmacionize_torch/ops/peel_off.py:peel_off_polarized_reference.
//
// Each active event marches to the box edge accumulating tau with no tally
// (peel_march.cuh), evaluates peel_off_polarized in the JAX package's f32
// operation order (one rounding per operation: the 3-term dots left to
// right, the band constants formed in double on the host and rounded once,
// as JAX's weakly typed Python scalars are), multiplies each component by
// albedo * exp(-tau) and makes one atomicAdd into each of the four planes.
// Inactive events add nothing and read no chi.  tau and the pixel equal the
// plain version's; acos, cos, exp and pow may differ from torch's in the
// last bit, and the atomics add in another order.
//
// What bounds it on an H100: the march, K8's (peel_march.cuh: the wall
// quotients by the direction's reciprocals, chi read a batch of steps at a
// time, chi in L2; the events in the driver's order); the matrix adds ~250
// operations per event and four atomics into four 160 kB planes.

#include "peel_march.cuh"

namespace {

struct Band {
  float one_minus_g2, one_plus_g2, two_g;  // 1 - g^2, 1 + g^2, 2 g
  float minus_pl, minus_pc, sc_skew;       // -pl, -pc, sc * 3.13
  float albedo;
};

constexpr float kInv4Pi = static_cast<float>(1.0 / (4.0 * 3.14159265358979323846));
constexpr float kPi = static_cast<float>(3.14159265358979323846);

// Mueller rotation of (Q, U) by the angle whose cosine and sine are c, s.
__device__ __forceinline__ void rotate_stokes(float Q, float U, float c, float s,
                                              float* Qr, float* Ur) {
  const float cos2 = c * c - s * s;
  const float sin2 = 2.0f * s * c;
  *Qr = Q * cos2 + U * sin2;
  *Ur = -Q * sin2 + U * cos2;
}

__global__ void __launch_bounds__(cart::kThreads) peel_off_polarized_kernel(
    const float* __restrict__ chi, const float* __restrict__ position,
    const float* __restrict__ direction, const float* __restrict__ nref,
    const float* __restrict__ I_in, const float* __restrict__ Q_in,
    const float* __restrict__ U_in, const float* __restrict__ V_in,
    const uint8_t* __restrict__ active, float* __restrict__ ccd_I,
    float* __restrict__ ccd_Q, float* __restrict__ ccd_U, float* __restrict__ ccd_V,
    float* __restrict__ tau_out, int* __restrict__ pix_out, int n, peel::View v, Band b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!active[i]) {
    if (tau_out) tau_out[i] = 0.0f;
    if (pix_out) pix_out[i] = -1;
    return;
  }
  const float gx = position[3 * i], gy = position[3 * i + 1], gz = position[3 * i + 2];
  const float tau = peel::march_tau(chi, gx, gy, gz, v);
  const int pix = peel::ccd_pixel(gx, gy, gz, v);

  const float o0 = v.phase[0], o1 = v.phase[1], o2 = v.phase[2];
  const float dx = direction[3 * i], dy = direction[3 * i + 1], dz = direction[3 * i + 2];
  const float nx = nref[3 * i], ny = nref[3 * i + 1], nz = nref[3 * i + 2];
  const float I = I_in[i], Q = Q_in[i], U = U_in[i], V = V_in[i];

  const float cos_t = dx * o0 + dy * o1 + dz * o2;
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  const bool degenerate = sin_t < 1e-6f;
  const float safe_sin = fmaxf(sin_t, 1e-20f);
  // incoming in-plane Q axis; the carried reference when d || o
  const float lx = degenerate ? nx : (o0 - cos_t * dx) / safe_sin;
  const float ly = degenerate ? ny : (o1 - cos_t * dy) / safe_sin;
  const float lz = degenerate ? nz : (o2 - cos_t * dz) / safe_sin;
  // rotation from nref to l_in about d
  const float cos_psi = nx * lx + ny * ly + nz * lz;
  const float tx = dy * nz - dz * ny, ty = dz * nx - dx * nz, tz = dx * ny - dy * nx;
  const float sin_psi = tx * lx + ty * ly + tz * lz;
  float Qr, Ur;
  rotate_stokes(Q, U, cos_psi, sin_psi, &Qr, &Ur);

  // White (1979) matrix elements (scattering_matrix)
  const float cos2 = cos_t * cos_t;
  const float P1 = b.one_minus_g2 * powf(b.one_plus_g2 - b.two_g * cos_t, -1.5f);
  const float inv1c2 = 1.0f / (1.0f + cos2);
  const float P2 = b.minus_pl * P1 * (1.0f - cos2) * inv1c2;
  const float P3 = 2.0f * P1 * cos_t * inv1c2;
  const float theta = acosf(fminf(fmaxf(cos_t, -1.0f), 1.0f));
  const float cos_skew = cosf(theta + b.sc_skew * theta * expf(-7.0f * theta / kPi));
  const float cos2_skew = cos_skew * cos_skew;
  const float P4 = b.minus_pc * P1 * (1.0f - cos2_skew) / (1.0f + cos2_skew);

  const float I_obs = (P1 * I + P2 * Qr) * kInv4Pi;
  const float Q_obs = (P2 * I + P1 * Qr) * kInv4Pi;
  const float U_obs = (P3 * Ur + P4 * V) * kInv4Pi;
  const float V_obs = (-P4 * Ur + P3 * V) * kInv4Pi;

  // outgoing in-plane Q axis, rotated into the CCD frame (x axis e1) about o
  const float ox = degenerate ? nx : cos_t * lx - sin_t * dx;
  const float oy = degenerate ? ny : cos_t * ly - sin_t * dy;
  const float oz = degenerate ? nz : cos_t * lz - sin_t * dz;
  const float cos_chi = ox * v.e1[0] + oy * v.e1[1] + oz * v.e1[2];
  const float cx = o1 * oz - o2 * oy, cy = o2 * ox - o0 * oz, cz = o0 * oy - o1 * ox;
  const float sin_chi = cx * v.e1[0] + cy * v.e1[1] + cz * v.e1[2];
  float Q_ccd, U_ccd;
  rotate_stokes(Q_obs, U_obs, cos_chi, sin_chi, &Q_ccd, &U_ccd);

  const float att = b.albedo * expf(-tau);
  atomicAdd(ccd_I + pix, I_obs * att);
  atomicAdd(ccd_Q + pix, Q_ccd * att);
  atomicAdd(ccd_U + pix, U_ccd * att);
  atomicAdd(ccd_V + pix, V_obs * att);
  if (tau_out) tau_out[i] = tau;
  if (pix_out) pix_out[i] = pix;
}

}  // namespace

// Launches K8p on `stream`; returns cudaGetLastError() (0 on success).
// position, direction and nref are [n, 3] row-major f32; I, Q, U, V [n] f32;
// active [n] bytes; the four planes [npx * npy] f32 (added into); tau_out
// [n] f32 and pix_out [n] int32 may be nullptr.  view_f / view_i are host
// arrays of peel::kViewFloats / peel::kViewInts values; the seven floats are
// 1 - g^2, 1 + g^2, 2 g, -pl, -pc, 3.13 sc and the albedo, each formed in
// double on the host and rounded once to f32.
extern "C" int cmi_peel_off_polarized(
    const float* chi, const float* position, const float* direction, const float* nref,
    const float* I, const float* Q, const float* U, const float* V, const uint8_t* active,
    float* ccd_I, float* ccd_Q, float* ccd_U, float* ccd_V, float* tau_out, int* pix_out,
    const float* view_f, const int* view_i, int n, float one_minus_g2, float one_plus_g2,
    float two_g, float minus_pl, float minus_pc, float sc_skew, float albedo, void* stream) {
  if (n > 0) {
    const Band b{one_minus_g2, one_plus_g2, two_g, minus_pl, minus_pc, sc_skew, albedo};
    const int blocks = (n + cart::kThreads - 1) / cart::kThreads;
    peel_off_polarized_kernel<<<blocks, cart::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        chi, position, direction, nref, I, Q, U, V, active, ccd_I, ccd_Q, ccd_U, ccd_V,
        tau_out, pix_out, n, peel::make_view(view_f, view_i), b);
  }
  return static_cast<int>(cudaGetLastError());
}
