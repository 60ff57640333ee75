// K8: the dust peel-off, one thread per event: the march toward the
// observer, the CCD pixel, the phase and the deposit, fused.
//
// Replaces the peel-off of cmacionize_tpu/models/dust_simulation.py at
// emission and at every scattering order (run, :398-400 and :431-438):
// _peel_off_tau (:243, a full K1 march per event with a zero-weight tally),
// _ccd_pixel (:268), henyey_greenstein_phase (:99) and ccd.at[pix].add.
// The plain PyTorch version is cmacionize_torch/ops/peel_off.py:
// peel_off_deposit_reference with peel_off_factor.
//
// Each active event marches to the box edge accumulating tau, with no tally
// and no atomics on the way (peel_march.cuh), then forms its contribution
// in the JAX driver's f32 operation order:
//   emission:   (w / f32(4 pi)) * exp(-tau);
//   scattering: ((w * albedo) * HG(d . o)) * exp(-tau), with
//               HG = f32(1 - g^2) / (f32(4 pi) * pow(f32(1 + g^2) - f32(2 g) c, 1.5)),
//               c = (dx o0 + dy o1) + dz o2 (the numpy-normalized observer),
// and adds it into its pixel.  Inactive events (invalid emissions, packets
// that did not scatter) add nothing and read no chi.  tau and the pixel
// equal the plain version's; the phase, pow and exp may differ from torch's
// in the last bit, and the additions into a pixel come in another order.
//
// The events run in the order the driver drew them.  Sorting them by
// start cell (a key kernel and torch.sort) let a warp's lanes gather from
// neighbouring addresses and roughly halved K8's device time on the
// dusty_galaxy emission on an H100, but the sort's host time lengthened the
// dust runs, which the host binds (PERF.md), so K8 does without it.  Each
// event adds its contribution with an atomicAdd of its own (summing runs of
// lanes first, as K5 does, took longer).
//
// What bounds it on an H100: the march's chi gathers (201^3 f32 = 32 MB,
// held in the 50 MB L2), one a step, and its per-step chain of wall
// quotients, minima and the snap; the deposit is one atomic an event into a
// 160 kB image.

#include "peel_march.cuh"

namespace {

constexpr float kFourPi = static_cast<float>(4.0 * 3.14159265358979323846);

__global__ void __launch_bounds__(cart::kThreads) peel_off_kernel(
    const float* __restrict__ chi, const float* __restrict__ position,
    const float* __restrict__ direction, const float* __restrict__ weight,
    const uint8_t* __restrict__ active, float* __restrict__ ccd,
    float* __restrict__ tau_out, int* __restrict__ pix_out, int n, peel::View v,
    float albedo, float one_minus_g2, float one_plus_g2, float two_g) {
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
  float factor;
  if (direction == nullptr) {  // emission: isotropic
    factor = weight[i] / kFourPi;
  } else {
    const float c = direction[3 * i] * v.phase[0] + direction[3 * i + 1] * v.phase[1] +
                    direction[3 * i + 2] * v.phase[2];
    const float phase = one_minus_g2 / (kFourPi * powf(one_plus_g2 - two_g * c, 1.5f));
    factor = weight[i] * albedo * phase;
  }
  atomicAdd(ccd + pix, factor * expf(-tau));
  if (tau_out) tau_out[i] = tau;
  if (pix_out) pix_out[i] = pix;
}

}  // namespace

// Launches K8 on `stream`; returns cudaGetLastError() (0 on success).
// position (and direction, or nullptr at emission) are [n, 3] row-major f32,
// weight [n] f32, active [n] bytes, ccd [npx * npy] f32 (added into);
// tau_out [n] f32 and pix_out [n] int32 may be nullptr.  view_f and view_i
// are host arrays of peel::kViewFloats and peel::kViewInts values.
extern "C" int cmi_peel_off(const float* chi, const float* position, const float* direction,
                            const float* weight, const uint8_t* active, float* ccd,
                            float* tau_out, int* pix_out, const float* view_f,
                            const int* view_i, int n, float albedo, float one_minus_g2,
                            float one_plus_g2, float two_g, void* stream) {
  if (n > 0) {
    const int blocks = (n + cart::kThreads - 1) / cart::kThreads;
    peel_off_kernel<<<blocks, cart::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        chi, position, direction, weight, active, ccd, tau_out, pix_out, n,
        peel::make_view(view_f, view_i), albedo, one_minus_g2, one_plus_g2, two_g);
  }
  return static_cast<int>(cudaGetLastError());
}
