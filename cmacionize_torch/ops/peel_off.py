"""Peel-off toward the observer: the optical depth to the box edge, the CCD
pixel and the deposit of each emission or scattering event.

Port of the peel-off of ``cmacionize_tpu/models/dust_simulation.py``: at each
scattering order the JAX driver marches every event to the box edge along
the observer direction (``_peel_off_tau``, :243: K1's march with a target
τ of 1e4, zero weight and a tally nothing reads), projects it onto the CCD
(``_ccd_pixel``, :268) and adds weight · phase · exp(−τ) into its pixel
(:431-438); the polarized driver adds the four Stokes contributions of
``peel_off_polarized`` times albedo · exp(−τ) instead (:509-518).

:func:`peel_off_deposit` and :func:`peel_off_deposit_polarized` dispatch on
the device: CPU tensors go through the plain PyTorch versions
:func:`peel_off_deposit_reference` and :func:`peel_off_polarized_reference`
(that composite, step for step), CUDA tensors through K8
(``csrc/peel_off.cu``) and K8p (``csrc/peel_off_polarized.cu``).  There is
no fallback between the two.

The arithmetic is the JAX driver's as it runs in production (eager jnp
operations with ``jax_enable_x64`` off, so every value is f32):

* τ = 1e4 − τ_left in f32 after K1's march, so it resolves to ulp(1e4) ≈
  1e-3, and the march direction is the f32 observer vector divided by its
  norm as ``jnp.linalg.norm`` forms it (a chain of fused multiply-adds);
* the phase and the polarized peel-off take the observer vector normalized
  in numpy f32 (``np.linalg.norm``), a second vector that may differ from
  the first in the last bit;
* the CCD projection forms the SI position with one rounding per operation
  and its dot products with e1, e2 as XLA's dot does (``fma(z, e_z,
  fma(y, e_y, x·e_x))``), then ((u − anchor) / side) · pixels in f32,
  truncated toward zero and clipped into the edge pixels.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from cmacionize_torch.kernels.peel_off import peel_off_cuda
from cmacionize_torch.kernels.peel_off_polarized import peel_off_polarized_cuda
from cmacionize_torch.ops import polarization, traversal

#: the "never absorbed" target of the peel-off march.  It must stay well
#: within f32 resolution: 1e30 − τ == 1e30 in f32; 1e4 leaves τ a
#: resolution of ~1e-3, and no physical path here reaches τ ~ 1e4
TAU_TARGET = 1.0e4


class PeelOffView(NamedTuple):
    """What a peel-off needs of the grid, the observer and the CCD.  Every
    float is an f32 value held as a Python float, so torch ops on f32
    tensors and the kernels' float arguments see the same numbers."""

    shape: Tuple[int, int, int]
    periodic: Tuple[bool, bool, bool]
    march_direction: Tuple[float, float, float]  # the jnp-normalized observer
    phase_direction: Tuple[float, float, float]  # the numpy-normalized observer
    anchor: Tuple[float, float, float]  # box anchor (m)
    cell: Tuple[float, float, float]  # cell size (m)
    e1: Tuple[float, float, float]  # image-plane axes; e1 is the CCD's Q axis
    e2: Tuple[float, float, float]
    ccd_anchor: Tuple[float, float]  # image-plane window (m)
    ccd_sides: Tuple[float, float]
    pixels: Tuple[int, int]

    @property
    def max_steps(self) -> int:
        """K1's default step cap, 4·(nx+ny+nz): a march across the box takes
        at most nx+ny+nz steps."""
        return 4 * sum(self.shape)


def f32_values(values) -> tuple:
    """Each value rounded to f32, held as a Python float."""
    return tuple(float(v) for v in np.asarray(values, np.float32))


def observer_march_direction(observer) -> Tuple[float, float, float]:
    """The observer direction as the JAX march takes it: the f32 vector over
    its norm, with the squares summed by fused multiply-adds in axis order
    (``jnp.linalg.norm`` on the CPU)."""
    o = torch.tensor(np.asarray(observer, np.float32).reshape(3, 1))
    sq = traversal._fma(o[2], o[2], traversal._fma(o[1], o[1], o[0] * o[0]))
    return f32_values((o / torch.sqrt(sq)).reshape(3).numpy())


def observer_phase_direction(observer) -> Tuple[float, float, float]:
    """The observer direction as the JAX driver's phase and polarized
    peel-off take it: normalized in numpy f32."""
    obs = np.asarray(observer, dtype=np.float32)
    return f32_values(obs / np.linalg.norm(obs))


def henyey_greenstein_phase(cos_theta, g):
    """HG phase function normalized over solid angle."""
    return (1.0 - g * g) / (4.0 * math.pi * (1.0 + g * g - 2.0 * g * cos_theta) ** 1.5)


def _div(t, s: float):
    """t / s for a Python float s, rounded as one f32 division.  Torch on CUDA
    turns a division by a Python scalar into a multiplication by its f32
    reciprocal, which can move a result by one ulp; a tensor divisor keeps
    the division."""
    return t / torch.full_like(t, s)


def peel_off_factor(weight, direction=None, *, view: PeelOffView, albedo=1.0, hgg=0.0):
    """Each event's contribution before exp(−τ): weight / 4π at emission
    (``direction`` None), weight · albedo · HG(d·o) at a scattering."""
    if direction is None:
        return _div(weight, 4.0 * math.pi)
    o0, o1, o2 = view.phase_direction
    cos_obs = direction[:, 0] * o0 + direction[:, 1] * o1 + direction[:, 2] * o2
    return weight * albedo * henyey_greenstein_phase(cos_obs, hgg)


def peel_off_tau_reference(chi, position, *, view: PeelOffView, stats=None):
    """Optical depth from each position (cell units, [n, 3]) to the box edge
    along the observer: K1's plain march with target 1e4 and zero weight,
    then 1e4 − τ_left.  ``stats["packet_steps"]`` counts the march's steps."""
    n = position.shape[0]
    direction = torch.tensor(view.march_direction, dtype=torch.float32,
                             device=position.device).expand(n, 3)
    packets = traversal.make_packets(
        position, direction, torch.full((n,), TAU_TARGET, device=position.device),
        torch.zeros(n, device=position.device), view.shape)
    _, pk = traversal.trace_packets_reference(
        chi, packets, torch.zeros_like(chi), shape=view.shape, periodic=view.periodic,
        max_steps=view.max_steps, stats=stats)
    return TAU_TARGET - pk.tau_left


def _dot(p, e):
    """fma(z, e_z, fma(y, e_y, x·e_x)) of [n] f32 tensors and Python floats."""
    x, y, z = p

    def fma(a, b, c):
        return traversal._fma(a, torch.full_like(a, b), c)

    return fma(z, e[2], fma(y, e[1], x * e[0]))


def ccd_pixel_reference(position, *, view: PeelOffView):
    """Flat CCD pixel (px·npy + py, int32) of each position (cell units,
    [n, 3]), clipped into the edge pixels."""
    pos_si = [view.anchor[i] + position[:, i] * view.cell[i] for i in range(3)]
    u, v = _dot(pos_si, view.e1), _dot(pos_si, view.e2)
    npx, npy = view.pixels
    px = torch.clamp((_div(u - view.ccd_anchor[0], view.ccd_sides[0]) * npx).to(torch.int32),
                     0, npx - 1)
    py = torch.clamp((_div(v - view.ccd_anchor[1], view.ccd_sides[1]) * npy).to(torch.int32),
                     0, npy - 1)
    return px * npy + py


def peel_off_deposit_reference(chi, position, factor, active, ccd, *, view: PeelOffView,
                               stats=None):
    """Plain PyTorch peel-off: τ by the plain march, the pixel, and
    ``ccd.index_add_`` of factor · exp(−τ) over the ``active`` events, in
    place.  Returns (τ, pixel) of every event."""
    tau = peel_off_tau_reference(chi, position, view=view, stats=stats)
    pix = ccd_pixel_reference(position, view=view)
    contribution = torch.where(active, factor * torch.exp(-tau), 0.0)
    ccd.index_add_(0, pix.to(torch.int64), contribution)
    return tau, pix


def peel_off_polarized_reference(chi, position, direction, nref, stokes, active, planes, *,
                                 view: PeelOffView, band: polarization.ScatteringBand,
                                 stats=None):
    """Plain PyTorch polarized peel-off: τ and the pixel as in
    :func:`peel_off_deposit_reference`, the Stokes vector toward the observer
    by ``polarization.peel_off_polarized``, and its four components times
    albedo · exp(−τ) added into ``planes`` (I, Q, U, V) over the ``active``
    events, in place.  Returns (τ, pixel) of every event."""
    tau = peel_off_tau_reference(chi, position, view=view, stats=stats)
    pix = ccd_pixel_reference(position, view=view).to(torch.int64)
    observed = polarization.peel_off_polarized(
        direction, nref, *stokes, view.phase_direction, view.e1, band)
    att = torch.where(active, band.albedo * torch.exp(-tau), 0.0)
    for plane, value in zip(planes, observed):
        plane.index_add_(0, pix, value * att)
    return tau, pix.to(torch.int32)


def peel_off_deposit(chi, position, weight, active, ccd, *, view: PeelOffView,
                     direction=None, albedo=1.0, hgg=0.0):
    """Peel off every ``active`` event into ``ccd`` (flat, npx·npy), in
    place: weight / 4π · exp(−τ) at emission (``direction`` None), weight ·
    albedo · HG(d·o) · exp(−τ) at a scattering.

    CPU tensors run :func:`peel_off_deposit_reference`; CUDA tensors launch
    K8 (``kernels.peel_off.peel_off_cuda``), which counts its launches in
    ``kernels.LAUNCHES["peel_off"]``."""
    if chi.device.type == "cpu":
        factor = peel_off_factor(weight, direction, view=view, albedo=albedo, hgg=hgg)
        peel_off_deposit_reference(chi, position, factor, active, ccd, view=view)
    else:
        peel_off_cuda(chi, position, direction, weight, active, ccd, view=view,
                      albedo=albedo, hgg=hgg)
    return ccd


def peel_off_deposit_polarized(chi, position, direction, nref, stokes, active, planes, *,
                               view: PeelOffView, band: polarization.ScatteringBand):
    """Polarized peel-off of every ``active`` scattering event into
    ``planes`` (I, Q, U, V, each flat npx·npy), in place.

    CPU tensors run :func:`peel_off_polarized_reference`; CUDA tensors launch
    K8p (``kernels.peel_off_polarized.peel_off_polarized_cuda``), which counts
    its launches in ``kernels.LAUNCHES["peel_off_polarized"]``."""
    if chi.device.type == "cpu":
        peel_off_polarized_reference(chi, position, direction, nref, stokes, active, planes,
                                     view=view, band=band)
    else:
        peel_off_polarized_cuda(chi, position, direction, nref, stokes, active, planes,
                                view=view, band=band)
    return planes
