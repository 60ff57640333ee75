"""Polarized dust scattering: Stokes-vector transport.

Port of ``cmacionize_tpu/ops/polarization.py``: the White (1979) scattering
matrix with the Yusef-Zadeh, Morris & White (1984) frame rotations, carried
with an explicit polarization reference normal n ⊥ d per packet (the axis
against which Q is measured).  A scattering event is a rotation of the
reference about d by a uniform azimuth ψ, the deflection of d by the
Henyey-Greenstein angle Θ in that plane, and the White matrix (P1..P4) in the
scattering-plane frame; the outgoing reference stays in the plane.

Stokes vectors are absolute (I = packet weight).  The direction is sampled
from the unpolarized HG phase function (∝ P1), so the matrix is divided by
P1 as the importance correction, and the intensity of a polarized packet
changes at a scattering, as in the reference.

These are plain tensor functions, evaluated in the JAX package's operation
order (one rounding per operation).  The azimuth draws ψ are an argument, so
a caller can hand in any stream of uniform numbers; the driver
(``models/dust_simulation.py``) draws them from its ``torch.Generator``.  The
peel-off toward the observer runs fused with its march and deposit in K8p
(``ops/peel_off.py``) on the card.
"""

from __future__ import annotations

import dataclasses
import math

import torch

#: band parameters (DustScattering.hpp:96-160): hgg, pl, albedo, kappa.  The
#: V albedo here is 0.54; the dust driver's configuration carries the CLI's
#: 0.67 (``models/dust_simulation.py:dust_config_from_params``), as in the
#: JAX package.
BAND_PARAMETERS = {
    "V": dict(hgg=0.44, pl=0.43, albedo=0.54, kappa=21.9),
    "K": dict(hgg=0.02, pl=0.93, albedo=0.21, kappa=2.0),
}


@dataclasses.dataclass(frozen=True)
class ScatteringBand:
    hgg: float
    pl: float  # peak linear polarization
    albedo: float
    kappa: float
    sc: float = 0.0  # circular polarization skew
    pc: float = 0.0  # peak linear→circular conversion

    @classmethod
    def named(cls, band: str) -> "ScatteringBand":
        return cls(**BAND_PARAMETERS[band])


def scattering_matrix(cos_theta: torch.Tensor, band: ScatteringBand):
    """White (1979) eqs. 3-6 matrix elements (P1, P2, P3, P4) at the
    scattering angle Θ (DustScattering.cpp:120-148)."""
    g = band.hgg
    cos2 = cos_theta * cos_theta
    P1 = (1.0 - g * g) * (1.0 + g * g - 2.0 * g * cos_theta) ** -1.5
    inv1c2 = 1.0 / (1.0 + cos2)
    P2 = -band.pl * P1 * (1.0 - cos2) * inv1c2
    P3 = 2.0 * P1 * cos_theta * inv1c2
    theta = torch.arccos(torch.clamp(cos_theta, -1.0, 1.0))
    # a tensor divisor: torch on CUDA multiplies by the reciprocal of a
    # Python scalar divisor
    cos_skew = torch.cos(
        theta + band.sc * 3.13 * theta * torch.exp(-7.0 * theta / torch.full_like(theta, math.pi)))
    cos2_skew = cos_skew * cos_skew
    P4 = -band.pc * P1 * (1.0 - cos2_skew) / (1.0 + cos2_skew)
    return P1, P2, P3, P4


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def rotate_stokes(Q, U, cos_psi, sin_psi):
    """Mueller frame rotation by ψ about the propagation direction."""
    cos2 = cos_psi * cos_psi - sin_psi * sin_psi
    sin2 = 2.0 * sin_psi * cos_psi
    return Q * cos2 + U * sin2, -Q * sin2 + U * cos2


def initial_reference_normal(dx, dy, dz):
    """An arbitrary unit normal ⊥ d for freshly emitted (unpolarized)
    packets: (a × d)/|a × d| with a = x̂ when d is nearly ±ẑ, else ẑ."""
    near_z = torch.abs(dz) > 0.99
    ax = torch.where(near_z, 1.0, 0.0).to(dx.dtype)
    az = torch.where(near_z, 0.0, 1.0).to(dx.dtype)
    cx, cy, cz = _cross(ax, torch.zeros_like(ax), az, dx, dy, dz)
    norm = torch.sqrt(cx * cx + cy * cy + cz * cz) + 1e-20
    return cx / norm, cy / norm, cz / norm


def scatter_polarized(psi, d, nref, I, Q, U, V, cos_theta, band: ScatteringBand):
    """One polarized scattering event for a batch of packets.

    psi: [n] azimuth draws in [0, 2π); d, nref: [n, 3] unit direction and
    reference normal; (I, Q, U, V): [n] Stokes; cos_theta: [n] HG-sampled
    scattering-angle cosines.  Returns (d', nref', I', Q', U', V'), with
    I' = (P1·I + P2·Qr)/P1 (the importance correction).
    """
    cos_psi, sin_psi = torch.cos(psi), torch.sin(psi)

    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    nx, ny, nz = nref[:, 0], nref[:, 1], nref[:, 2]
    tx, ty, tz = _cross(dx, dy, dz, nx, ny, nz)  # t = d × n

    # in-plane reference after the azimuth rotation
    lx = cos_psi * nx + sin_psi * tx
    ly = cos_psi * ny + sin_psi * ty
    lz = cos_psi * nz + sin_psi * tz
    Qr, Ur = rotate_stokes(Q, U, cos_psi, sin_psi)

    # deflect d by Θ inside the (d, l) plane; {d, l} rotates to {d', l'}
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    ndx = cos_theta * dx + sin_theta * lx
    ndy = cos_theta * dy + sin_theta * ly
    ndz = cos_theta * dz + sin_theta * lz
    olx = cos_theta * lx - sin_theta * dx
    oly = cos_theta * ly - sin_theta * dy
    olz = cos_theta * lz - sin_theta * dz
    norm = torch.sqrt(ndx * ndx + ndy * ndy + ndz * ndz) + 1e-20

    P1, P2, P3, P4 = scattering_matrix(cos_theta, band)
    a_inv = 1.0 / torch.clamp_min(P1, 1e-30)
    I_new = (P1 * I + P2 * Qr) * a_inv
    Q_new = (P2 * I + P1 * Qr) * a_inv
    U_new = (P3 * Ur + P4 * V) * a_inv
    V_new = (-P4 * Ur + P3 * V) * a_inv

    d_out = torch.stack([ndx / norm, ndy / norm, ndz / norm], dim=1)
    n_out = torch.stack([olx, oly, olz], dim=1)
    n_out = n_out / (torch.linalg.vector_norm(n_out, dim=1, keepdim=True) + 1e-20)
    return d_out, n_out, I_new, Q_new, U_new, V_new


def peel_off_polarized(d, nref, I, Q, U, V, observer, ccd_x, band: ScatteringBand):
    """Polarized peel-off: observed (I, Q, U, V) per unit solid angle toward
    ``observer`` (3 floats), with Q/U in the fixed CCD frame (``ccd_x`` ⊥
    observer, 3 floats).  Includes the 1/4π phase normalization but not the
    albedo or exp(-τ) factors (DustScattering::scatter_towards and the CCD
    frame rotation)."""
    o0, o1, o2 = (float(c) for c in observer)
    e0, e1, e2 = (float(c) for c in ccd_x)

    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    nx, ny, nz = nref[:, 0], nref[:, 1], nref[:, 2]
    cos_theta = dx * o0 + dy * o1 + dz * o2
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    degenerate = sin_theta < 1e-6
    safe_sin = torch.clamp_min(sin_theta, 1e-20)

    # incoming in-plane Q axis: l_in ∝ o − cosΘ d; the carried reference
    # when d ∥ o
    lx = torch.where(degenerate, nx, (o0 - cos_theta * dx) / safe_sin)
    ly = torch.where(degenerate, ny, (o1 - cos_theta * dy) / safe_sin)
    lz = torch.where(degenerate, nz, (o2 - cos_theta * dz) / safe_sin)

    # rotation from nref to l_in about d
    cos_psi = nx * lx + ny * ly + nz * lz
    tx, ty, tz = _cross(dx, dy, dz, nx, ny, nz)
    sin_psi = tx * lx + ty * ly + tz * lz
    Qr, Ur = rotate_stokes(Q, U, cos_psi, sin_psi)

    P1, P2, P3, P4 = scattering_matrix(cos_theta, band)
    inv4pi = 1.0 / (4.0 * math.pi)
    I_obs = (P1 * I + P2 * Qr) * inv4pi
    Q_obs = (P2 * I + P1 * Qr) * inv4pi
    U_obs = (P3 * Ur + P4 * V) * inv4pi
    V_obs = (-P4 * Ur + P3 * V) * inv4pi

    # outgoing in-plane Q axis l_out = cosΘ l_in − sinΘ d (⊥ o), rotated into
    # the CCD frame about the observer direction
    ox = torch.where(degenerate, nx, cos_theta * lx - sin_theta * dx)
    oy = torch.where(degenerate, ny, cos_theta * ly - sin_theta * dy)
    oz = torch.where(degenerate, nz, cos_theta * lz - sin_theta * dz)
    cos_chi = ox * e0 + oy * e1 + oz * e2
    cx, cy, cz = o1 * oz - o2 * oy, o2 * ox - o0 * oz, o0 * oy - o1 * ox
    sin_chi = cx * e0 + cy * e1 + cz * e2
    Q_ccd, U_ccd = rotate_stokes(Q_obs, U_obs, cos_chi, sin_chi)
    return I_obs, Q_ccd, U_ccd, V_obs
