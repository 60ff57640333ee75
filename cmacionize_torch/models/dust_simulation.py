"""Dust-scattering radiative transfer with CCD imaging (one GPU).

Port of ``cmacionize_tpu/models/dust_simulation.py`` (the reference's
DustSimulation mode): photons from a spiral galaxy's stellar disc and bulge
scatter off a double-exponential dust disc, and a virtual CCD collects the
surface-brightness image by peel-off (every emission and scattering event
adds weight × phase(θ_obs) × exp(−τ_obs) to its projected pixel).
``run()`` transports intensity; ``run_polarized()`` carries the full Stokes
vector through every scattering (``ops/polarization.py``).

Per scattering order, every live packet marches to its next interaction
with K1 (``ops/traversal.py:trace_packets``, as in JAX, with a scratch tally
nothing reads), scatters with a Henyey-Greenstein angle, and its weight
falls by the albedo; every event peels off toward the observer through K8
(or K8p, polarized) on the card (``ops/peel_off.py``).  The elementwise
physics (emission, HG sampling, the direction rotation, the polarized
scattering) stays in torch ops.  The sampling functions take their uniform
draws as tensors; the driver draws them from an explicit ``torch.Generator``
on its device, so it agrees with the JAX package in distribution only.

Like the JAX driver, a run stops when an order scatters nothing, which
costs one read of the order's count to the host per order.  Photon data
parallelism (``mesh=``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from cmacionize_torch.device import require_cuda
from cmacionize_torch.models import sources
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.ops import peel_off, polarization, traversal
from cmacionize_torch.utils.logging import Log, NullLog

KPC = 3.086e19

# V-band dust properties, cf. DustScattering.hpp get_*_for_band ("V")
HGG_V = 0.44  # Henyey-Greenstein asymmetry
ALBEDO_V = 0.67

#: the CLI's bands (cmacionize_tpu/cli.py:633-637): hgg, pl, albedo, kappa
#: (m^2 kg^-1), DustScattering.hpp:96-160
CLI_BANDS = {
    "V": (0.44, 0.43, 0.67, 21.9),
    "K": (0.02, 0.93, 0.28, 2.0),
}


@dataclasses.dataclass(frozen=True)
class DustConfig:
    geometry: GridGeometry
    # double-exponential dust disc (SpiralGalaxyDensityFunction)
    dust_central_density: float  # central opacity density kappa*rho (m^-1)
    dust_scale_radius: float
    dust_scale_height: float
    # stellar emission disc + bulge (SpiralGalaxyContinuousPhotonSource)
    stellar_scale_radius: float
    stellar_scale_height: float
    n_photons: int
    albedo: float = ALBEDO_V
    hgg: float = HGG_V
    #: maximum scattering orders; order k carries weight albedo^k
    n_scatterings: int = 12
    #: fraction of the luminosity from the spherical bulge (its fixed rC =
    #: 0.2 kpc / rB = 2 kpc / rJ = 0.4 kpc cutoff and Jaffe radii)
    bulge_over_total: float = 0.2
    ccd_pixels: Tuple[int, int] = (128, 128)
    # observer along +z by default (face-on image)
    observer_direction: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    # view angles (radians) override observer_direction; the image-plane
    # axes are e1 = (-sinφ, cosφ, 0), e2 = (-cosθ cosφ, -cosθ sinφ, sinθ)
    view_theta: Optional[float] = None
    view_phi: Optional[float] = None
    # image-plane window in SI (anchor x/y, sides x/y); None → the box's
    # projection
    ccd_anchor: Optional[Tuple[float, float]] = None
    ccd_sides: Optional[Tuple[float, float]] = None
    # polarized transport (full Stokes; White-1979 matrix)
    polarization: bool = False
    pl: float = 0.43  # peak linear polarization (V band)
    pc: float = 0.0
    sc: float = 0.0


def dust_config_from_params(params) -> DustConfig:
    """The configuration of ``--dusty-radiative-transfer`` from a
    ParameterFile: the configuration half of ``cmacionize_tpu/cli.py:_run_dust``
    (:618-690; the reference's DustSimulation.cpp:67-176 with
    SpiralGalaxyDensityFunction.hpp:94-106, DustScattering.hpp:96-160,
    CCDImage.hpp:171-196)."""
    geometry = GridGeometry.from_params(params)
    band = params.get_string("dust:band", "V")
    if band not in CLI_BANDS:
        raise ValueError(f"unknown dust band {band!r}")
    hgg, pl_peak, albedo, kappa = CLI_BANDS[band]
    # SpiralGalaxyDensityFunction: rho = 1.674e-27 * n0 * exp(-w/r - |z|/h)
    n0 = params.get_physical_value(
        "DensityFunction:central density", "number density", "1. cm^-3")
    theta = params.get_physical_value("CCDImage:view theta", "angle", "0. radians")
    phi = params.get_physical_value("CCDImage:view phi", "angle", "0. radians")
    ccd_anchor = (
        params.get_physical_value("CCDImage:anchor x", "length", f"{geometry.anchor[0]} m"),
        params.get_physical_value("CCDImage:anchor y", "length", f"{geometry.anchor[1]} m"),
    )
    ccd_sides = (
        params.get_physical_value("CCDImage:sides x", "length", f"{geometry.sides[0]} m"),
        params.get_physical_value("CCDImage:sides y", "length", f"{geometry.sides[1]} m"),
    )
    return DustConfig(
        geometry=geometry,
        dust_central_density=kappa * 1.674e-27 * n0,
        dust_scale_radius=params.get_physical_value(
            "DensityFunction:scale length ISM", "length", "6. kpc"),
        dust_scale_height=params.get_physical_value(
            "DensityFunction:scale height ISM", "length", "0.22 kpc"),
        stellar_scale_radius=params.get_physical_value(
            "ContinuousPhotonSource:scale length stars", "length", "5. kpc"),
        stellar_scale_height=params.get_physical_value(
            "ContinuousPhotonSource:scale height stars", "length", "0.6 kpc"),
        bulge_over_total=params.get_number(
            "ContinuousPhotonSource:bulge over total ratio", 0.2),
        n_photons=params.get_int("DustSimulation:number of photons", 500000),
        albedo=albedo,
        hgg=hgg,
        pl=pl_peak,
        ccd_pixels=(
            params.get_int("CCDImage:image width", 200),
            params.get_int("CCDImage:image height", 200),
        ),
        view_theta=theta,
        view_phi=phi,
        ccd_anchor=ccd_anchor,
        ccd_sides=ccd_sides,
        polarization=params.get_bool("DustSimulation:polarization", False),
    )


def henyey_greenstein_cos(xi, g):
    """cosθ from the HG phase function (Witt 1977 eq. 19), given uniform
    draws ξ ∈ [0, 1).  g is an f32 number here, as in the JAX package, so
    its expressions round in f32."""
    g = torch.tensor(g, dtype=torch.float32, device=xi.device)
    term = (1.0 - g * g) / (1.0 - g + 2.0 * g * xi)
    return torch.clamp((1.0 + g * g - term * term) / (2.0 * g + 1e-12), -1.0, 1.0)


def _rotate_to_new_direction(dx, dy, dz, cos_scat, phi):
    """New direction at angle arccos(cos_scat) from (dx, dy, dz), at the
    azimuths ``phi`` ∈ [0, 2π) about it."""
    sin_scat = torch.sqrt(torch.clamp_min(1.0 - cos_scat**2, 0.0))
    # orthonormal basis (u, v, d): the helper axis a = x̂ when d is nearly
    # ±ẑ, else ẑ; u = (a × d)/|a × d|
    near_z = torch.abs(dz) > 0.99
    ax = torch.where(near_z, 1.0, 0.0).to(dx.dtype)
    az = torch.where(near_z, 0.0, 1.0).to(dx.dtype)
    cx = -az * dy
    cy = az * dx - ax * dz
    cz = ax * dy
    norm = torch.sqrt(cx * cx + cy * cy + cz * cz) + 1e-20
    ux, uy, uz = cx / norm, cy / norm, cz / norm
    # v = d × u
    vx = dy * uz - dz * uy
    vy = dz * ux - dx * uz
    vz = dx * uy - dy * ux
    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    ndx = cos_scat * dx + sin_scat * (cos_phi * ux + sin_phi * vx)
    ndy = cos_scat * dy + sin_scat * (cos_phi * uy + sin_phi * vy)
    ndz = cos_scat * dz + sin_scat * (cos_phi * uz + sin_phi * vz)
    norm = torch.sqrt(ndx**2 + ndy**2 + ndz**2) + 1e-20
    return ndx / norm, ndy / norm, ndz / norm


#: the ranges of _emit's nine uniform draws, in the JAX package's order
EMIT_DRAW_RANGES = (
    (1e-7, 1.0), (1e-7, 1.0),  # the two factors of the disc radius
    (0.0, 2.0 * math.pi),  # disc azimuth
    (1e-7, 1.0),  # disc height
    (0.0, 1.0),  # the height's sign
    (0.0, 1.0),  # the bulge radius
    (0.0, 2.0 * math.pi), (-1.0, 1.0),  # bulge azimuth and cos(polar angle)
    (0.0, 1.0),  # disc or bulge
)


class DustSimulation:
    """Monte Carlo dust scattering producing a CCD surface-brightness map.

    ``device`` is "cuda" when not given (and raises where CUDA is missing);
    ``device="cpu"`` runs the plain PyTorch versions of every kernel."""

    def __init__(self, config: DustConfig, log: Optional[Log] = None, seed: int = 42,
                 device=None):
        if config.view_theta is not None:
            th = float(config.view_theta)
            ph = float(config.view_phi or 0.0)
            config = dataclasses.replace(
                config,
                observer_direction=(np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                                    np.cos(th)),
            )
        geom = config.geometry
        cell = geom.cell_size
        if not np.allclose(cell, cell[0], rtol=1e-6):
            raise NotImplementedError(f"the march needs cubic cells; got cell size {cell}")
        self.config = config
        self.device = require_cuda() if device is None else torch.device(device)
        self.log = log or NullLog()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.dx = float(cell[0])

        # image-plane basis (CCDImage.hpp:245-252); for the default face-on
        # observer this reduces to e1 = x̂, e2 = ŷ up to sign
        obs = np.asarray(config.observer_direction, np.float64)
        obs = obs / np.linalg.norm(obs)
        cos_t = np.clip(obs[2], -1.0, 1.0)
        sin_t = np.sqrt(max(0.0, 1.0 - cos_t * cos_t))
        if sin_t > 1e-12:
            cos_p, sin_p = obs[0] / sin_t, obs[1] / sin_t
        else:
            cos_p, sin_p = 1.0, 0.0
        self._e1 = np.array([-sin_p, cos_p, 0.0], np.float64)
        self._e2 = np.array([-cos_t * cos_p, -cos_t * sin_p, sin_t], np.float64)
        half = 0.5 * np.asarray(geom.sides, np.float64)
        r1 = np.abs(self._e1 * half).sum()
        r2 = np.abs(self._e2 * half).sum()
        self._ccd_anchor = np.asarray(config.ccd_anchor or (-r1, -r2), np.float64)
        self._ccd_sides = np.asarray(config.ccd_sides or (2.0 * r1, 2.0 * r2), np.float64)
        self.view = peel_off.PeelOffView(
            shape=tuple(int(s) for s in geom.shape),
            periodic=tuple(bool(p) for p in geom.periodic),
            march_direction=peel_off.observer_march_direction(config.observer_direction),
            phase_direction=peel_off.observer_phase_direction(config.observer_direction),
            anchor=peel_off.f32_values(geom.anchor),
            cell=peel_off.f32_values(cell),
            e1=peel_off.f32_values(self._e1),
            e2=peel_off.f32_values(self._e2),
            # x64 off (production): the window's f64 numbers enter as f32
            ccd_anchor=peel_off.f32_values(self._ccd_anchor),
            ccd_sides=peel_off.f32_values(self._ccd_sides),
            pixels=tuple(int(p) for p in config.ccd_pixels),
        )

        centers = geom.cell_centers()
        w = np.sqrt(centers[..., 0] ** 2 + centers[..., 1] ** 2)
        z = np.abs(centers[..., 2])
        chi = config.dust_central_density * np.exp(
            -w / config.dust_scale_radius - z / config.dust_scale_height)
        # opacity per cell-unit length
        self.chi = torch.tensor((chi * self.dx).reshape(-1).astype(np.float32),
                                device=self.device)
        #: scattering events per order of the last run (host ints)
        self.scattered_per_order: list = []

    # ---------------------------------------------------------- sampling

    def _uniform(self, n: int, lo: float = 0.0, hi: float = 1.0):
        u = torch.rand(n, generator=self.generator, device=self.device, dtype=torch.float32)
        return u if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * u

    def _emit_draws(self, n: int):
        """The nine uniform draws of :meth:`_emit`, from the generator."""
        return tuple(self._uniform(n, lo, hi) for lo, hi in EMIT_DRAW_RANGES)

    def _emit(self, draws):
        """Emission positions (grid units, [n, 3]) from the stellar
        double-exponential disc plus the spherical bulge, and their valid
        flags, from the nine draws of :data:`EMIT_DRAW_RANGES`.

        Mirrors SpiralGalaxyContinuousPhotonSource: with probability
        B/T·(1 − A_C/A_B) a photon comes from the bulge, whose radius
        inverts A = u·A_B + (1−u)·A_C with A_X = r_X/(r_X+r_J); draws outside
        the box carry zero weight (their positions are clipped inside)."""
        cfg = self.config
        geom = cfg.geometry
        u1, u2, phi, u3, u_sign, u_b, phi_b, cost, u_pick = draws
        # radius: gamma(2) distribution for an exponential disc surface
        radius = -cfg.stellar_scale_radius * torch.log(u1 * u2)
        sign = torch.sign(u_sign - 0.5)
        height = -cfg.stellar_scale_height * torch.log(u3) * sign
        pos_si = torch.stack([radius * torch.cos(phi), radius * torch.sin(phi), height], 1)

        if cfg.bulge_over_total > 0.0:
            r_C, r_B, r_J = 0.2 * KPC, 2.0 * KPC, 0.4 * KPC
            A_B = r_B / (r_B + r_J)
            A_C = r_C / (r_C + r_J)
            p_bulge = cfg.bulge_over_total * (1.0 - A_C / A_B)
            A = u_b * A_B + (1.0 - u_b) * A_C
            r_bulge = r_J / (1.0 / A - 1.0)
            sint = torch.sqrt(torch.clamp_min(1.0 - cost**2, 0.0))
            bulge_pos = torch.stack([
                r_bulge * sint * torch.cos(phi_b),
                r_bulge * sint * torch.sin(phi_b),
                r_bulge * cost,
            ], 1)
            is_bulge = u_pick <= p_bulge
            pos_si = torch.where(is_bulge[:, None], bulge_pos, pos_si)
        anchor = torch.tensor(geom.anchor, dtype=torch.float32, device=pos_si.device)
        cell = torch.tensor(geom.cell_size, dtype=torch.float32, device=pos_si.device)
        gpos = (pos_si - anchor) / cell
        shape = torch.tensor(geom.shape, dtype=torch.float32, device=pos_si.device)
        # photons sampled outside the box carry zero weight (the reference's
        # continuous sources only emit inside the box)
        valid = torch.all((gpos >= 0.0) & (gpos < shape), dim=1)
        return torch.minimum(torch.clamp_min(gpos, 0.0), shape - 1e-3), valid

    def _start(self):
        """Emission: positions, valid flags, isotropic directions, weights
        and the first τ targets."""
        n = self.config.n_photons
        gpos, valid = self._emit(self._emit_draws(n))
        dx, dy, dz = sources.isotropic_directions(self.generator, n)
        weight = torch.where(valid, 1.0 / n, 0.0).to(torch.float32)
        return gpos, valid, torch.stack([dx, dy, dz], 1), weight

    def _march(self, packets):
        """March a batch to its next interaction (K1 on the card); the tally
        is scratch that nothing reads."""
        _, pk = traversal.trace_packets(
            self.chi, packets, torch.zeros_like(self.chi), shape=self.view.shape,
            periodic=self.view.periodic)
        return pk

    def _order_count(self, gen: int, scattered) -> int:
        """The order's scattering events, read to the host (the run stops at
        an order that scatters nothing)."""
        n_scat = int(scattered.sum())
        self.scattered_per_order.append(n_scat)
        self.log.info(f"scattering generation {gen + 1}: {n_scat} events")
        return n_scat

    def run(self, mesh=None):
        """The intensity image, [npx, npy] f32 on the driver's device."""
        if mesh is not None:
            raise NotImplementedError(
                "cmacionize_torch: photon data parallelism (mesh=) of the dust driver is "
                "not ported yet")
        cfg = self.config
        n = cfg.n_photons
        npix = cfg.ccd_pixels[0] * cfg.ccd_pixels[1]
        ccd = torch.zeros(npix, dtype=torch.float32, device=self.device)
        self.scattered_per_order = []

        gpos, valid, direction, weight = self._start()
        # peel-off at emission: isotropic phase 1/4π
        peel_off.peel_off_deposit(self.chi, gpos, weight, valid, ccd, view=self.view)
        tau = sources.sample_tau_targets(self.generator, n)
        packets = traversal.make_packets(gpos, direction, tau, weight, self.view.shape)
        packets = packets._replace(active=valid)

        for gen in range(cfg.n_scatterings):
            pk = self._march(packets)
            # every interaction is a forced scattering; absorption is the
            # accumulated albedo^k weight factor (DustPhotonShootJob.hpp:133-160)
            scattered = pk.absorbed
            if self._order_count(gen, scattered) == 0:
                break
            cos_scat = henyey_greenstein_cos(self._uniform(n), cfg.hgg)
            ndx, ndy, ndz = _rotate_to_new_direction(
                pk.dx, pk.dy, pk.dz, cos_scat, self._uniform(n, 0.0, 2.0 * math.pi))
            event_pos = torch.stack([pk.px, pk.py, pk.pz], 1)
            # peel-off: the phase function toward the observer
            peel_off.peel_off_deposit(
                self.chi, event_pos, pk.weight, scattered, ccd, view=self.view,
                direction=torch.stack([pk.dx, pk.dy, pk.dz], 1), albedo=cfg.albedo,
                hgg=cfg.hgg)
            new_tau = sources.sample_tau_targets(self.generator, n)
            packets = traversal.make_packets(
                event_pos, torch.stack([ndx, ndy, ndz], 1), new_tau, pk.weight * cfg.albedo,
                self.view.shape)
            packets = packets._replace(active=scattered)
        return ccd.reshape(cfg.ccd_pixels)

    def run_polarized(self):
        """Full-Stokes dust RT: a dict of CCD planes I, Q, U, V ([npx, npy]
        f32 on the driver's device)."""
        cfg = self.config
        n = cfg.n_photons
        band = polarization.ScatteringBand(hgg=cfg.hgg, pl=cfg.pl, albedo=cfg.albedo,
                                           kappa=0.0, sc=cfg.sc, pc=cfg.pc)
        npix = cfg.ccd_pixels[0] * cfg.ccd_pixels[1]
        planes = tuple(torch.zeros(npix, dtype=torch.float32, device=self.device)
                       for _ in range(4))
        self.scattered_per_order = []

        gpos, valid, d, weight = self._start()
        # unpolarized direct emission peel-off
        peel_off.peel_off_deposit(self.chi, gpos, weight, valid, planes[0], view=self.view)

        # Stokes state: unpolarized at birth
        stokes = (weight, torch.zeros_like(weight), torch.zeros_like(weight),
                  torch.zeros_like(weight))
        nref = torch.stack(polarization.initial_reference_normal(d[:, 0], d[:, 1], d[:, 2]), 1)
        tau = sources.sample_tau_targets(self.generator, n)
        packets = traversal.make_packets(gpos, d, tau, weight, self.view.shape)
        packets = packets._replace(active=valid)

        for gen in range(cfg.n_scatterings):
            pk = self._march(packets)
            scattered = pk.absorbed
            if self._order_count(gen, scattered) == 0:
                break
            d = torch.stack([pk.dx, pk.dy, pk.dz], 1)
            event_pos = torch.stack([pk.px, pk.py, pk.pz], 1)
            # peel-off with the full scattering matrix toward the observer
            peel_off.peel_off_deposit_polarized(
                self.chi, event_pos, d, nref, stokes, scattered, planes, view=self.view,
                band=band)
            # scatter the packet itself
            cos_scat = henyey_greenstein_cos(self._uniform(n), cfg.hgg)
            d_new, nref_new, *stokes = polarization.scatter_polarized(
                self._uniform(n, 0.0, 2.0 * math.pi), d, nref, *stokes, cos_scat, band)
            nref = torch.where(scattered[:, None], nref_new, nref)
            new_tau = sources.sample_tau_targets(self.generator, n)
            stokes = tuple(s * cfg.albedo for s in stokes)
            # the packet weight tracks I (scatter_polarized's importance
            # correction changes the intensity of polarized packets)
            packets = traversal.make_packets(event_pos, d_new, new_tau, stokes[0],
                                             self.view.shape)
            packets = packets._replace(active=scattered)
        return {k: p.reshape(cfg.ccd_pixels) for k, p in zip("IQUV", planes)}
