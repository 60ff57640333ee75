"""Photon sources: isotropic point-source emission and spectra over bins.

Port of the point-source part of ``cmacionize_tpu/models/sources.py``
(``isotropic_directions``, ``sample_tau_targets``, ``emit_point_source``,
``TabulatedSpectrum``) and of the multi-frequency driver's spectrum sampling
over frequency bins (``MultiFreqIonizationSimulation.__init__`` and
``_emit_bins`` in ``cmacionize_tpu/models/multifreq_simulation.py``).  Random numbers come from an
explicit ``torch.Generator`` on the packets' device.  Its stream cannot
reproduce ``jax.random``, so the port agrees with the JAX package in
distribution only; tests that need identical packets build them with numpy.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cmacionize_torch import constants


def _uniform(generator: torch.Generator, n: int, dtype) -> torch.Tensor:
    """n draws of U[0, 1) on the generator's device."""
    return torch.rand(n, generator=generator, device=generator.device, dtype=dtype)


def isotropic_directions(generator: torch.Generator, n: int, dtype=torch.float32):
    """Sample n isotropic unit vectors → ([n] dx, [n] dy, [n] dz)."""
    cos_theta = _uniform(generator, n, dtype) * 2.0 - 1.0
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    phi = _uniform(generator, n, dtype) * (2.0 * math.pi)
    return sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta


def sample_tau_targets(generator: torch.Generator, n: int, dtype=torch.float32):
    """Target optical depths τ = -ln(1-ξ), ξ ∈ [0, 1) (cf. IonizationPhotonShootJob)."""
    return -torch.log1p(-_uniform(generator, n, dtype))


def emit_point_source(
    generator: torch.Generator,
    n: int,
    grid_position,
    dtype=torch.float32,
    nudge: float = 1e-4,
):
    """Emit n monochromatic packets from a point source at `grid_position`
    (cell units), on the generator's device.

    Returns SoA tensors (px, py, pz, dx, dy, dz, tau, weight).  Positions are
    nudged a tiny fraction of a cell along the direction so packets born
    exactly on a cell corner don't need degenerate zero-length steps.
    """
    dx, dy, dz = isotropic_directions(generator, n, dtype)
    tau = sample_tau_targets(generator, n, dtype)
    gx, gy, gz = (float(g) for g in grid_position)
    px = gx + nudge * dx
    py = gy + nudge * dy
    pz = gz + nudge * dz
    weight = torch.ones(n, dtype=dtype, device=generator.device)
    return px, py, pz, dx, dy, dz, tau, weight


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation of (xp, fp) at x, as ``jnp.interp``:
    xp increasing (flat steps allowed), x clamped to [xp[0], xp[-1]]."""
    x = torch.clamp(x, xp[0], xp[-1])
    i = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, xp.numel() - 2)
    x0, x1, f0, f1 = xp[i], xp[i + 1], fp[i], fp[i + 1]
    step = x1 - x0
    t = torch.where(step > 0, (x - x0) / torch.where(step > 0, step, 1.0), 0.0)
    return f0 + t * (f1 - f0)


@dataclasses.dataclass(frozen=True)
class TabulatedSpectrum:
    """Inverse-CDF sampling of a tabulated spectrum in photon-number space.

    ``frequencies``/``cdf`` are 1D tables with cdf[0] = 0, cdf[-1] = 1.
    """

    frequencies: np.ndarray
    cdf: np.ndarray

    def sample(self, generator: torch.Generator, n: int, dtype=torch.float32):
        """n frequencies (Hz) drawn with the generator, on its device."""
        xi = _uniform(generator, n, dtype)

        def table(a):
            return torch.tensor(np.asarray(a), dtype=dtype, device=generator.device)

        return interp(xi, table(self.cdf), table(self.frequencies))


def tabulated_bin_pdf(bin_edges, frequencies, cdf) -> np.ndarray:
    """Per-bin weights of a tabulated spectrum: the increment of its CDF
    across each bin (exact for the tabulated distribution)."""
    edge_cdf = np.interp(bin_edges, frequencies, cdf)
    return np.maximum(np.diff(edge_cdf), 0.0)


def planck_bin_pdf(bin_centers, temperature: float) -> np.ndarray:
    """Blackbody photon-number weights ν²/(e^{hν/kT} - 1) at the bin centres."""
    x = constants.PLANCK * bin_centers / (constants.BOLTZMANN * temperature)
    return bin_centers**2 / np.expm1(x)


def monochromatic_bin_pdf(bin_edges, frequency: float) -> np.ndarray:
    """All weight in the bin holding ``frequency`` (clamped to the range)."""
    n_bins = len(bin_edges) - 1
    pdf = np.zeros(n_bins)
    pdf[np.clip(np.searchsorted(bin_edges, frequency) - 1, 0, n_bins - 1)] = 1.0
    return pdf


def bin_cdf(pdf) -> np.ndarray:
    """[n_bins + 1] cumulative distribution over the bins, from 0 to 1."""
    cdf = np.cumsum(pdf)
    return np.concatenate([[0.0], cdf / cdf[-1]])


def sample_bins(generator: torch.Generator, n: int, cdf: torch.Tensor) -> torch.Tensor:
    """n frequency bins (int32) drawn from the f32 bin CDF by inverse
    transform (``jnp.searchsorted``'s side="left" is ``right=False``)."""
    xi = _uniform(generator, n, torch.float32)
    n_bins = cdf.numel() - 1
    return torch.clamp(torch.searchsorted(cdf, xi) - 1, 0, n_bins - 1).to(torch.int32)
