"""Photon sources: isotropic point-source emission.

Port of the monochromatic point-source part of
``cmacionize_tpu/models/sources.py`` (``isotropic_directions``,
``sample_tau_targets``, ``emit_point_source``).  Random numbers come from an
explicit ``torch.Generator`` on the packets' device.  Its stream cannot
reproduce ``jax.random``, so the port agrees with the JAX package in
distribution only; tests that need identical packets build them with numpy.
"""

from __future__ import annotations

import math

import torch


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
