"""Stratified, octant-pure, spatially coherent point-source emission.

Port of ``tools/experimental_emission_octa.py``.  The cone-marched traversal
(:mod:`cmacionize_torch.tools.experimental_cone_kernel`) wants packet batches
whose consecutive lanes form compact direction cones with one sign per axis:
a chunk of lanes then stays inside one small grid slab for its whole flight.

The sphere is split into its 8 octants.  Each octant is the triangle
{a, b ≥ 0, a + b ≤ 1} under the equal-area octahedral map (ρ = a + b,
f = b/ρ, z = 1 − ρ², sin θ = ρ·√(2 − ρ²), φ = (π/2)·f), so equal parameter
area is equal solid angle.  A rectangular ga × gb grid on the unit square,
folded area-preservingly onto the triangle ((a, b) → (1 − b, 1 − a) where
a + b > 1), stratifies it twice over.  Lanes are contiguous per octant and
Morton-ordered by folded cell centre inside it, and a uniform jitter inside
each cell keeps the estimator unbiased.

Random numbers come from an explicit ``torch.Generator``; its stream cannot
reproduce ``jax.random``, so :func:`directions_from_jitter` (the
deterministic map from the jitter to directions) is kept apart for tests
that feed both packages the same jitter.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cmacionize_torch.device import require_cuda

_TABLE_CACHE = {}
_DEVICE_TABLES = {}  # (n, device) -> _device_table's tensors


def _morton2(ix, iy):
    """Interleave bits of (ix, iy) -> Morton code (numpy, any width)."""
    code = np.zeros_like(ix, dtype=np.int64)
    for b in range(21):
        code |= ((ix >> b) & 1) << (2 * b)
        code |= ((iy >> b) & 1) << (2 * b + 1)
    return code


def lane_table(n: int):
    """Static per-lane stratification table for ``n`` photons.

    n must be divisible by 8 with n/8 = ga*gb for a 2:1 grid (ga = 2*gb).
    Returns int32 numpy arrays (octant[n], cell_a[n], cell_b[n]) plus the
    grid dims (ga, gb).  Lanes are contiguous per octant and Morton-ordered
    by folded cell centre inside each octant.
    """
    if n in _TABLE_CACHE:
        return _TABLE_CACHE[n]
    if n % 8:
        raise ValueError("n must be divisible by 8")
    per_oct = n // 8
    gb = int(np.sqrt(per_oct / 2))
    ga = 2 * gb
    if ga * gb != per_oct:
        raise ValueError(f"n/8 = {per_oct} is not 2*k^2 for integer k (n={n})")
    ia, ib = np.meshgrid(np.arange(ga), np.arange(gb), indexing="ij")
    ia, ib = ia.ravel(), ib.ravel()
    # folded cell centre (for ordering only)
    ca = (ia + 0.5) / ga
    cb = (ib + 0.5) / gb
    over = ca + cb > 1.0
    fa = np.where(over, 1.0 - cb, ca)
    fb = np.where(over, 1.0 - ca, cb)
    # Morton order on the folded centre quantized to the finer grid axis
    q = max(ga, gb)
    code = _morton2((fa * q).astype(np.int64), (fb * q).astype(np.int64))
    order = np.argsort(code, kind="stable")
    ia, ib = ia[order], ib[order]
    octant = np.repeat(np.arange(8, dtype=np.int32), per_oct)
    cell_a = np.tile(ia.astype(np.int32), 8)
    cell_b = np.tile(ib.astype(np.int32), 8)
    out = (octant, cell_a, cell_b, ga, gb)
    _TABLE_CACHE[n] = out
    return out


#: sign triplets per octant index (x, y, z)
_OCT_SIGNS = np.array(
    [[sx, sy, sz] for sz in (1.0, -1.0) for sy in (1.0, -1.0) for sx in (1.0, -1.0)],
    dtype=np.float32,
)


def _device_table(n: int, device: torch.device):
    """:func:`lane_table` on ``device``, kept there: (cell_a and cell_b as
    f32, each lane's sign triplet [n, 3], ga, gb)."""
    key = (n, str(device))
    if key not in _DEVICE_TABLES:
        octant, cell_a, cell_b, ga, gb = lane_table(n)
        _DEVICE_TABLES[key] = (
            torch.tensor(cell_a, dtype=torch.float32, device=device),
            torch.tensor(cell_b, dtype=torch.float32, device=device),
            torch.tensor(_OCT_SIGNS[octant], device=device), ga, gb)
    return _DEVICE_TABLES[key]


def directions_from_jitter(ja: torch.Tensor, jb: torch.Tensor) -> torch.Tensor:
    """[n, 3] unit directions from the [n] f32 jitter in each lane's cell.

    The deterministic part of :func:`stratified_directions`: lane i lies in
    cell (cell_a[i], cell_b[i]) of octant octant[i] of :func:`lane_table`,
    and its direction-sign triplet is ``_OCT_SIGNS[octant[i]]``.
    """
    cell_a, cell_b, signs, ga, gb = _device_table(ja.numel(), ja.device)
    a = (cell_a + ja) / ga
    b = (cell_b + jb) / gb
    # fold the square onto the triangle a+b <= 1 (area-preserving 2-cover)
    over = a + b > 1.0
    a, b = torch.where(over, 1.0 - b, a), torch.where(over, 1.0 - a, b)
    rho = torch.clamp_min(a + b, 1e-12)
    f = b / rho
    z = 1.0 - rho * rho
    sin_t = rho * torch.sqrt(torch.clamp_min(2.0 - rho * rho, 0.0))
    phi = (0.5 * math.pi) * f
    x = sin_t * torch.cos(phi)
    y = sin_t * torch.sin(phi)
    d = torch.stack([x, y, z], dim=1) * signs
    # exact normalization (the map is unit-norm up to round-off)
    return d / torch.linalg.vector_norm(d, dim=1, keepdim=True)


def stratified_directions(generator: torch.Generator, n: int) -> torch.Tensor:
    """[n, 3] unit directions on the generator's device: equal-area
    stratified, Morton/octant ordered.

    Every lane's direction-sign triplet equals ``_OCT_SIGNS[lane // (n//8)]``.
    """
    ja = torch.rand(n, generator=generator, device=generator.device, dtype=torch.float32)
    jb = torch.rand(n, generator=generator, device=generator.device, dtype=torch.float32)
    return directions_from_jitter(ja, jb)


def emit_point_source_stratified(generator: torch.Generator, n: int, source_gpos,
                                 device=None):
    """Stratified point-source emission (grid units) on ``device`` (the
    card unless ``device="cpu"``; ``generator`` must live there).

    Returns (position [n, 3], direction [n, 3], tau [n], weight [n]).  It
    has the isotropic expectation of ``models.sources.emit_point_source``
    (τ = −ln ξ, ξ ∈ [1e-10, 1)) but coherent lane ordering, and no nudge:
    every packet starts at ``source_gpos``.
    """
    device = require_cuda() if device is None else torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, emission on {device}")
    d = stratified_directions(generator, n)
    pos = torch.tensor(source_gpos, dtype=torch.float32, device=device).expand(n, 3)
    u = torch.rand(n, generator=generator, device=device, dtype=torch.float32)
    u = u * (1.0 - 1e-10) + 1e-10  # jax.random.uniform(key, shape, f32, 1e-10, 1.0)
    tau = -torch.log(u)
    w = torch.ones(n, dtype=torch.float32, device=device)
    return pos.contiguous(), d, tau, w
