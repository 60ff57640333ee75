"""Photon traversal through a flattened AMR octree.

Port of ``cmacionize_tpu/ops/amr_traversal.py``: the hierarchy lives as two
int32 tables, ``root`` (``[nx·ny·nz]``: a leaf is stored as ``-(id+1)``, an
internal node as its row of ``children``) and ``children`` (``[n_internal,
8]``, indexed by the octant ``ox·4 + oy·2 + oz``).  Every step re-descends
from the root, ``max_level`` levels at most, to the leaf holding the packet,
marches to that leaf's wall and deposits ℓ·w into the per-leaf tally (``[C]``,
or ``[n_bins·C]`` with slot ``fbin·C + leaf`` for the spectral march), so
memory stays O(leaves) at any depth.  Positions are in coarse cell units;
``chi_leaf`` is the optical depth per coarse-unit length in each leaf.

Each function dispatches on the device: CPU tensors run its plain PyTorch
version (the JAX ``while_loop`` body as a lockstep loop, step for step), CUDA
tensors launch its kernel: K5 (``csrc/trace_octree.cu``), K5s
(``csrc/trace_octree_spectral.cu``) and the leaf descent K5d (in
``csrc/trace_octree.cu``).  There is no fallback between the two.

The packet batches are ``ops.traversal``'s; the octree march ignores and
keeps their cell indices ``cx, cy, cz``, as the JAX march does.

A quirk of the JAX march is kept, since the port follows it bit for bit: the
nudge ε·d that picks the next leaf is floored at 8 ulps of the largest
coordinate, but along an axis with |d| < ulp(p)/(2ε) it rounds away.  A
packet that crosses a wall of that axis against the axis direction, where
the resolution is the same on both sides, then finds the leaf it left,
with l_exit = 0, and stays on the wall, active, until ``max_steps``
(ROADMAP.md, queue 3).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from cmacionize_torch.kernels.leaf_of_positions import leaf_of_positions_cuda
from cmacionize_torch.kernels.trace_octree import trace_octree_cuda
from cmacionize_torch.kernels.trace_octree_spectral import trace_octree_spectral_cuda
from cmacionize_torch.ops.traversal import (
    _CHI_FLOOR,
    _EPS_DIR,
    _fma,
    PacketBatch,
    SpectralPacketBatch,
)


def wall_eps(coarse_shape, max_level: int) -> float:
    """The wall-identification nudge, as the f32 value the JAX march uses:
    below the finest leaf size and at least 8 coordinate ulps, so that the
    nudged point lands strictly inside the next leaf at any depth (the naive
    1e-3·2^-max_level falls under the f32 ulp of the coordinates from
    max_level ≈ 8 on, and packets would stall on walls)."""
    ulp = max(coarse_shape) * 2.0 ** (-23)
    return float(np.float32(max(1e-3 * 2.0 ** (-max_level), 8.0 * ulp)))


def default_max_steps(coarse_shape, max_level: int, max_steps: int = 0) -> int:
    """4·(nx+ny+nz)·2^max_level steps unless ``max_steps`` is given: a leaf
    crossing advances at least one finest-lattice cell along an axis."""
    nx, ny, nz = coarse_shape
    return max_steps or 4 * (nx + ny + nz) * (1 << max_level)


def _nudged(p, d, eps: float):
    """p + eps·d with the product rounded first: XLA on the CPU does not fuse
    the JAX march's nudges (a targeted test found the unfused rounding in the
    descent and in the inside test), unlike its advance."""
    return p + eps * d


def _descend(root, children, px, py, pz, coarse_shape, max_level, stats=None):
    """Leaf id and box (lo_x, lo_y, lo_z, size) of each point, the JAX
    ``descend``: ``max_level`` batched gathers at most.  With ``stats``, the
    internal levels crossed are added to ``stats["descent_levels"]``."""
    nx, ny, nz = coarse_shape
    ix = torch.clamp(torch.floor(px).to(torch.int32), 0, nx - 1)
    iy = torch.clamp(torch.floor(py).to(torch.int32), 0, ny - 1)
    iz = torch.clamp(torch.floor(pz).to(torch.int32), 0, nz - 1)
    node = root[((ix * ny + iy) * nz + iz).to(torch.int64)]
    lo_x, lo_y, lo_z = (i.to(px.dtype) for i in (ix, iy, iz))
    size = torch.ones_like(px)
    flat_children = children.reshape(-1)
    for _ in range(max_level):
        internal = node >= 0
        if not bool(internal.any()):
            break  # every point is at its leaf: the remaining levels change nothing
        if stats is not None:
            stats["descent_levels"] += internal.sum()
        half = 0.5 * size
        ox = px >= lo_x + half
        oy = py >= lo_y + half
        oz = pz >= lo_z + half
        octant = ox.to(torch.int64) * 4 + oy.to(torch.int64) * 2 + oz.to(torch.int64)
        child = flat_children[torch.clamp_min(node, 0).to(torch.int64) * 8 + octant]
        node = torch.where(internal, child, node)
        lo_x = torch.where(internal & ox, lo_x + half, lo_x)
        lo_y = torch.where(internal & oy, lo_y + half, lo_y)
        lo_z = torch.where(internal & oz, lo_z + half, lo_z)
        size = torch.where(internal, half, size)
    return -node - 1, lo_x, lo_y, lo_z, size


def _wall_distance(pos, lo, size, dirn):
    """Distance along dirn to the leaf's wall on this axis (+inf for a
    degenerate direction component)."""
    wall = torch.where(dirn > 0.0, lo + size, lo)
    moving = torch.abs(dirn) > _EPS_DIR
    t = (wall - pos) / torch.where(moving, dirn, _EPS_DIR)
    return torch.where(moving, torch.clamp_min(t, 0.0), torch.inf)


_STATE_FIELDS = ("px", "py", "pz", "tau_left", "active", "absorbed")


def _count_noops(stats, live, step, sub, after, active, deposit, size):
    """Adds one step of the packets ``live`` (state ``sub`` before it,
    position and ``tau_left`` ``after`` it) to ``stats``
    (:func:`_march_reference`): the step is a no-op where nothing changed
    bit for bit and the deposit is zero.  Its sign is not asked for: where
    JAX's ``maximum`` and K5's wall distance give +0.0, ``clamp_min`` keeps
    -0.0, and a tally that starts at +0.0 takes either unchanged.  The
    step's descent crossed 1 - e internal levels, where the leaf size is
    0.5·2^e (``frexp``)."""
    noop = active & (deposit == 0.0)
    for before, now in zip((sub.px, sub.py, sub.pz, sub.tau_left), after):
        noop &= before.view(torch.int32) == now.view(torch.int32)
    stats["packet_steps"] += live.numel()
    stats["steps"][live] += 1
    stats["noop_steps"] += noop.sum()
    stats["noop_descent_levels"] += (1 - torch.frexp(size).exponent)[noop].sum()
    first = live[noop]
    first = first[stats["fixed_point_step"][first] < 0]
    stats["fixed_point_step"][first] = step


def _march_reference(root, children, pk, tally, chi_of, tally_index, *,
                     coarse_shape, max_level, max_steps, stats=None):
    """The JAX lockstep loop of ``trace_packets_octree``, step for step, for
    either batch type.  ``chi_of(sub, leaf)`` gives each packet's opacity in
    its leaf and ``tally_index(sub, leaf)`` the tally slot of its deposit.

    Each step runs on the packets still in flight only (``sub``, their
    indices ``live``), and a packet's final state is written back when it
    terminates: the JAX loop masks the others, which changes nothing for
    them, and leaving out their zero deposits changes no tally bit.  A
    packet that stalls on a wall (see the module's notes) then costs one
    lane, not the whole batch, until ``max_steps``.

    With ``stats`` (device tensors; without it nothing is counted):
    ``"packet_steps"``, the packet steps taken, and ``"descent_levels"``, the
    internal levels their descents crossed; ``"noop_steps"`` and
    ``"noop_descent_levels"``, the same for the no-op steps among them,
    those that leave position, ``tau_left`` and the flags bit for bit as
    they were and deposit zero (the step is a pure function of that state,
    so a packet that takes one repeats it until ``max_steps``: a fixed
    point); ``"fixed_points"``, the packets that reach one; and per packet
    (int32 [n]) ``"steps"``, the steps it took, and ``"fixed_point_step"``,
    the steps it took before its first no-op step (-1: none)."""
    nx, ny, nz = coarse_shape
    eps = wall_eps(coarse_shape, max_level)
    max_steps = default_max_steps(coarse_shape, max_level, max_steps)
    if stats is not None:
        for key in ("packet_steps", "descent_levels", "noop_steps", "noop_descent_levels"):
            stats[key] = torch.zeros((), dtype=torch.int64, device=tally.device)
        stats["steps"] = torch.zeros(pk.px.shape, dtype=torch.int32, device=tally.device)
        stats["fixed_point_step"] = torch.full(pk.px.shape, -1, dtype=torch.int32,
                                               device=tally.device)
    out = {f: getattr(pk, f).clone() for f in _STATE_FIELDS}
    live = torch.nonzero(pk.active).squeeze(1)
    sub = pk._replace(**{f: v[live] for f, v in pk._asdict().items()})
    step = 0
    while step < max_steps and live.numel() > 0:
        # identify the leaf at a nudged point (robust on cell walls)
        leaf, lo_x, lo_y, lo_z, size = _descend(
            root, children, _nudged(sub.px, sub.dx, eps), _nudged(sub.py, sub.dy, eps),
            _nudged(sub.pz, sub.dz, eps), coarse_shape, max_level, stats)
        tx = _wall_distance(sub.px, lo_x, size, sub.dx)
        ty = _wall_distance(sub.py, lo_y, size, sub.dy)
        tz = _wall_distance(sub.pz, lo_z, size, sub.dz)
        l_exit = torch.minimum(tx, torch.minimum(ty, tz))

        chi = torch.clamp_min(chi_of(sub, leaf), _CHI_FLOOR)
        tau_cell = chi * l_exit
        absorbed_now = tau_cell >= sub.tau_left
        l_travel = torch.where(absorbed_now, sub.tau_left / chi, l_exit)
        deposit = l_travel * sub.weight
        tally.index_add_(0, tally_index(sub, leaf), deposit.to(tally.dtype))

        px = _fma(sub.dx, l_travel, sub.px)
        py = _fma(sub.dy, l_travel, sub.py)
        pz = _fma(sub.dz, l_travel, sub.pz)
        cross_x = ~absorbed_now & (l_exit == tx)
        cross_y = ~absorbed_now & ~cross_x & (l_exit == ty)
        cross_z = ~absorbed_now & ~cross_x & ~cross_y
        # snap the crossed coordinate exactly onto the wall
        px = torch.where(cross_x, torch.where(sub.dx > 0, lo_x + size, lo_x), px)
        py = torch.where(cross_y, torch.where(sub.dy > 0, lo_y + size, lo_y), py)
        pz = torch.where(cross_z, torch.where(sub.dz > 0, lo_z + size, lo_z), pz)

        qx, qy, qz = _nudged(px, sub.dx, eps), _nudged(py, sub.dy, eps), _nudged(pz, sub.dz, eps)
        inside = ((qx >= 0.0) & (qx < nx) & (qy >= 0.0) & (qy < ny)
                  & (qz >= 0.0) & (qz < nz))
        tau_left = torch.where(absorbed_now, 0.0, sub.tau_left - tau_cell)
        active = ~absorbed_now & inside
        if stats is not None:
            _count_noops(stats, live, step, sub, (px, py, pz, tau_left), active, deposit, size)
        sub = sub._replace(px=px, py=py, pz=pz, tau_left=tau_left, active=active,
                           absorbed=sub.absorbed | absorbed_now)
        step += 1
        done = ~sub.active
        if bool(done.any()):
            # freeze terminated packets: their final state is what
            # re-emission reads
            for f in _STATE_FIELDS:
                out[f][live[done]] = getattr(sub, f)[done]
            live = live[sub.active]
            sub = sub._replace(**{f: v[sub.active] for f, v in sub._asdict().items()})
    for f in _STATE_FIELDS:  # packets stopped by max_steps
        out[f][live] = getattr(sub, f)
    if stats is not None:
        stats["fixed_points"] = (stats["fixed_point_step"] >= 0).sum()
    return tally, pk._replace(**out)


def trace_packets_octree_reference(
    root: torch.Tensor,
    children: torch.Tensor,
    chi_leaf: torch.Tensor,
    packets: PacketBatch,
    tally: torch.Tensor,
    *,
    coarse_shape: Tuple[int, int, int],
    max_level: int,
    max_steps: int = 0,
    stats: Optional[dict] = None,
):
    """Plain PyTorch octree march: Σ ℓ(coarse units)·w is added into
    ``tally`` [C] in place (an f64 tally sums the f32 deposits in f64).
    Returns (tally, terminated batch); the batch handed in is not
    modified."""
    return _march_reference(
        root, children, packets, tally,
        lambda pk, leaf: chi_leaf[leaf],
        lambda pk, leaf: leaf.to(torch.int64),
        coarse_shape=coarse_shape, max_level=max_level, max_steps=max_steps, stats=stats,
    )


def _copy_state(packets):
    return packets._replace(**{f: getattr(packets, f).clone() for f in _STATE_FIELDS})


def trace_packets_octree(
    root: torch.Tensor,
    children: torch.Tensor,
    chi_leaf: torch.Tensor,
    packets: PacketBatch,
    tally: torch.Tensor,
    *,
    coarse_shape: Tuple[int, int, int],
    max_level: int,
    max_steps: int = 0,
):
    """March all packets to termination through the octree.

    Args:
        root: [nx·ny·nz] int32 — leaf: -(id+1), internal: node id.
        children: [n_internal, 8] int32, octant index ox·4 + oy·2 + oz.
        chi_leaf: [C] f32 optical depth per coarse-unit length per leaf.
        packets: batch with positions in coarse cell units (``cx, cy, cz``
            are ignored and kept); not modified.
        tally: [C] f32; Σ ℓ(coarse units)·w is added into it in place.
        max_steps: bound on steps per packet (0 → 4·(nx+ny+nz)·2^max_level).

    Returns (tally, terminated batch); packets stopped by ``max_steps`` are
    still active and count as not absorbed.

    CPU tensors run :func:`trace_packets_octree_reference`; CUDA tensors
    launch K5 (``kernels.trace_octree``), which counts its launches in
    ``kernels.LAUNCHES["trace_octree"]``.
    """
    if chi_leaf.device.type == "cpu":
        return trace_packets_octree_reference(
            root, children, chi_leaf, packets, tally, coarse_shape=coarse_shape,
            max_level=max_level, max_steps=max_steps)
    out = _copy_state(packets)
    trace_octree_cuda(
        root, children, chi_leaf, tally, out._asdict(), coarse_shape=coarse_shape,
        max_level=max_level, eps=wall_eps(coarse_shape, max_level),
        max_steps=default_max_steps(coarse_shape, max_level, max_steps))
    return tally, out


def leaf_of_positions_reference(root, children, px, py, pz, *, coarse_shape, max_level,
                                stats: Optional[dict] = None):
    """Plain PyTorch batched descent: the [P] int32 leaf id of each point
    (coarse cell units).  With ``stats``, ``stats["descent_levels"]``
    receives the internal levels crossed."""
    if stats is not None:
        stats["descent_levels"] = torch.zeros((), dtype=torch.int64, device=px.device)
    return _descend(root, children, px, py, pz, coarse_shape, max_level, stats)[0]


def leaf_of_positions(root, children, px, py, pz, *, coarse_shape, max_level):
    """The leaf id of each point (coarse cell units): the absorption sites'
    leaves in the deep-AMR re-emission generations.

    CPU tensors run :func:`leaf_of_positions_reference`; CUDA tensors launch
    K5d (``kernels.leaf_of_positions``), which counts its launches in
    ``kernels.LAUNCHES["leaf_of_positions"]``.
    """
    if px.device.type == "cpu":
        return leaf_of_positions_reference(
            root, children, px, py, pz, coarse_shape=coarse_shape, max_level=max_level)
    leaf = torch.empty(px.shape, dtype=torch.int32, device=px.device)
    leaf_of_positions_cuda(root, children, px, py, pz, leaf, coarse_shape=coarse_shape,
                           max_level=max_level)
    return leaf


def _spectral_opacity(chi_h, chi_he):
    """χ = χ_H·σ_H + χ_He·σ_He per packet, as XLA on the CPU evaluates the
    JAX march's expression: the He product rounded, then added to the exact
    H product with one rounding.  K5s uses ``__fmaf_rn`` the same way."""

    def chi_of(pk, leaf):
        he = chi_he[leaf] * pk.sig_he
        return _fma(chi_h[leaf], pk.sig_h, he)

    return chi_of


def trace_packets_octree_spectral_reference(
    root, children, chi_h_leaf, chi_he_leaf, packets: SpectralPacketBatch, tally2d, *,
    coarse_shape, max_level, n_bins: int, max_steps: int = 0, stats: Optional[dict] = None,
):
    """Plain PyTorch spectral octree march: Σ ℓ·w goes into the flat
    ``tally2d`` [n_bins·C] at ``fbin·C + leaf``, in place."""
    C = chi_h_leaf.shape[0]
    if tally2d.numel() != n_bins * C:
        raise ValueError(f"tally2d must hold n_bins * C = {n_bins * C} values")
    return _march_reference(
        root, children, packets, tally2d,
        _spectral_opacity(chi_h_leaf, chi_he_leaf),
        lambda pk, leaf: pk.fbin.to(torch.int64) * C + leaf.to(torch.int64),
        coarse_shape=coarse_shape, max_level=max_level, max_steps=max_steps, stats=stats,
    )


def trace_packets_octree_spectral(
    root, children, chi_h_leaf, chi_he_leaf, packets: SpectralPacketBatch, tally2d, *,
    coarse_shape, max_level, n_bins: int, max_steps: int = 0,
):
    """Spectral (multi-frequency) octree march: per-packet H/He cross
    sections over per-leaf χ_H/χ_He fields (per coarse-unit length), the
    deposit into ``tally2d`` [n_bins·C] at ``fbin·C + leaf``, in place.
    Inactive packets are left as they are, so a re-emission generation
    passes its mask as ``active``.  Returns (tally2d, terminated batch).

    CPU tensors run :func:`trace_packets_octree_spectral_reference`; CUDA
    tensors launch K5s (``kernels.trace_octree_spectral``), which counts its
    launches in ``kernels.LAUNCHES["trace_octree_spectral"]``.
    """
    if chi_h_leaf.device.type == "cpu":
        return trace_packets_octree_spectral_reference(
            root, children, chi_h_leaf, chi_he_leaf, packets, tally2d,
            coarse_shape=coarse_shape, max_level=max_level, n_bins=n_bins,
            max_steps=max_steps)
    out = _copy_state(packets)
    trace_octree_spectral_cuda(
        root, children, chi_h_leaf, chi_he_leaf, tally2d, out._asdict(),
        coarse_shape=coarse_shape, max_level=max_level, n_bins=n_bins,
        eps=wall_eps(coarse_shape, max_level),
        max_steps=default_max_steps(coarse_shape, max_level, max_steps))
    return tally2d, out
