"""Batched photon-packet traversal through a Cartesian grid.

Port of ``cmacionize_tpu/ops/traversal.py:trace_packets`` (the single-channel
march of the Strömgren path).  Packets are structure-of-arrays ``[P]``
tensors with positions in cell units; each one marches cell by cell until it
reaches its target optical depth τ (absorption) or leaves the box (escape),
adding path length × weight into a flat per-cell tally whose index is
``(cx*ny + cy)*nz + cz``.

:func:`trace_packets` dispatches on the device: CPU tensors go through the
plain PyTorch version :func:`trace_packets_reference` (a lockstep loop, like
the JAX march), CUDA tensors through K1, the hand-written kernel in
``csrc/trace_packets.cu``.  There is no fallback between the two.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from cmacionize_torch.kernels.trace_packets import trace_packets_cuda

_EPS_DIR = 1e-12
_CHI_FLOOR = 1e-30


class PacketBatch(NamedTuple):
    """Structure-of-arrays photon packet batch (positions in cell units)."""

    px: torch.Tensor  # [P] position, cell units
    py: torch.Tensor
    pz: torch.Tensor
    cx: torch.Tensor  # [P] int32 current cell index
    cy: torch.Tensor
    cz: torch.Tensor
    dx: torch.Tensor  # [P] normalized direction
    dy: torch.Tensor
    dz: torch.Tensor
    tau_left: torch.Tensor  # [P] remaining target optical depth
    weight: torch.Tensor  # [P] statistical weight
    active: torch.Tensor  # [P] bool — still travelling
    absorbed: torch.Tensor  # [P] bool — reached target tau inside the box

    @property
    def size(self):
        return self.px.shape[0]


def make_packets(position, direction, tau_target, weight, shape) -> PacketBatch:
    """Build a batch from [P,3] position (cell units) / direction tensors."""
    px, py, pz = (position[:, i].contiguous() for i in range(3))
    dx, dy, dz = (direction[:, i].contiguous() for i in range(3))
    cx, cy, cz = (
        torch.clamp(torch.floor(p).to(torch.int32), 0, shape[i] - 1)
        for i, p in enumerate((px, py, pz))
    )
    active = torch.ones_like(weight, dtype=torch.bool)
    absorbed = torch.zeros_like(weight, dtype=torch.bool)
    return PacketBatch(
        px, py, pz, cx, cy, cz, dx, dy, dz, tau_target, weight, active, absorbed
    )


def _wall_distance(pos, cell, dirn):
    """Distance (in cell units) along dirn to the next wall on this axis."""
    positive = dirn > 0.0
    wall = (cell + positive.to(torch.int32)).to(pos.dtype)
    moving = torch.abs(dirn) > _EPS_DIR
    safe = torch.where(moving, dirn, _EPS_DIR)
    t = (wall - pos) / safe
    # a degenerate direction component never crosses its wall
    return torch.where(moving, torch.clamp_min(t, 0.0), math.inf)


def _fma(a, b, c):
    """a·b + c rounded once, as a fused multiply-add: the f32 product is
    exact in f64.  XLA on the CPU fuses the JAX march's position advance this
    way, and K1 uses ``__fmaf_rn`` there, so all three advance alike."""
    return (a.double() * b.double() + c.double()).to(c.dtype)


def _inside(cx, cy, cz, shape):
    nx, ny, nz = shape
    return (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) & (cz >= 0) & (cz < nz)


def _default_max_steps(shape, max_steps):
    return max_steps if max_steps else 4 * (shape[0] + shape[1] + shape[2])


def trace_packets_reference(
    opacity: torch.Tensor,
    packets: PacketBatch,
    tally: torch.Tensor,
    *,
    shape: Tuple[int, int, int],
    periodic: Tuple[bool, bool, bool] = (False, False, False),
    max_steps: int = 0,
):
    """Plain PyTorch march: the JAX lockstep loop, step for step.

    Every still-active packet advances one cell crossing per iteration; the
    loop stops when none is active or after ``max_steps`` iterations.
    Deposits go into ``tally`` with ``index_add_`` (in place).  A packet
    handed in active with a cell outside the grid counts as escaped.

    Returns (tally, packets) like :func:`trace_packets`.
    """
    nx, ny, nz = shape
    max_steps = _default_max_steps(shape, max_steps)
    pk = packets._replace(
        active=packets.active & _inside(packets.cx, packets.cy, packets.cz, shape)
    )
    step_x, step_y, step_z = (
        torch.where(d > 0, 1, -1).to(torch.int32) for d in (pk.dx, pk.dy, pk.dz)
    )
    step = 0
    while step < max_steps and bool(torch.any(pk.active)):
        tx = _wall_distance(pk.px, pk.cx, pk.dx)
        ty = _wall_distance(pk.py, pk.cy, pk.dy)
        tz = _wall_distance(pk.pz, pk.cz, pk.dz)
        l_exit = torch.minimum(tx, torch.minimum(ty, tz))

        # terminated packets may sit outside the grid: gather/scatter them
        # at cell 0 with a zero deposit
        flat = torch.where(pk.active, (pk.cx * ny + pk.cy) * nz + pk.cz, 0)
        chi = torch.clamp_min(opacity[flat], _CHI_FLOOR)
        tau_cell = chi * l_exit
        absorbed_now = pk.active & (tau_cell >= pk.tau_left)
        l_travel = torch.where(absorbed_now, pk.tau_left / chi, l_exit)
        deposit = torch.where(pk.active, l_travel * pk.weight, 0.0)
        tally.index_add_(0, flat.to(torch.int64), deposit.to(tally.dtype))

        # advance: land exactly on the crossed wall (axis of minimal t) or at
        # the absorption point inside the cell
        px = _fma(pk.dx, l_travel, pk.px)
        py = _fma(pk.dy, l_travel, pk.py)
        pz = _fma(pk.dz, l_travel, pk.pz)
        moving = pk.active & ~absorbed_now
        cross_x = moving & (l_exit == tx)
        cross_y = moving & ~cross_x & (l_exit == ty)
        cross_z = moving & ~cross_x & ~cross_y
        cx = pk.cx + torch.where(cross_x, step_x, 0)
        cy = pk.cy + torch.where(cross_y, step_y, 0)
        cz = pk.cz + torch.where(cross_z, step_z, 0)

        # snap the crossed coordinate onto the wall to avoid drift
        px = torch.where(cross_x, torch.where(pk.dx > 0, pk.cx + 1, pk.cx).to(px.dtype), px)
        py = torch.where(cross_y, torch.where(pk.dy > 0, pk.cy + 1, pk.cy).to(py.dtype), py)
        pz = torch.where(cross_z, torch.where(pk.dz > 0, pk.cz + 1, pk.cz).to(pz.dtype), pz)

        # periodic wrap or escape
        if periodic[0]:
            px = torch.where(cx < 0, px + nx, torch.where(cx >= nx, px - nx, px))
            cx = torch.remainder(cx, nx)
        if periodic[1]:
            py = torch.where(cy < 0, py + ny, torch.where(cy >= ny, py - ny, py))
            cy = torch.remainder(cy, ny)
        if periodic[2]:
            pz = torch.where(cz < 0, pz + nz, torch.where(cz >= nz, pz - nz, pz))
            cz = torch.remainder(cz, nz)

        tau_left = torch.where(absorbed_now, 0.0, pk.tau_left - tau_cell)
        active = pk.active & ~absorbed_now & _inside(cx, cy, cz, shape)
        absorbed = pk.absorbed | absorbed_now

        # freeze terminated packets: their final state (position, remaining
        # tau) is what re-emission and the domain exchange read
        upd = pk.active
        pk = PacketBatch(
            torch.where(upd, px, pk.px),
            torch.where(upd, py, pk.py),
            torch.where(upd, pz, pk.pz),
            torch.where(upd, cx, pk.cx),
            torch.where(upd, cy, pk.cy),
            torch.where(upd, cz, pk.cz),
            pk.dx, pk.dy, pk.dz,
            torch.where(upd, tau_left, pk.tau_left),
            pk.weight, active, absorbed,
        )
        step += 1
    return tally, pk


_STATE_FIELDS = ("px", "py", "pz", "cx", "cy", "cz", "tau_left", "active", "absorbed")


def trace_packets(
    opacity: torch.Tensor,
    packets: PacketBatch,
    tally: torch.Tensor,
    *,
    shape: Tuple[int, int, int],
    periodic: Tuple[bool, bool, bool] = (False, False, False),
    max_steps: int = 0,
):
    """March all packets to termination, accumulating path-length tallies.

    Args:
        opacity: [ncell] flat χ — optical depth per unit cell-length, i.e.
            n_H·x_n·σ·Δx evaluated per cell (≥ 0).
        packets: the batch (positions in cell units); not modified.
        tally: [ncell] flat accumulator; Σ ℓ(cell units)·w is added into it
            in place.
        shape: grid shape.
        periodic: per-axis periodic wrap.
        max_steps: bound on cell crossings per packet (0 → 4·(nx+ny+nz)).

    Returns:
        (tally, packets): the tally and the terminated batch (absorbed flags
        and final positions are valid for re-emission handling).

    CPU tensors run :func:`trace_packets_reference`; CUDA tensors launch K1
    (``kernels.trace_packets.trace_packets_cuda``), which counts its launches
    in ``kernels.LAUNCHES["trace_packets"]``.
    """
    if opacity.device.type == "cpu":
        return trace_packets_reference(
            opacity, packets, tally, shape=shape, periodic=periodic,
            max_steps=max_steps,
        )
    out = packets._replace(**{f: getattr(packets, f).clone() for f in _STATE_FIELDS})
    trace_packets_cuda(
        opacity, tally, out._asdict(),
        shape=shape, periodic=periodic,
        max_steps=_default_max_steps(shape, max_steps),
    )
    return tally, out
