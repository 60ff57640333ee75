"""Batched photon-packet traversal through a Cartesian grid.

Port of ``cmacionize_tpu/ops/traversal.py:trace_packets`` (the single-channel
march of the Strömgren path) and of ``trace_packets_spectral`` (the
frequency-binned march of the multi-frequency path).  Packets are structure-of-arrays ``[P]``
tensors with positions in cell units; each one marches cell by cell until it
reaches its target optical depth τ (absorption) or leaves the box (escape),
adding path length × weight into a flat per-cell tally whose index is
``(cx*ny + cy)*nz + cz``.

:func:`trace_packets` dispatches on the device: CPU tensors go through the
plain PyTorch version :func:`trace_packets_reference` (a lockstep loop, like
the JAX march), CUDA tensors through K1, the hand-written kernel in
``csrc/trace_packets.cu``; :func:`trace_packets_spectral` likewise goes to
:func:`trace_packets_spectral_reference` or to K2
(``csrc/trace_packets_spectral.cu``).  There is no fallback between the two.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from cmacionize_torch.kernels.trace_packets import trace_packets_cuda
from cmacionize_torch.kernels.trace_packets_spectral import trace_packets_spectral_cuda

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
    """a·b + c of f32 tensors rounded once, as a fused multiply-add.  XLA on
    the CPU fuses the JAX march's position advance this way, and K1 uses
    ``__fmaf_rn`` there, so all three advance alike.

    The f32 product is exact in f64; the f64 sum is rounded to odd (its
    rounding error, from a TwoSum, moves an inexact even sum to its odd
    neighbour), so that the final rounding to f32 is the correctly rounded
    one.  A plain f64 sum rounds twice, and where it lands exactly halfway
    between two f32 values it can pick the other one."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    t = s - p
    err = (p - (s - t)) + (cd - t)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(c.dtype)


def _inside(cx, cy, cz, shape):
    nx, ny, nz = shape
    return (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) & (cz >= 0) & (cz < nz)


def _default_max_steps(shape, max_steps):
    return max_steps if max_steps else 4 * (shape[0] + shape[1] + shape[2])


def _march_reference(pk, tally, chi_of, tally_index, *, shape, periodic, max_steps,
                     stats=None):
    """The JAX lockstep loop, step for step, for either batch type.

    ``chi_of(pk, flat)`` gives each packet's opacity in its cell and
    ``tally_index(pk, flat)`` the tally slot of its deposit.  With ``stats``,
    ``stats["packet_steps"]`` receives the number of packet steps taken (a
    device tensor) and ``stats["loop_steps"]`` the loop's iterations, the
    most steps any packet took (an int); without it nothing is counted."""
    nx, ny, nz = shape
    if stats is not None:
        stats["packet_steps"] = torch.zeros((), dtype=torch.int64, device=tally.device)
    max_steps = _default_max_steps(shape, max_steps)
    pk = pk._replace(active=pk.active & _inside(pk.cx, pk.cy, pk.cz, shape))
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
        chi = torch.clamp_min(chi_of(pk, flat), _CHI_FLOOR)
        tau_cell = chi * l_exit
        absorbed_now = pk.active & (tau_cell >= pk.tau_left)
        l_travel = torch.where(absorbed_now, pk.tau_left / chi, l_exit)
        deposit = torch.where(pk.active, l_travel * pk.weight, 0.0)
        tally.index_add_(0, tally_index(pk, flat).to(torch.int64), deposit.to(tally.dtype))

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
        if stats is not None:
            stats["packet_steps"] += upd.sum()
        pk = pk._replace(
            px=torch.where(upd, px, pk.px),
            py=torch.where(upd, py, pk.py),
            pz=torch.where(upd, pz, pk.pz),
            cx=torch.where(upd, cx, pk.cx),
            cy=torch.where(upd, cy, pk.cy),
            cz=torch.where(upd, cz, pk.cz),
            tau_left=torch.where(upd, tau_left, pk.tau_left),
            active=active,
            absorbed=absorbed,
        )
        step += 1
    if stats is not None:
        stats["loop_steps"] = step
    return tally, pk


def trace_packets_reference(
    opacity: torch.Tensor,
    packets: PacketBatch,
    tally: torch.Tensor,
    *,
    shape: Tuple[int, int, int],
    periodic: Tuple[bool, bool, bool] = (False, False, False),
    max_steps: int = 0,
    stats=None,
):
    """Plain PyTorch march: the JAX lockstep loop, step for step.

    Every still-active packet advances one cell crossing per iteration; the
    loop stops when none is active or after ``max_steps`` iterations.
    Deposits go into ``tally`` with ``index_add_`` (in place).  A packet
    handed in active with a cell outside the grid counts as escaped.

    Returns (tally, packets) like :func:`trace_packets`.
    """
    return _march_reference(
        packets, tally,
        lambda pk, flat: opacity[flat],
        lambda pk, flat: flat,
        shape=shape, periodic=periodic, max_steps=max_steps, stats=stats,
    )


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


# ---------------------------------------------------------------------------
# Spectral (multi-frequency) traversal
# ---------------------------------------------------------------------------


class SpectralPacketBatch(NamedTuple):
    """Packet batch with per-packet H/He cross sections and a frequency bin.

    Each crossing deposits ℓ·w once into the (bin, cell) slot of a
    frequency-binned tally; the per-ion mean-intensity and heating integrals
    follow from one matrix product (:func:`spectral_tallies_to_ion_integrals`).
    Opacity involves only H and He, carried per packet as σ_H(ν), σ_He(ν).
    """

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    tau_left: torch.Tensor
    weight: torch.Tensor
    sig_h: torch.Tensor  # [P] sigma_H(nu) (m^2)
    sig_he: torch.Tensor  # [P] sigma_He(nu) (m^2)
    fbin: torch.Tensor  # [P] int32 frequency bin
    active: torch.Tensor
    absorbed: torch.Tensor

    @property
    def size(self):
        return self.px.shape[0]


def make_spectral_packets(
    position, direction, tau_target, weight, sig_h, sig_he, fbin, shape
) -> SpectralPacketBatch:
    """Build a spectral batch from [P,3] position (cell units) / direction."""
    pk = make_packets(position, direction, tau_target, weight, shape)
    return SpectralPacketBatch(
        *pk[:11], sig_h.contiguous(), sig_he.contiguous(), fbin.contiguous(),
        pk.active, pk.absorbed,
    )


def _spectral_opacity(chi_h, chi_he):
    """χ = χ_H·σ_H + χ_He·σ_He per packet, as XLA on the CPU evaluates the
    JAX march's expression: the He product is rounded, then added to the
    exact H product with one rounding (a fused multiply-add).  K2 uses
    ``__fmaf_rn`` the same way."""

    def chi_of(pk, flat):
        he = chi_he[flat] * pk.sig_he
        return _fma(chi_h[flat], pk.sig_h, he)

    return chi_of


def trace_packets_spectral_reference(
    chi_h: torch.Tensor,
    chi_he: torch.Tensor,
    packets: SpectralPacketBatch,
    tally2d: torch.Tensor,
    *,
    shape: Tuple[int, int, int],
    n_bins: int,
    periodic: Tuple[bool, bool, bool] = (False, False, False),
    max_steps: int = 0,
    stats=None,
):
    """Plain PyTorch spectral march: the JAX lockstep loop of
    ``trace_packets_spectral``, step for step.  Returns (tally2d, packets)
    like :func:`trace_packets_spectral`."""
    ncell = shape[0] * shape[1] * shape[2]
    if tally2d.numel() != n_bins * ncell:
        raise ValueError(f"tally2d must hold n_bins * ncell = {n_bins * ncell} values")
    return _march_reference(
        packets, tally2d,
        _spectral_opacity(chi_h, chi_he),
        lambda pk, flat: pk.fbin * ncell + flat,
        shape=shape, periodic=periodic, max_steps=max_steps, stats=stats,
    )


def trace_packets_spectral(
    chi_h: torch.Tensor,
    chi_he: torch.Tensor,
    packets: SpectralPacketBatch,
    tally2d: torch.Tensor,
    *,
    shape: Tuple[int, int, int],
    n_bins: int,
    periodic: Tuple[bool, bool, bool] = (False, False, False),
    max_steps: int = 0,
):
    """March a spectral batch to termination; ℓ·w goes into ``tally2d``
    (flat [n_bins·ncell], slot ``fbin·ncell + cell``) in place.

    chi_h / chi_he: flat [ncell] fields n_H·x_H·Δx and n_H·A_He·x_He·Δx
    (optical depth per σ per cell-unit length).  Inactive packets are left
    as they are, so a re-emission generation passes its mask as ``active``.

    CPU tensors run :func:`trace_packets_spectral_reference`; CUDA tensors
    launch K2 (``kernels.trace_packets_spectral``), which counts its launches
    in ``kernels.LAUNCHES["trace_packets_spectral"]``.
    """
    if chi_h.device.type == "cpu":
        return trace_packets_spectral_reference(
            chi_h, chi_he, packets, tally2d, shape=shape, n_bins=n_bins,
            periodic=periodic, max_steps=max_steps,
        )
    out = packets._replace(**{f: getattr(packets, f).clone() for f in _STATE_FIELDS})
    trace_packets_spectral_cuda(
        chi_h, chi_he, tally2d, out._asdict(),
        shape=shape, n_bins=n_bins, periodic=periodic,
        max_steps=_default_max_steps(shape, max_steps),
    )
    return tally2d, out


def spectral_tallies_to_ion_integrals(tally2d, sigma_table, heating_weights, n_cell: int):
    """[n_bins·n_cell] binned tallies → [n_ion + 2, n_cell] per-ion and
    heating integrals, as one f32 matrix product.

    sigma_table: [n_ion, n_bins] σ_i at the bin frequencies (m²);
    heating_weights: [2, n_bins] σ_{H,He}(ν)·(ν - ν_ion).  The product runs in
    full f32, never TF32: a TF32 product would drop 10 mantissa bits from
    every heating integral.
    """
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "spectral_tallies_to_ion_integrals: torch.backends.cuda.matmul."
            "allow_tf32 is on; the ion integrals need full f32 products"
        )
    t2 = tally2d.reshape(-1, n_cell)  # [n_bins, n_cell]
    weights = torch.cat([sigma_table, heating_weights], dim=0).to(t2.dtype)
    return torch.matmul(weights, t2)
