"""The cone-marched traversal: K1's estimator on direction-coherent chunks.

Port of ``tools/experimental_cone_kernel.py`` (``trace_packets_cone``, its
Pallas kernel and ``pack_packets``).  Emission ordered by
:mod:`cmacionize_torch.tools.experimental_emission_octa` makes C consecutive
lanes a compact cone, so a chunk of C lanes stays inside one S³ slab of the
grid for many cell crossings.  Each phase places the slab at the chunk's
lagging active lane, gives every lane the path length ℓ through every slab
cell analytically (the axis-separable slab test), and finds the absorption
cell from the optical depth at each cell's entry.

The estimator is ``ops/traversal.py:trace_packets``'s (ℓ·w deposits per
cell, absorption at the target τ), with a path split at the slab walls: the
tallies agree to f32 reassociation.  Lanes still active after
``max_phases`` keep state 0 and are finished by the caller with
:func:`cmacionize_torch.ops.traversal.trace_packets`.

Packet state (row-major, so a chunk reads two dense blocks):

    pf f32 [P, 8]: px py pz dx dy dz tau_left weight   (positions: cell units)
    pi i32 [P, 8]: cx cy cz state 0 0 0 0
    state: 0 = active, 1 = absorbed, 2 = escaped.

:func:`trace_packets_cone` dispatches on the device: CPU tensors run
:func:`trace_packets_cone_reference`, the plain version (a PyTorch
transcription of the Pallas kernel's arithmetic); CUDA tensors launch K10,
the hand-written kernel in ``csrc/trace_packets_cone.cu``.  There is no
fallback between the two.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cmacionize_torch.kernels.trace_packets_cone import trace_packets_cone_cuda
from cmacionize_torch.ops.traversal import _fma

_EPS_DIR = 1e-9
_NUDGE = 1e-4
_TINY = 1e-30
_BIG = 1 << 30  # the lag metric of a lane that is not active
# chunks the plain version marches side by side; the tally adds their
# deposits in chunk order within each phase
_GROUP = 32


def _check(pf, shape, slab, chunk):
    nx, ny, nz = shape
    P = pf.shape[0]
    if P % chunk:
        raise ValueError(f"P={P} not divisible by chunk={chunk}")
    if min(nx, ny, nz) < slab:
        raise ValueError("grid smaller than slab")


def _prefix_scan_steps(S):
    """(axis, coord_shift, lane_shift) of the inclusive prefix scans."""
    steps = []
    for axis, stride in ((2, 1), (1, S), (0, S * S)):
        shift = 1
        while shift < S:
            steps.append((axis, shift, shift * stride))
            shift *= 2
    return steps


def _expand(v, S, axis):
    """[G, C, S] per-axis values -> [G, C, S³], flat index ((gx*S)+gy)*S+gz."""
    G, C = v.shape[:2]
    view = [G, C, 1, 1, 1]
    view[2 + axis] = S
    return v.reshape(view).expand(G, C, S, S, S).reshape(G, C, S * S * S)


def _march_group(chi_flat, tally_flat, pf, pi, shape, S, max_phases, record=None, trace=None):
    """March G chunks ([G, C, 8] packet blocks) side by side, phase for
    phase as the Pallas kernel marches each one; returns the new blocks.
    ``record``, a dict of tensors if given, receives per lane ([G, C]):
    ``unplaced`` or-ed with the lanes absorbed in a phase where no single
    slab cell holds their tau_left, ``hits`` the number of cells that held
    it, and ``first_hit`` ([G, C, 3]) the point where the first of several
    such cells would absorb the lane; and per chunk ([G]) ``phases``, the
    phases it ran, and ``walkers``, the lanes that marched summed over them.
    ``trace``, a dict {(group chunk, lane): list} if given, receives one dict
    per phase for each of those lanes (:func:`_trace_row`)."""
    nx, ny, nz = shape
    G, C = pf.shape[:2]
    S3 = S * S * S
    device = pf.device
    dxv, dyv, dzv, wgt = pf[..., 3], pf[..., 4], pf[..., 5], pf[..., 7]
    px, py, pz, tau = pf[..., 0], pf[..., 1], pf[..., 2], pf[..., 6]
    cx, cy, cz, state = pi[..., 0], pi[..., 1], pi[..., 2], pi[..., 3]
    sxp, syp, szp = dxv > 0.0, dyv > 0.0, dzv > 0.0
    dsx = torch.where(sxp, torch.clamp_min(dxv, _EPS_DIR), torch.clamp_max(dxv, -_EPS_DIR))
    dsy = torch.where(syp, torch.clamp_min(dyv, _EPS_DIR), torch.clamp_max(dyv, -_EPS_DIR))
    dsz = torch.where(szp, torch.clamp_min(dzv, _EPS_DIR), torch.clamp_max(dzv, -_EPS_DIR))
    signs = (sxp, syp, szp)

    g_arr = torch.arange(S, device=device, dtype=torch.float32)
    lane = torch.arange(S3, device=device)
    lane_u = (lane // (S * S), (lane // S) % S, lane % S)
    scans = [
        (axis, (lane_u[axis] >= shift).float(), (lane_u[axis] < S - shift).float(), lane_shift)
        for axis, shift, lane_shift in _prefix_scan_steps(S)
    ]
    lanes = torch.arange(C, device=device, dtype=torch.int32)
    cell = torch.stack(lane_u)  # [3, S³] slab-local cell of each flat slot

    def plane_times(q, ds, sp):
        # cell g spans [g, g+1]; the entry plane is g for + travel, g+1 for −
        entry = g_arr + torch.where(sp[..., None], 0.0, 1.0)
        t_in = (entry - q[..., None]) / ds[..., None]
        t_out = t_in + torch.where(sp[..., None], 1.0, -1.0) / ds[..., None]
        return t_in, t_out

    for _ in range(max_phases):
        active = state == 0
        live = active.any(dim=1)
        if not bool(live.any()):
            break
        # --- slab corner from the lagging active lane: the least signed
        # cell sum, ties to the highest lane
        sgn_sum = (torch.where(sxp, cx, -cx) + torch.where(syp, cy, -cy)
                   + torch.where(szp, cz, -cz))
        metric = torch.where(active, sgn_sum, _BIG)
        lag = metric.min(dim=1, keepdim=True).values
        is_lag = (metric == lag) & active
        lag_i = torch.where(is_lag, lanes, -1).max(dim=1, keepdim=True).values.clamp_min(0)
        lag_i = lag_i.to(torch.int64)
        corner = []
        for c, sp, n in ((cx, sxp, nx), (cy, syp, ny), (cz, szp, nz)):
            lc = c.gather(1, lag_i)
            lf = sp.gather(1, lag_i)
            corner.append(torch.clamp(torch.where(lf, lc, lc - (S - 1)), 0, n - S))
        bx, by, bz = corner  # [G, 1] int32
        flat = ((bx + cell[0]) * ny + (by + cell[1])) * nz + (bz + cell[2])  # [G, S³]
        chi_row = chi_flat[flat][:, None, :]

        # --- slab-local lane coordinates
        gx, gy, gz = cx - bx, cy - by, cz - bz
        march = (active & (gx >= 0) & (gx < S) & (gy >= 0) & (gy < S)
                 & (gz >= 0) & (gz < S))
        marchf = march.float()
        qx, qy, qz = px - bx.float(), py - by.float(), pz - bz.float()

        tix, tox = plane_times(qx, dsx, sxp)
        tiy, toy = plane_times(qy, dsy, syp)
        tiz, toz = plane_times(qz, dsz, szp)
        t_in = torch.maximum(_expand(tix, S, 0),
                             torch.maximum(_expand(tiy, S, 1), _expand(tiz, S, 2)))
        t_out = torch.minimum(_expand(tox, S, 0),
                              torch.minimum(_expand(toy, S, 1), _expand(toz, S, 2)))
        t_lo = torch.clamp_min(t_in, 0.0)
        ell = torch.clamp_min(t_out - t_lo, 0.0)
        chiell = ell * chi_row
        tau_tot = torch.sum(chiell * marchf[..., None], dim=2)
        absorbed_now = march & (tau < tau_tot)
        any_abs = absorbed_now.any(dim=1)

        # slab exit time (exit plane S for + travel, 0 for −)
        t_exit = torch.minimum(
            (torch.where(sxp, float(S), 0.0) - qx) / dsx,
            torch.minimum((torch.where(syp, float(S), 0.0) - qy) / dsy,
                          (torch.where(szp, float(S), 0.0) - qz) / dsz),
        )

        # with absorption in the chunk: the inclusive 3D prefix in each
        # lane's travel order gives the optical depth at every cell's exit
        cum = chiell
        for axis, m_fwd, m_bwd, lane_shift in scans:
            fwd = torch.roll(cum, lane_shift, dims=2) * m_fwd
            bwd = torch.roll(cum, S3 - lane_shift, dims=2) * m_bwd
            cum = cum + torch.where(signs[axis][..., None], fwd, bwd)
        cum_entry = cum - chiell
        tau_c = tau[..., None]
        frac = torch.clamp((tau_c - cum_entry) / torch.clamp_min(chiell, _TINY), 0.0, 1.0)
        wm = (wgt * marchf)[..., None]
        hit = (cum_entry <= tau_c) & (tau_c < cum) & (ell > 0.0)
        t_hit = t_lo + (tau_c - cum_entry) / torch.clamp_min(chi_row, _TINY)
        t_abs = torch.sum(torch.where(hit, t_hit, 0.0), dim=2)
        # the chunk's branch: the Pallas kernel's lax.cond on any_abs
        D = torch.where(any_abs[:, None, None], ell * frac * wm, ell * wm)
        t_abs = torch.where(any_abs[:, None], t_abs, 0.0)
        if record is not None:
            record["phases"] += live
            record["walkers"] += march.sum(dim=1)
            hits = hit.sum(dim=2)
            record["unplaced"] |= absorbed_now & (hits != 1)
            record["hits"] = torch.where(absorbed_now, hits, record["hits"])
            # where several cells hold tau_left, the point that the first of
            # them (the least absorption time) gives
            t_first = torch.where(hit, t_hit, float("inf")).amin(dim=2)
            several = absorbed_now & (hits > 1)
            for k, (p, d) in enumerate(((px, dxv), (py, dyv), (pz, dzv))):
                record["first_hit"][..., k] = torch.where(several, _fma(d, t_first, p),
                                                          record["first_hit"][..., k])
        if trace is not None:
            for (g, c), rows in trace.items():
                rows.append(_trace_row(len(rows), (bx[g, 0], by[g, 0], bz[g, 0]), march[g, c],
                                       tau[g, c], tau_tot[g, c], absorbed_now[g, c], ell[g, c],
                                       chiell[g, c], cum[g, c], hit[g, c], signs, g, c, S))

        dep = torch.sum(D, dim=1)  # [G, S³]
        tally_flat.index_add_(0, flat[live].reshape(-1), dep[live].reshape(-1))

        # --- advance lanes; the new cells are nudged along travel so that a
        # lane on a wall resolves forward
        t_use = torch.where(absorbed_now, t_abs, t_exit)
        npx = torch.where(march, _fma(dxv, t_use, px), px)
        npy = torch.where(march, _fma(dyv, t_use, py), py)
        npz = torch.where(march, _fma(dzv, t_use, pz), pz)
        new_cells = []
        for q, ds, sp, b, c in ((qx, dsx, sxp, bx, cx), (qy, dsy, syp, by, cy),
                                (qz, dsz, szp, bz, cz)):
            nc = torch.floor(_fma(ds, t_use, q) + torch.where(sp, _NUDGE, -_NUDGE))
            new_cells.append(torch.where(march, nc.to(torch.int32) + b, c))
        ncx, ncy, ncz = new_cells
        outside = ((ncx < 0) | (ncx >= nx) | (ncy < 0) | (ncy >= ny)
                   | (ncz < 0) | (ncz >= nz))
        tau = torch.where(march, torch.where(absorbed_now, 0.0, tau - tau_tot), tau)
        state = torch.where(
            march,
            torch.where(absorbed_now, 1, torch.where(outside, 2, state)).to(torch.int32),
            state,
        )
        px, py, pz, cx, cy, cz = npx, npy, npz, ncx, ncy, ncz

    pf_out = torch.stack([px, py, pz, dxv, dyv, dzv, tau, wgt], dim=2)
    zeros = torch.zeros_like(cx)
    pi_out = torch.stack([cx, cy, cz, state, zeros, zeros, zeros, zeros], dim=2)
    return pf_out, pi_out


def _trace_row(phase, corner, march, tau, tau_tot, absorbed, ell, chiell, cum, hit, signs, g, c,
               S):
    """One phase of one lane of the plain march: the slab corner, whether it
    marched, the tau_left it entered with, the slab's optical-depth sum, the
    decision, its cells with l > 0 in travel order with each one's l·chi and
    the prefix scan's optical depth at its exit (the sums that place the
    absorption), and the number of cells that held tau_left."""
    cells = torch.nonzero(ell > 0.0).reshape(-1)
    local = torch.stack((cells // (S * S), (cells // S) % S, cells % S), dim=1)
    rank = sum(torch.where(sign[g, c], local[:, k], S - 1 - local[:, k]) * S ** (2 - k)
               for k, sign in enumerate(signs))
    cells = cells[torch.argsort(rank)]
    return {"phase": phase, "corner": tuple(int(v) for v in corner), "march": bool(march),
            "tau": float(tau), "tau_tot": float(tau_tot), "absorbed": bool(absorbed),
            "cells": cells.tolist(), "chiell": chiell[cells].tolist(),
            "cum": cum[cells].tolist(), "hits": int(hit.sum())}


def trace_packets_cone_reference(
    chi3d: torch.Tensor,
    pf: torch.Tensor,
    pi: torch.Tensor,
    *,
    shape: Tuple[int, int, int],
    slab: int = 8,
    chunk: int = 512,
    max_phases: int = 128,
    stats=None,
    trace_lanes=(),
):
    """Plain PyTorch cone march: the Pallas kernel's arithmetic, phase for
    phase, on ``_GROUP`` chunks at a time (in chunk order, as the TPU's
    sequential grid takes them).  Returns (tally3d, pf_out, pi_out) like
    :func:`trace_packets_cone`; the inputs are not modified.

    The Pallas kernel decides absorption by the slab's optical-depth sum
    (``tau < tau_tot``) and places it by the prefix scans: it adds the
    absorption times of every cell with ``cum_entry <= tau < cum``.  The two
    totals differ at f32 round-off, and so do neighbouring cells' prefix
    sums: a lane whose tau_left lies between the totals is absorbed with no
    cell hit, at ``t_abs = 0``, i.e. where it entered the slab, and one whose
    tau_left lies where two cells' intervals overlap by round-off is placed
    at the sum of both cells' times, beyond both.  With ``stats``,
    ``stats["unplaced"]`` receives a [P] bool tensor of the lanes absorbed
    so, whose positions K10, which sums in travel order and absorbs in the
    first cell that holds tau_left, does not share; ``stats["hits"]`` (int64
    [P]) the number of cells that held each absorbed lane's tau_left;
    ``stats["first_hit"]`` (f32 [P, 3]) where the first of several such cells
    would absorb the lane (0 elsewhere); ``stats["phases"]`` and
    ``stats["walkers"]`` (int64 [P / chunk]) the phases each chunk ran and
    the lanes that marched in them; and ``stats["trace"]`` {lane: one dict
    per phase} for the lanes of ``trace_lanes`` (:func:`_trace_row`).
    """
    _check(pf, shape, slab, chunk)
    P = pf.shape[0]
    chi_flat = chi3d.reshape(-1)
    tally = torch.zeros(shape, dtype=torch.float32, device=chi3d.device)
    tally_flat = tally.view(-1)
    pf_b = pf.reshape(P // chunk, chunk, 8)
    pi_b = pi.reshape(P // chunk, chunk, 8)
    record = traces = None
    if stats is not None:
        blocks = (P // chunk, chunk)
        record = {"unplaced": torch.zeros(blocks, dtype=torch.bool, device=chi3d.device),
                  "hits": torch.zeros(blocks, dtype=torch.int64, device=chi3d.device),
                  "first_hit": torch.zeros((*blocks, 3), device=chi3d.device),
                  "phases": torch.zeros(blocks[0], dtype=torch.int64, device=chi3d.device),
                  "walkers": torch.zeros(blocks[0], dtype=torch.int64, device=chi3d.device)}
        traces = {int(lane): [] for lane in trace_lanes}
        stats["trace"] = traces
    pf_out, pi_out = [], []
    for start in range(0, P // chunk, _GROUP):
        group = slice(start, start + _GROUP)
        part = None if record is None else {k: v[group] for k, v in record.items()}
        trace = {(lane // chunk - start, lane % chunk): rows
                 for lane, rows in (traces or {}).items()
                 if start <= lane // chunk < start + _GROUP} or None
        f, i = _march_group(chi_flat, tally_flat, pf_b[group], pi_b[group], shape, slab,
                            max_phases, part, trace)
        if part is not None:
            for k, v in part.items():
                record[k][group] = v
        pf_out.append(f)
        pi_out.append(i)
    if stats is not None:
        stats.update({k: v.reshape(-1, 3) if k == "first_hit" else v.reshape(-1)
                      for k, v in record.items()})
    return tally, torch.cat(pf_out).reshape(P, 8), torch.cat(pi_out).reshape(P, 8)


def trace_packets_cone(
    chi3d: torch.Tensor,
    pf: torch.Tensor,
    pi: torch.Tensor,
    *,
    shape: Tuple[int, int, int],
    slab: int = 8,
    chunk: int = 512,
    max_phases: int = 128,
):
    """March direction-coherent packet chunks through the grid.

    Args:
        chi3d: [nx, ny, nz] opacity (optical depth per cell-unit length).
        pf / pi: packet state (see the module docstring); P % chunk == 0.
            Not modified.
        shape, slab, chunk, max_phases: geometry and configuration.

    Returns (tally3d, pf_out, pi_out).  Lanes left with state 0 must be
    finished by the caller.  CPU tensors run
    :func:`trace_packets_cone_reference`; CUDA tensors launch K10
    (``kernels.trace_packets_cone``), which counts its launches in
    ``kernels.LAUNCHES["trace_packets_cone"]``.
    """
    _check(pf, shape, slab, chunk)
    if chi3d.device.type == "cpu":
        return trace_packets_cone_reference(
            chi3d, pf, pi, shape=shape, slab=slab, chunk=chunk, max_phases=max_phases)
    tally = torch.zeros(shape, dtype=torch.float32, device=chi3d.device)
    pf_out, pi_out = pf.clone(), pi.clone()
    trace_packets_cone_cuda(chi3d, tally, pf_out, pi_out, shape=shape, slab=slab,
                            chunk=chunk, max_phases=max_phases)
    return tally, pf_out, pi_out


def lane_verdicts(out_k, out_r, stats, *, position_tol: float, diagonal: float) -> dict:
    """K10's lanes held against the plain version's (``chip_smoke.py``'s
    phase 33): ``out_k`` and ``out_r`` are (tally, pf, pi) of K10 and of
    :func:`trace_packets_cone_reference` with ``stats``.

    Where the states agree and the plain version placed the lane, the
    positions must agree within ``position_tol`` cells.  A lane that the
    plain version left unplaced and K10 absorbed: where no cell held its
    tau_left (the plain version left it where it entered the slab), K10's
    point lies on the ray within ``position_tol``, ahead of the plain
    version's by at most ``diagonal`` (K10 placed it in that slab, or in the
    next with what round-off left of tau_left); where several cells held it
    (the plain version added their times), K10's point is the first such
    cell's within ``position_tol``.  Returns the counts of state mismatches
    and unplaced lanes, the distances along the ray of the lanes placed
    ahead and of the plain version's points of several cells from K10's,
    the worst position error and the cell mismatches of the placed lanes,
    and the refused lanes."""
    (_, pf_k, pi_k), (_, pf_r, pi_r) = out_k, out_r
    unplaced = stats["unplaced"]
    sk, sr = pi_k[:, 3], pi_r[:, 3]
    placed = (sk == sr) & ~unplaced
    step = pf_k[:, :3] - pf_r[:, :3]
    pos_err = step.abs().amax(dim=1)
    along = (step * pf_r[:, 3:6]).sum(dim=1)
    on_ray = (step - along[:, None] * pf_r[:, 3:6]).abs().amax(dim=1) <= position_tol
    absorbed = unplaced & (sk == 1)
    several = absorbed & (stats["hits"] > 1)
    ahead = (absorbed & ~several & on_ray & (along >= -position_tol)
             & (along <= diagonal + position_tol))
    first = several & ((pf_k[:, :3] - stats["first_hit"]).abs().amax(dim=1) <= position_tol)
    refused = (placed & (pos_err > position_tol)) | (absorbed & ~ahead & ~first)
    return {"state_mismatch": int((sk != sr).sum()), "unplaced": int(unplaced.sum()),
            "ahead": along[ahead].tolist(), "several": along[several].tolist(),
            "pos_diff": float(pos_err[placed].max()) if bool(placed.any()) else 0.0,
            "cell_mismatch": int((pi_k[placed, :3] != pi_r[placed, :3]).any(dim=1).sum()),
            "refused": torch.nonzero(refused).reshape(-1).tolist()}


def pack_packets(position, direction, tau, weight, shape):
    """[P, 3] tensors (cell units) -> (pf, pi) row-major packet state."""
    P = position.shape[0]
    cells = [
        torch.clamp(torch.floor(position[:, k]).to(torch.int32), 0, shape[k] - 1)
        for k in range(3)
    ]
    pf = torch.cat([position.float(), direction.float(), tau[:, None].float(),
                    weight[:, None].float()], dim=1)
    zeros = torch.zeros(P, dtype=torch.int32, device=position.device)
    pi = torch.stack([*cells, zeros, zeros, zeros, zeros, zeros], dim=1)
    return pf, pi
