"""3D domain decomposition: the grid tiled (sx, sy, sz) over a 3-axis mesh,
photon packets exchanged over all six faces, the source tile replicated.

Port of ``cmacionize_tpu/parallel/domain3d.py``.  The 27 travel directions
collapse to three face exchanges per superstep (x, then y, then z), so an
edge or corner crossing resolves as two or three hops inside one superstep.
Packets carry global cell-unit positions between marches; each shard marches
only the packets whose target tile is its own, in local coordinates.  Every
shard first traces its share of the emission through a copy of the source
tile's opacity (a psum broadcast), and the copy tallies are summed onto the
owner.

One exchange (:func:`_exchange_axis`) is K9p (the minus and plus send
buffers in one pass), ``ppermute``, and K9c (keep, then the lanes received
from minus, then those from plus, re-compacted to the carry width).
"""

from __future__ import annotations

from typing import Tuple

import torch

from cmacionize_torch.ops import ionization, traversal
from cmacionize_torch.parallel.domain import (
    _count,
    _diagnostics,
    bucket_codes,
    compact,
    default_capacity,
    partition,
)
from cmacionize_torch.parallel.mesh import LocalMesh

AXES = ("dx", "dy", "dz")


def make_mesh_3d(tiling: Tuple[int, int, int], devices=None) -> LocalMesh:
    """A mesh with axes ("dx", "dy", "dz") of shape ``tiling``;
    ``devices=None`` means the visible CUDA devices."""
    return LocalMesh(tuple(int(t) for t in tiling), AXES, devices)


def _exchange_axis(mesh, fields, mask, target, axis, capacity):
    """One bidirectional face exchange along a mesh axis.

    ``fields``: per shard a tuple of [N] packet fields (global coordinates);
    ``mask``: per shard the [N] lanes to forward; ``target``: per shard each
    lane's tile coordinate on ``axis``.  Lanes with target below the shard's
    coordinate go to the minus neighbour, above it to the plus neighbour, the
    rest stay.  Returns (fields, mask, overflow) per shard, the carry
    re-compacted to its width N."""
    my = mesh.axis_index(axis)
    sends, keeps = [], []
    for i in range(mesh.size):
        go_minus = mask[i] & (target[i] < my[i])
        go_plus = mask[i] & (target[i] > my[i])
        keeps.append(mask[i] & ~go_minus & ~go_plus)
        sends.append(partition(fields[i], bucket_codes(go_minus, go_plus),
                               (capacity, capacity)))
    recv_from_minus = mesh.ppermute(
        [(*s[1][0], s[1][1]) for s in sends], axis, 1)
    recv_from_plus = mesh.ppermute(
        [(*s[0][0], s[0][1]) for s in sends], axis, -1)
    out_fields, out_mask, overflow = [], [], []
    for i in range(mesh.size):
        n_carry = mask[i].shape[0]
        merged = tuple(
            torch.cat([k, a, b])
            for k, a, b in zip(fields[i], recv_from_minus[i][:-1], recv_from_plus[i][:-1])
        )
        merged_mask = torch.cat([keeps[i], recv_from_minus[i][-1], recv_from_plus[i][-1]])
        f, m, ov_c = compact(merged, merged_mask, n_carry)
        (_, _, ov_m), (_, _, ov_p) = sends[i]
        out_fields.append(f)
        out_mask.append(m)
        overflow.append(ov_m + ov_p + ov_c)
    return out_fields, out_mask, overflow


def make_domain_mc_iteration_3d(
    mesh,
    *,
    global_shape: Tuple[int, int, int],
    n_photons: int,
    sigma_dx: float,
    source_gpos: Tuple[float, float, float],
    jfac_scale: float,
    alpha: float,
    max_supersteps: int = 64,
    capacity: int = 0,
):
    """A 3D domain-decomposed H-only MC iteration.

    Returns ``step(emit, neutral_fraction, number_density) →
    (new_neutral_fraction, jH, diagnostics)`` on per-shard [tnx, tny, tnz]
    lists, ``emit`` as :func:`~cmacionize_torch.parallel.domain.make_domain_mc_iteration`
    takes it (positions in tile cell units), ``diagnostics`` as it gives
    them, with ``packets_traced`` per shard in the mesh's order."""
    sx, sy, sz = (mesh.shape[a] for a in AXES)
    n_dev = sx * sy * sz
    nx, ny, nz = global_shape
    if nx % sx or ny % sy or nz % sz:
        raise ValueError(f"grid {global_shape} does not divide over tiling {(sx, sy, sz)}")
    tnx, tny, tnz = nx // sx, ny // sy, nz // sz
    local_shape = (tnx, tny, tnz)
    n_loc = n_photons // n_dev
    # carry width: one shard may hold most in-flight packets for a while, so
    # the carry is sized on the global photon count; only the exchange
    # buffers are narrow
    n_carry = n_photons
    capacity = default_capacity(n_photons) if capacity <= 0 else min(capacity, n_carry)

    # tile containing the source (clamped inside the grid)
    st = (
        min(int(source_gpos[0]) // tnx, sx - 1),
        min(int(source_gpos[1]) // tny, sy - 1),
        min(int(source_gpos[2]) // tnz, sz - 1),
    )
    src_local = (
        source_gpos[0] - st[0] * tnx,
        source_gpos[1] - st[1] * tny,
        source_gpos[2] - st[2] * tnz,
    )
    coords = [mesh.coords(i) for i in range(mesh.size)]
    owner = coords.index(st)
    shards = range(mesh.size)

    def target(g, d, n_tile, n_axis):
        cell_eff = torch.where(d >= 0, torch.floor(g), torch.ceil(g) - 1.0).to(torch.int32)
        inside = (cell_eff >= 0) & (cell_eff < n_axis)
        return torch.div(cell_eff, n_tile, rounding_mode="floor"), inside

    def classify(gx, gy, gz, dx, dy, dz):
        tx, in_x = target(gx, dx, tnx, nx)
        ty, in_y = target(gy, dy, tny, ny)
        tz, in_z = target(gz, dz, tnz, nz)
        return (tx, ty, tz), in_x & in_y & in_z

    def local_cell(lp, d, n_tile):
        cell = torch.where(d >= 0, torch.floor(lp), torch.ceil(lp) - 1.0).to(torch.int32)
        return torch.clamp(cell, 0, n_tile - 1)

    def step(emit, neutral_fraction, number_density):
        chis = [(nd * x * sigma_dx).reshape(-1)
                for nd, x in zip(number_density, neutral_fraction)]
        offsets = [tuple(float(c * t) for c, t in zip(coords[i], local_shape)) for i in shards]

        # ---- copy phase: every shard traces its emission share through a
        # copy of the source tile (psum broadcast of its chi)
        chi_src = mesh.psum(
            [chis[i] if i == owner else torch.zeros_like(chis[i]) for i in shards], AXES)
        copy_tallies, fields, pending, n_esc = [], [], [], []
        for i in shards:
            px, py, pz, dx, dy, dz, tau, weight = emit(i, n_loc, src_local)
            pk0 = traversal.make_packets(
                torch.stack([px, py, pz], 1), torch.stack([dx, dy, dz], 1),
                tau, weight, local_shape,
            )
            copy_tally, pk0 = traversal.trace_packets(
                chi_src[i], pk0, torch.zeros_like(chi_src[i]), shape=local_shape)
            copy_tallies.append(copy_tally)
            # survivors re-enter in GLOBAL coordinates
            gx = pk0.px + float(st[0] * tnx)
            gy = pk0.py + float(st[1] * tny)
            gz = pk0.pz + float(st[2] * tnz)
            fwd = ~pk0.absorbed & ~pk0.active  # left the source tile
            _, inside = classify(gx, gy, gz, pk0.dx, pk0.dy, pk0.dz)
            n_esc.append(_count(fwd & ~inside))
            f0 = (gx, gy, gz, pk0.dx, pk0.dy, pk0.dz, pk0.tau_left, pk0.weight)
            p0 = fwd & inside
            # widen the carry from the local emission share to the global width
            pad = n_carry - n_loc
            if pad > 0:
                f0 = tuple(torch.cat([f, f.new_zeros(pad)]) for f in f0)
                p0 = torch.cat([p0, p0.new_zeros(pad)])
            fields.append(f0)
            pending.append(p0)
        # the owner absorbs the psum of all copy tallies
        summed = mesh.psum(copy_tallies, AXES)
        tallies = [summed[i] if i == owner else torch.zeros_like(chis[i]) for i in shards]
        n_traced = [torch.tensor(n_loc, dtype=torch.int64, device=chis[i].device)
                    for i in shards]
        n_over = [torch.zeros((), dtype=torch.int64, device=chis[i].device) for i in shards]

        def n_live():
            return int(mesh.psum([_count(p) for p in pending], AXES)[0])

        steps = 0
        while steps < max_supersteps and n_live() > 0:
            for i in shards:
                _, inside = classify(*fields[i][:6])
                pending[i] = pending[i] & inside
            # forward along each axis in turn (two-hop edge/corner routing)
            for a, axis in enumerate(AXES):
                tgt = [classify(*fields[i][:6])[0][a] for i in shards]
                fields, pending, ov = _exchange_axis(mesh, fields, pending, tgt, axis, capacity)
                n_over = [n + o for n, o in zip(n_over, ov)]

            # packets now on their target shard become active and are marched
            for i in shards:
                gx, gy, gz, dx, dy, dz, tau, weight = fields[i]
                (tx, ty, tz), _ = classify(gx, gy, gz, dx, dy, dz)
                mx, my, mz = coords[i]
                mine = pending[i] & (tx == mx) & (ty == my) & (tz == mz)
                still_pending = pending[i] & ~mine
                x_off, y_off, z_off = offsets[i]
                lpx, lpy, lpz = gx - x_off, gy - y_off, gz - z_off
                pk = traversal.PacketBatch(
                    lpx, lpy, lpz, local_cell(lpx, dx, tnx), local_cell(lpy, dy, tny),
                    local_cell(lpz, dz, tnz), dx, dy, dz, tau, weight,
                    mine, torch.zeros_like(mine),
                )
                tallies[i], pk = traversal.trace_packets(
                    chis[i], pk, tallies[i], shape=local_shape)
                n_traced[i] = n_traced[i] + _count(mine)
                ggx, ggy, ggz = pk.px + x_off, pk.py + y_off, pk.pz + z_off
                fwd = mine & ~pk.absorbed & ~pk.active
                _, inside = classify(ggx, ggy, ggz, pk.dx, pk.dy, pk.dz)
                n_esc[i] = n_esc[i] + _count(fwd & ~inside)
                pending[i] = still_pending | (fwd & inside)
                fields[i] = (ggx, ggy, ggz, pk.dx, pk.dy, pk.dz, pk.tau_left, pk.weight)
            steps += 1

        jH = [t.reshape(local_shape) * jfac_scale for t in tallies]
        new_x = [ionization.hydrogen_neutral_fraction(j, nd, alpha)
                 for j, nd in zip(jH, number_density)]
        stats = {
            "n_escaped": n_esc, "buffer_overflow": n_over,
            "truncated_live": [_count(p) for p in pending],
            "packets_traced": n_traced, "supersteps": steps,
        }
        return new_x, jH, _diagnostics(mesh, AXES, stats)

    return step
