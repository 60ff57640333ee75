"""Domain-decomposed Monte Carlo and hydrodynamics on x-slabs.

Port of ``cmacionize_tpu/parallel/domain.py``: the box is cut into x-slabs,
one per shard of a :class:`~cmacionize_torch.parallel.mesh.LocalMesh` axis,
and the cell arrays live sharded.  Photon packets are marched through their
own slab; the ones that cross a slab face go into fixed-size send buffers,
move to the neighbour with ``ppermute``, and the superstep (march →
exchange → merge) repeats until the global live count is 0.  The hydro step
exchanges a 2-cell halo with the slab neighbours and runs the whole-slab
MUSCL-Hancock update (K3 on the card).

What ran inside JAX's ``shard_map`` runs here as a loop over the shards;
JAX's ``while_loop(cond=psum(live) > 0)`` becomes a host loop that reads one
global live count per superstep.  The march with exit state is
:func:`~cmacionize_torch.ops.traversal.trace_packets` (K1 on the card),
whose returned batch carries each packet's final state.  The send side of an
exchange is K9p (:func:`partition`), the re-compaction of the received
lanes K9c (:func:`compact`); on CPU tensors both run their plain versions.

Not ported: the sharded spectral trace (``make_domain_spectral_trace``),
``make_domain_rhd_step``'s optional physics (gravity, masks, inflow) and its
scan-fused ``chunk_len`` (the port launches one step at a time); see
ROADMAP.md, queue 1.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from cmacionize_torch import constants
from cmacionize_torch.kernels.compact import compact_cuda, partition_cuda
from cmacionize_torch.models import sources
from cmacionize_torch.ops import hydro as hydro_mod
from cmacionize_torch.ops import ionization, traversal
from cmacionize_torch.ops.riemann import _div

PACKET_FIELDS = ("px", "py", "pz", "dx", "dy", "dz", "tau_left", "weight")
NOT_PORTED_RHD = (
    "not ported to cmacionize_torch yet (ROADMAP.md, queue 1, items 2 and 6: "
    "the Bondi inflow, potentials and masks of the RHD driver)"
)


def default_capacity(n_photons: int) -> int:
    """The exchange buffers' capacity: half the packets plus headroom (a
    source on a slab face sends half its emission through one face), at
    least 4096, at most all the packets."""
    return min(max(4096, n_photons // 2 + n_photons // 32), n_photons)


# ---------------------------------------------------------------- K9c, K9p


def compact_reference(fields, mask: torch.Tensor, capacity: int):
    """Plain version of K9c, JAX's ``_compact``: the stable sort of the
    packed key (members first, each part in input order), truncated to
    ``min(capacity, N)`` lanes and zero-padded to ``capacity``.

    Returns (fields [capacity], in_range [capacity] bool, overflow): overflow
    counts the members that did not fit (a 0-d int64 tensor)."""
    n = mask.shape[0]
    k = min(capacity, n)
    idx = torch.argsort((~mask).to(torch.uint8), stable=True)[:k]
    count = torch.sum(mask, dtype=torch.int64)
    in_range = torch.arange(capacity, device=mask.device) < count
    out = tuple(f[idx] for f in fields)
    if capacity > n:  # widen (e.g. copy-phase survivors into the carry)
        out = tuple(torch.cat([f, f.new_zeros(capacity - n)]) for f in out)
    overflow = torch.clamp_min(count - capacity, 0)
    return out, in_range, overflow


def compact(fields, mask: torch.Tensor, capacity: int):
    """Gather the members of ``mask`` to the front, truncate or pad to
    ``capacity`` (see :func:`compact_reference`).  CPU tensors run the plain
    version; CUDA tensors launch K9c (``kernels.compact.compact_cuda``),
    which counts its launches in ``kernels.LAUNCHES["compact"]``."""
    if mask.device.type == "cpu":
        return compact_reference(fields, mask, capacity)
    return compact_cuda(fields, mask, capacity)


def partition_reference(fields, bucket: torch.Tensor, capacities, shifts=(None, None)):
    """Plain version of K9p: the two ``_compact`` calls of one exchange over
    the same fields, bucket 0 and bucket 1 of the int8 ``bucket`` (-1 stays),
    each with its frame shift added to field 0 where one is given."""
    out = []
    for b, (capacity, shift) in enumerate(zip(capacities, shifts)):
        fields_b, in_range, overflow = compact_reference(fields, bucket == b, capacity)
        if shift is not None:
            fields_b = (fields_b[0] + shift,) + fields_b[1:]
        out.append((fields_b, in_range, overflow))
    return out


def partition(fields, bucket: torch.Tensor, capacities, shifts=(None, None)):
    """The send side of one exchange: bucket 0 (minus) and bucket 1 (plus)
    compacted into their buffers in one pass.  CPU tensors run
    :func:`partition_reference`; CUDA tensors launch K9p
    (``kernels.compact.partition_cuda``, ``kernels.LAUNCHES["partition"]``)."""
    if bucket.device.type == "cpu":
        return partition_reference(fields, bucket, capacities, shifts)
    return partition_cuda(fields, bucket, capacities, shifts)


def bucket_codes(go_minus: torch.Tensor, go_plus: torch.Tensor) -> torch.Tensor:
    """int8 buckets: 0 for ``go_minus``, 1 for ``go_plus``, -1 for neither
    (the two never hold together)."""
    return torch.where(go_minus, 0, torch.where(go_plus, 1, -1)).to(torch.int8)


# ------------------------------------------------------------- the photons


def _count(mask) -> torch.Tensor:
    return torch.sum(mask, dtype=torch.int64)


def _device_slab_mc_loop(
    mesh,
    chis: Sequence[torch.Tensor],
    emit: Callable,
    *,
    axis: str,
    nx_loc: int,
    ny: int,
    nz: int,
    n_photons: int,
    source_gpos,
    capacity: int,
    max_supersteps: int,
):
    """The slab MC trace of one iteration (JAX ``_device_slab_mc_loop``):
    source-replicated emission through a window of slabs, then supersteps
    (march → compact crossers → ppermute → merge) until the global live
    count reaches zero.

    ``chis``: each shard's flat opacity [nx_loc·ny·nz].  ``emit(i, n,
    position)`` gives shard ``i``'s ``n`` packets from ``position`` (window
    cell units) as (px, py, pz, dx, dy, dz, tau, weight).

    Returns (tallies, stats): per-shard tallies and a dict of per-shard
    device counters ``n_escaped``, ``buffer_overflow``, ``truncated_live``,
    ``packets_traced``, and ``supersteps`` (a host int).
    """
    n_dev = mesh.shape[axis]
    shards = range(mesh.size)
    my = mesh.axis_index(axis)
    local_shape = (nx_loc, ny, nz)
    W = n_photons  # fixed carry width (worst case: all packets on one slab)
    ncell_loc = nx_loc * ny * nz
    tallies = [torch.zeros_like(chi) for chi in chis]

    # ---- copy phase: every shard traces its emission share through a
    # replicated window of slabs around the source (the source slab ± 1
    # neighbour, clamped), whose opacity a psum broadcasts
    src_dev = min(int(source_gpos[0]) // nx_loc, n_dev - 1)
    win = min(3, n_dev)
    w0 = min(max(src_dev - 1, 0), n_dev - win)
    win_shape = (win * nx_loc, ny, nz)
    src_win = (source_gpos[0] - w0 * nx_loc, source_gpos[1], source_gpos[2])
    n_loc = max(n_photons // n_dev, 1)
    # exact weight normalization when n_dev does not divide n_photons
    wscale = n_photons / float(n_loc * n_dev)
    slots = [my[i] - w0 for i in shards]
    contrib = []
    for i in shards:
        c = chis[i].new_zeros((win, ncell_loc))
        if 0 <= slots[i] < win:
            c[slots[i]] = chis[i]
        contrib.append(c)
    chi_win = [c.reshape(-1) for c in mesh.psum(contrib, axis)]
    copy_tallies, exits, valids, n_stuck = [], [], [], []
    for i in shards:
        px, py, pz, dx, dy, dz, tau, weight = emit(i, n_loc, src_win)
        if wscale != 1.0:
            weight = weight * wscale
        pk0 = traversal.make_packets(
            torch.stack([px, py, pz], 1), torch.stack([dx, dy, dz], 1),
            tau, weight, win_shape,
        )
        copy_tally, ex0 = traversal.trace_packets(
            chi_win[i], pk0, torch.zeros_like(chi_win[i]), shape=win_shape)
        copy_tallies.append(copy_tally)
        exits.append(ex0)
        valids.append(pk0.active & ~ex0.active)
        n_stuck.append(_count(pk0.active & ex0.active))
    # window owners absorb their slice of the psum of all copy tallies
    tally_win = mesh.psum(copy_tallies, axis)
    for i in shards:
        if 0 <= slots[i] < win:
            tallies[i] = tallies[i] + tally_win[i].reshape(win, ncell_loc)[slots[i]]
    n_traced = [torch.tensor(n_loc, dtype=torch.int64, device=chis[i].device) for i in shards]

    def classify(px, dxv):
        # direction-aware slab membership: a packet exactly on a slab wall
        # belongs to the cell it is about to enter
        cell_eff = torch.where(dxv >= 0, torch.floor(px), torch.ceil(px) - 1.0).to(torch.int32)
        return cell_eff >= 0, cell_eff < nx_loc

    # classify copy-phase exits in the WINDOW frame, then shift into each
    # shard's local frame for the pending machinery
    carry, active, pend_l, pend_r, n_esc, n_over = [], [], [], [], [], []
    for i in shards:
        ex0, valid0 = exits[i], valids[i]
        yz_in0 = (ex0.cy >= 0) & (ex0.cy < ny) & (ex0.cz >= 0) & (ex0.cz < nz)
        gx_cell0 = ex0.cx + w0 * nx_loc
        fwd0 = (
            valid0 & ~ex0.absorbed & yz_in0
            & ((ex0.cx < 0) | (ex0.cx >= win * nx_loc))
            & (gx_cell0 >= 0) & (gx_cell0 < n_dev * nx_loc)
        )
        n_esc.append(_count(valid0 & ~ex0.absorbed & ~fwd0))
        px0 = ex0.px + float((w0 - my[i]) * nx_loc)
        fields0 = (px0, ex0.py, ex0.pz, ex0.dx, ex0.dy, ex0.dz, ex0.tau_left, ex0.weight)
        fields0, mask0, ov0 = compact(fields0, fwd0, W)
        ge_lo, lt_hi = classify(fields0[0], fields0[3])
        carry.append(fields0)
        active.append(mask0 & ge_lo & lt_hi)
        pend_l.append(mask0 & ~ge_lo)
        pend_r.append(mask0 & ~lt_hi)
        n_over.append(ov0)

    def n_live():
        live = [_count(active[i] | pend_l[i] | pend_r[i]) for i in shards]
        return int(mesh.psum(live, axis)[0])  # the superstep's one host read

    step = 0
    while step < max_supersteps and n_live() > 0:
        sends = []
        for i in shards:
            px, py, pz, dxv, dyv, dzv, tau, w = carry[i]
            cy = torch.clamp(torch.floor(py).to(torch.int32), 0, ny - 1)
            cz = torch.clamp(torch.floor(pz).to(torch.int32), 0, nz - 1)
            cx_in = torch.clamp(torch.floor(px).to(torch.int32), 0, nx_loc - 1)
            pk_in = traversal.PacketBatch(
                px, py, pz, cx_in, cy, cz, dxv, dyv, dzv, tau, w,
                active[i], torch.zeros_like(active[i]),
            )
            tallies[i], ex = traversal.trace_packets(
                chis[i], pk_in, tallies[i], shape=local_shape)
            valid = active[i] & ~ex.active
            n_stuck[i] = n_stuck[i] + _count(active[i] & ex.active)
            n_traced[i] = n_traced[i] + _count(active[i])

            at_lo = my[i] == 0
            at_hi = my[i] == n_dev - 1
            yz_in = (ex.cy >= 0) & (ex.cy < ny) & (ex.cz >= 0) & (ex.cz < nz)
            out = valid & ~ex.absorbed
            cross_l = out & yz_in & (ex.cx < 0)
            cross_r = out & yz_in & (ex.cx >= nx_loc)
            go_l_t = cross_l & (not at_lo)
            go_r_t = cross_r & (not at_hi)
            esc_t = out & ~go_l_t & ~go_r_t
            # pending lanes pass through untraced; a pending lane pointing off
            # the domain edge has escaped (its target cell is outside the box)
            go_l_p = pend_l[i] & (not at_lo)
            go_r_p = pend_r[i] & (not at_hi)
            esc_p = (pend_l[i] & at_lo) | (pend_r[i] & at_hi)
            n_esc[i] = n_esc[i] + _count(esc_t) + _count(esc_p)

            exch = tuple(
                torch.cat([getattr(ex, name), f])
                for name, f in zip(PACKET_FIELDS, carry[i])
            )
            bucket = bucket_codes(torch.cat([go_l_t, go_l_p]), torch.cat([go_r_t, go_r_p]))
            # shift the local x coordinate into the receiver's frame
            (send_l, mask_l, ov_l), (send_r, mask_r, ov_r) = partition(
                exch, bucket, (capacity, capacity), (float(nx_loc), float(-nx_loc)))
            n_over[i] = n_over[i] + ov_l + ov_r
            sends.append(((*send_l, mask_l), (*send_r, mask_r)))

        recv_r = mesh.ppermute([s[1] for s in sends], axis, 1)
        recv_l = mesh.ppermute([s[0] for s in sends], axis, -1)
        # the wrap-around lanes of the circular permute carry only inactive
        # padding (go_l / go_r exclude the domain's edges)
        for i in shards:
            merged = tuple(torch.cat([a, b]) for a, b in zip(recv_r[i][:-1], recv_l[i][:-1]))
            merged_mask = torch.cat([recv_r[i][-1], recv_l[i][-1]])
            # restore the fixed carry width (only the exchange buffers are
            # narrow)
            pad = W - merged[0].shape[0]
            if pad > 0:
                merged = tuple(torch.cat([f, f.new_zeros(pad)]) for f in merged)
                merged_mask = torch.cat([merged_mask, merged_mask.new_zeros(pad)])
            else:
                merged, merged_mask, ov_m = compact(merged, merged_mask, W)
                n_over[i] = n_over[i] + ov_m
            carry[i] = merged
            # multi-hop routing: a packet emitted several slabs away keeps
            # hopping; re-classify everything received against this slab
            ge_lo, lt_hi = classify(merged[0], merged[3])
            active[i] = merged_mask & ge_lo & lt_hi
            pend_l[i] = merged_mask & ~ge_lo
            pend_r[i] = merged_mask & ~lt_hi
        step += 1

    truncated = [n_stuck[i] + _count(active[i] | pend_l[i] | pend_r[i]) for i in shards]
    stats = {
        "n_escaped": n_esc, "buffer_overflow": n_over, "truncated_live": truncated,
        "packets_traced": n_traced, "supersteps": step,
    }
    return tallies, stats


def _diagnostics(mesh, axes, stats) -> dict:
    """Global counters of one call: the psums of the per-shard counters (0-d
    device tensors), the per-shard traced packets stacked, the supersteps."""
    out = {k: mesh.psum(stats[k], axes)[0]
           for k in ("n_escaped", "buffer_overflow", "truncated_live")}
    out["packets_traced"] = torch.stack([t.to(mesh.devices[0]) for t in stats["packets_traced"]])
    out["supersteps"] = stats["supersteps"]
    return out


def emit_from(generators):
    """The emission of the drivers: shard ``i`` draws from ``generators[i]``."""
    def emit(i, n, position):
        return sources.emit_point_source(generators[i], n, position)
    return emit


def make_domain_mc_iteration(
    mesh,
    *,
    global_shape: Tuple[int, int, int],
    n_photons: int,
    sigma_dx: float,
    source_gpos: Tuple[float, float, float],
    jfac_scale: float,
    alpha: float,
    axis: str = "x",
    max_supersteps: int = 256,
    capacity: int = 0,
):
    """A domain-decomposed H-only MC iteration on x-slabs.

    Returns ``step(emit, neutral_fraction, number_density) →
    (new_neutral_fraction, jH, diagnostics)``: the fields are lists of
    per-shard [nx_loc, ny, nz] tensors; ``emit`` is as
    :func:`_device_slab_mc_loop` takes it (:func:`emit_from` for the
    shards' generators).  ``diagnostics``: ``n_escaped``,
    ``buffer_overflow`` (packets that did not fit an exchange buffer: rerun
    with a larger ``capacity``), ``truncated_live`` (packets still in flight
    after ``max_supersteps``), each a 0-d tensor, ``packets_traced`` per
    shard and ``supersteps``.  ``capacity`` 0 picks
    :func:`default_capacity`.
    """
    n_dev = mesh.shape[axis]
    nx, ny, nz = global_shape
    if nx % n_dev:
        raise ValueError(f"grid x = {nx} must divide over {n_dev} shards")
    nx_loc = nx // n_dev
    local_shape = (nx_loc, ny, nz)
    capacity = default_capacity(n_photons) if capacity <= 0 else min(capacity, n_photons)

    def step(emit, neutral_fraction, number_density):
        chis = [(nd * x * sigma_dx).reshape(-1)
                for nd, x in zip(number_density, neutral_fraction)]
        tallies, stats = _device_slab_mc_loop(
            mesh, chis, emit, axis=axis, nx_loc=nx_loc, ny=ny, nz=nz,
            n_photons=n_photons, source_gpos=source_gpos, capacity=capacity,
            max_supersteps=max_supersteps,
        )
        jH = [t.reshape(local_shape) * jfac_scale for t in tallies]
        new_x = [ionization.hydrogen_neutral_fraction(j, nd, alpha)
                 for j, nd in zip(jH, number_density)]
        return new_x, jH, _diagnostics(mesh, axis, stats)

    return step


# ---------------------------------------------------------------- the hydro


def _halo_pad_axis0(mesh, fields, axis, bc_lo, bc_hi, *, n=2, flip_sign=False):
    """Pad each shard's x-axis with its neighbours' halos (``ppermute``);
    the physical boundary conditions apply on the edge shards only, and with
    ``BC_PERIODIC`` the circular permute wraps the domain."""
    n_dev = mesh.shape[axis]
    my = mesh.axis_index(axis)
    recv_lo = mesh.ppermute([f[-n:] for f in fields], axis, 1)
    recv_hi = mesh.ppermute([f[:n] for f in fields], axis, -1)
    out = []
    for i, f in enumerate(fields):
        lo, hi = recv_lo[i], recv_hi[i]
        if bc_lo != hydro_mod.BC_PERIODIC and my[i] == 0:
            lo = hydro_mod.ghost_one_side(f, 0, "lo", bc_lo, n, flip_sign)
        if bc_hi != hydro_mod.BC_PERIODIC and my[i] == n_dev - 1:
            hi = hydro_mod.ghost_one_side(f, 0, "hi", bc_hi, n, flip_sign)
        out.append(torch.cat([lo, f, hi], dim=0))
    return out


def _device_hydro_body(mesh, u, dt, *, axis, boundaries, cell_size, gamma,
                       riemann_solver: str = "HLLC"):
    """The MUSCL-Hancock step on x-slabs: the 2-cell primitive halo
    exchange, the local y/z ghosts, then each shard's padded update
    (:func:`~cmacionize_torch.ops.hydro.hydro_step_padded`: K3 on the
    card).  ``u``: per-shard HydroStates."""
    normal = {0: 1, 1: 2, 2: 3}
    ws = [hydro_mod.primitives_from_conserved(ui, gamma) for ui in u]
    bc_x_lo, bc_x_hi = boundaries[0]
    padded = [list(w) for w in ws]
    for f in range(5):
        halo = _halo_pad_axis0(mesh, [w[f] for w in ws], axis, bc_x_lo, bc_x_hi,
                               flip_sign=(f == normal[0]))
        for i in range(mesh.size):
            padded[i][f] = halo[i]
    out = []
    for i in range(mesh.size):
        fields = padded[i]
        for ax in (1, 2):
            bc_lo, bc_hi = boundaries[ax]
            fields = [hydro_mod._pad_axis(f, ax, bc_lo, bc_hi, n=2,
                                          flip_sign=(k == normal[ax]))
                      for k, f in enumerate(fields)]
        out.append(hydro_mod.hydro_step_padded(
            u[i], hydro_mod.Primitives(*fields), dt, cell_size=cell_size, gamma=gamma,
            riemann_solver=riemann_solver,
        ))
    return out


def make_domain_hydro_step(mesh, *, boundaries, cell_size, gamma: float = 5.0 / 3.0,
                           axis: str = "x", riemann_solver: str = "HLLC"):
    """The domain-decomposed MUSCL-Hancock step: ``step(u, dt) → u`` on
    lists of per-shard HydroStates, physics-identical to the single-device
    step."""
    def step(u, dt):
        return _device_hydro_body(mesh, u, dt, axis=axis, boundaries=boundaries,
                                  cell_size=cell_size, gamma=gamma,
                                  riemann_solver=riemann_solver)
    return step


def domain_cfl_timestep(mesh, *, cell_size, gamma=5.0 / 3.0, cfl=0.2, axis: str = "x"):
    """The sharded CFL timestep: each shard's minimum, then a ``pmin``
    (a 0-d tensor on the first shard's device)."""
    def cfl_fn(u):
        local = [hydro_mod.cfl_timestep(ui, cell_size, cfl=cfl, gamma=gamma) for ui in u]
        return mesh.pmin(local, axis)[0]
    return cfl_fn


# ------------------------------------------------------------------ the RHD


def make_domain_rhd_step(
    mesh,
    *,
    global_shape: Tuple[int, int, int],
    boundaries,
    cell_size,
    gamma: float,
    n_photons: int,
    nloop: int,
    sigma_dx: float,
    source_gpos: Tuple[float, float, float],
    jfac_scale: float,
    alpha: float,
    coupling: dict,
    riemann_solver: str = "HLLC",
    axis: str = "x",
    capacity: int = 0,
    max_supersteps: int = 256,
    isothermal_sound_speed=None,
    cooling: bool = False,
    extras: Optional[dict] = None,
    inflow_x=None,
):
    """The domain-decomposed RHD step: ``nloop`` MC iterations with the
    slab exchange, the two-temperature coupling, and the halo-exchange hydro
    step.

    Returns ``step(emit, u, xh, dt) → (u, xh, diagnostics)`` on per-shard
    lists, with ``diagnostics`` summed over the iterations as
    :func:`make_domain_mc_iteration` gives them (``supersteps`` too).  It
    carries what the single-device port's RHDSimulation carries: the
    isothermal EOS, cooling, the ``extras`` (gravity, mask, inflow_yz) and
    ``inflow_x`` raise ``NotImplementedError``.  JAX's ``chunk_len`` (many
    steps in one dispatch) is not ported: the port launches one step at a
    time.
    """
    unsupported = []
    if isothermal_sound_speed is not None:
        unsupported.append("the isothermal equation of state")
    if cooling:
        unsupported.append("cooling")
    unsupported += [f"extras[{k!r}]" for k in (extras or {})]
    if inflow_x is not None:
        unsupported.append("inflow_x")
    if unsupported:
        raise NotImplementedError(
            f"make_domain_rhd_step: {', '.join(unsupported)} {NOT_PORTED_RHD}")
    n_dev = mesh.shape[axis]
    nx, ny, nz = global_shape
    if nx % n_dev:
        raise ValueError(f"grid x = {nx} must divide over {n_dev} shards")
    nx_loc = nx // n_dev
    if nx_loc < 2:
        raise ValueError(
            f"slab width {nx_loc} < hydro halo width 2: grid x = {nx} "
            f"cannot shard over {n_dev} devices")
    local_shape = (nx_loc, ny, nz)
    capacity = default_capacity(n_photons) if capacity <= 0 else min(capacity, n_photons)

    def step(emit, u, xh, dt):
        zero = [torch.zeros((), dtype=torch.int64, device=d) for d in mesh.devices]
        totals = {k: list(zero) for k in ("n_escaped", "buffer_overflow",
                                           "truncated_live", "packets_traced")}
        supersteps = 0
        if nloop > 0:
            number_density = [_div(ui.rho, constants.PROTON_MASS) for ui in u]
            for _ in range(nloop):
                chis = [(nd * x * sigma_dx).reshape(-1) for nd, x in zip(number_density, xh)]
                tallies, stats = _device_slab_mc_loop(
                    mesh, chis, emit, axis=axis, nx_loc=nx_loc, ny=ny, nz=nz,
                    n_photons=n_photons, source_gpos=source_gpos, capacity=capacity,
                    max_supersteps=max_supersteps,
                )
                xh = [ionization.hydrogen_neutral_fraction(
                          t.reshape(local_shape) * jfac_scale, nd, alpha)
                      for t, nd in zip(tallies, number_density)]
                for k, per_shard in totals.items():
                    totals[k] = [a + b for a, b in zip(per_shard, stats[k])]
                supersteps += stats["supersteps"]
            u = [hydro_mod.two_temperature_coupling(ui, x, gamma=gamma, **coupling)
                 for ui, x in zip(u, xh)]
        u = _device_hydro_body(mesh, u, dt, axis=axis, boundaries=boundaries,
                               cell_size=cell_size, gamma=gamma,
                               riemann_solver=riemann_solver)
        return u, xh, _diagnostics(mesh, axis, {**totals, "supersteps": supersteps})

    return step
