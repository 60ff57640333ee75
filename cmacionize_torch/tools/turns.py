"""Two checkouts of the repository, measured in turns on one card: K9c on
the sharded starbench run's merges, K7 on the starbench_voronoi run's
updates, K9p's host cost a call, and the walls of both runs; K3 on the
starbench states and the launches of a starbench step; K6s on each march of
the multi-frequency Voronoi run and that run's transport seconds; K2 on each
launch of a lexington run.

Each mode runs one checkout, given by its root directory: the checkout's
``chip_smoke.py`` and ``cmacionize_torch`` are imported from there, so that
the same driver measures a parent commit unpacked beside this one (``git
archive``) and this one.  Run in turns (parent, this, this, parent), each
reading in a process of its own; a ``capture`` mode runs first and keeps the
inputs in the temporary directory for the ``time`` modes of both::

    python3 cmacionize_torch/tools/turns.py k9c-capture ROOT
    python3 cmacionize_torch/tools/turns.py k9c-time LABEL ROOT
    python3 cmacionize_torch/tools/turns.py k7-capture ROOT
    python3 cmacionize_torch/tools/turns.py k7-time LABEL ROOT
    python3 cmacionize_torch/tools/turns.py k7-wall LABEL ROOT
    python3 cmacionize_torch/tools/turns.py k9p-host LABEL ROOT
    python3 cmacionize_torch/tools/turns.py sharded-wall LABEL ROOT
    python3 cmacionize_torch/tools/turns.py k3-capture ROOT
    python3 cmacionize_torch/tools/turns.py k3-time LABEL ROOT
    python3 cmacionize_torch/tools/turns.py k3-parts LABEL ROOT
    python3 cmacionize_torch/tools/turns.py k6s-capture ROOT
    python3 cmacionize_torch/tools/turns.py k6s-time LABEL ROOT
    python3 cmacionize_torch/tools/turns.py k6s-wall LABEL ROOT
    python3 cmacionize_torch/tools/turns.py k2-time LABEL ROOT
    python3 cmacionize_torch/tools/turns.py k2-wall LABEL ROOT

with ``--out FILE`` to append each JSON line to FILE as well.

- ``k9c-capture`` runs the sharded starbench (``benchmarks/starbench.param``
  on (4, 1, 1) slabs) to 0.3 of its time, as ``chip_smoke.py``'s phase 30,
  then records the shapes of every K9c call of one more step and keeps its
  copy-phase call and a few merges, each merge as its two received buffers.
- ``k9c-time`` runs each kept call through the checkout's merge (the
  parent's 9 cats and K9c, or K9c on the segments): every lane, bit and
  count against ``compact_reference`` of the concatenation; (a) ms a call
  back to back, (b) on the device alone (a CUDA graph), (c) host µs a call,
  the device time by kernel, the stable argsort and gather; the host's steps
  of one call.
- ``k7-capture`` builds the starbench_voronoi grid (40000 generators, 2
  Lloyd iterations), runs phase 18's 1024 steps and keeps K7's first and
  last inputs; ``k7-time`` holds K7 to its plain version on them, first and
  second order, and times it back to back and by kernel; ``k7-wall`` runs
  phase 18 alone (the first run of its process) and profiles 16 more steps.
- ``k9p-host`` times K9p's host µs a call at the sharded starbench's shape
  (2e6 lanes, capacities 531,250), and the steps of its wrapper.
- ``sharded-wall`` runs phase 30 (a two-step warm-up driver, then the run
  to 0.3) and profiles one more step.
- ``k3-capture`` runs phase 7's starbench and keeps the hydro step's first
  and last inputs; ``k3-time`` takes those and phase 6's parity state (the
  main path's reflective walls, HLLC): ``hydro_step`` whole, the torch
  primitives and padding alone, and ``hydro_step_padded`` on the padded
  primitives, each (a), (b), (c) and its device time by kernel; it keeps the
  outputs, and holds them bit for bit against those of a checkout timed
  before it in the same call; then 16 starbench steps, their host time a
  step without and with the profiler, and the launches of a step.
  ``k3-parts`` builds variants of the checkout's K3 (other bricks, and the
  step without its Riemann solves, its slopes at the faces or its
  prediction) and times (U) on phase 6's state on the device, with each
  variant's registers and blocks a SM.
- ``k6s-capture`` builds phase 19's grid (12000 generators, 1 Lloyd
  iteration); ``k6s-time`` runs phase 19 with CUDA events around each of
  its 50 marches: the time, the active packets, the plain march's packet
  steps, real faces tested, visited cells and tally slots, each march's
  bound, and K6s built without its deposit on the same input; with K6s's
  registers and blocks a SM.  ``k6s-wall`` runs phase 19 alone (the first
  run of its process): its transport and solve seconds, then one profiled
  iteration.
- ``k2-time`` runs lexingtonHII20 at 64³ (phase 11) with CUDA events around
  each of its 180 K2 launches, each launch's active packets, packet steps,
  tally slots and bound; ``k2-wall`` runs phase 11 alone (the first run of
  its process): its transport and solve seconds, then one profiled
  iteration.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time

K9C_INPUTS, K7_INPUTS, SBV_GRID = "turns_k9c.pt", "turns_k7.pt", "turns_sbv_grid.pkl"
K3_INPUTS, MF_GRID = "turns_k3.pt", "turns_mf_grid.pkl"
KEPT_K2 = {171: "last source", 172: "last iteration's first generation"}  # of lexington's 180
K7_KERNELS = ("primitives_kernel", "gradients_kernel", "trial_kernel", "update_kernel")
OUT = None  # the --out file, if any


def emit(rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if OUT:
        with open(OUT, "a") as f:
            f.write(line + "\n")


def _saved(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def _load(root: str):
    """The checkout at ``root``: its chip_smoke module (the package comes
    with it)."""
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke

    assert os.path.dirname(os.path.abspath(chip_smoke.__file__)) == os.path.abspath(root)
    return chip_smoke


def _sharded_starbench(cs, seed=42, warm=False):
    prev = os.getcwd()
    os.chdir(cs.BENCHMARKS)
    try:
        params = cs.ParameterFile(cs.STARBENCH_PARAM)
        if warm:
            cs.ShardedRHDSimulation.from_params(params, tiling=cs.SHARDED_STARBENCH_TILING,
                                                seed=7).advance(2)
        return cs.ShardedRHDSimulation.from_params(params, tiling=cs.SHARDED_STARBENCH_TILING,
                                                   seed=seed)
    finally:
        os.chdir(prev)


def _run_to_cut(cs, sim) -> float:
    import torch

    n_outputs = round(10 * cs.SHARDED_STARBENCH_FRACTION)

    class Cut(Exception):
        pass

    def snapshot(s, index):
        if index == n_outputs:
            raise Cut

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        sim.run(snapshot_callback=snapshot)
    except Cut:
        pass
    torch.cuda.synchronize()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------- K9c


def k9c_capture(root):
    cs = _load(root)
    import numpy as np
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.parallel import domain

    for name in ("compact", "trace_packets", "hydro_step"):
        build.load_library(name)
    sim = _sharded_starbench(cs)
    emit({"capture": "ran to the cut", "steps": len(sim.supersteps),
          "wall": _run_to_cut(cs, sim)})
    rows, kept = [], {}
    merge_lanes = 2 * domain.default_capacity(sim.config.n_photons)
    original = domain.compact

    def wrapper(fields, mask, capacity):
        k = len(rows)
        rows.append((mask.numel(), int(mask.sum()), capacity,
                     cs.exchange_bytes(len(fields), [mask], (capacity,))))
        stacked = torch.stack(list(fields))
        if mask.numel() == merge_lanes:
            half = mask.numel() // 2
            if len(kept) < 8 and (k % 5 == 4 or int(mask.sum()) > 0):
                kept[k] = ((stacked[:, :half].clone(), mask[:half].clone()),
                           (stacked[:, half:].clone(), mask[half:].clone()), capacity)
        elif "copy" not in kept:
            kept["copy"] = ((stacked.clone(), mask.clone()), None, capacity)
        return original(fields, mask, capacity)

    domain.compact = wrapper  # the parent's merges call compact on the concatenation
    sim.advance(1, log_every=10**9)
    domain.compact = original
    for n in sorted({r[0] for r in rows}):
        sel = [r for r in rows if r[0] == n]
        members = np.array([r[1] for r in sel])
        emit({"step_calls": len(sel), "lanes": n, "caps": sorted({r[2] for r in sel}),
              "members_min_median_max": [int(members.min()), float(np.median(members)),
                                         int(members.max())],
              "bound_ms_mean": float(np.mean([r[3] for r in sel])) / cs.HBM_BYTES_PER_S * 1e3})
    emit({"step_calls_total": len(rows), "supersteps": sim.supersteps[-1]})
    torch.save(kept, _saved(K9C_INPUTS))


def k9c_time(label, root):
    cs = _load(root)
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.kernels import compact as compact_ops
    from cmacionize_torch.parallel import domain
    from cmacionize_torch.tools import launch_cost

    device = torch.device("cuda")
    build.load_library("compact")
    kept = torch.load(_saved(K9C_INPUTS), weights_only=False)
    segmented = hasattr(domain, "compact_segments")
    for key, (a, b, capacity) in kept.items():
        fa, ma = (t.to(device) for t in a)
        segments = [(fa, ma)]
        if b is not None:
            segments.append(tuple(t.to(device) for t in b))
        fields = [torch.cat(rows) for rows in zip(*(f for f, _ in segments))]
        mask = torch.cat([m for _, m in segments])

        if segmented:
            def merge():
                return domain.compact_segments(segments, capacity)
            k9c = merge
        else:
            rows = [f.unbind(0) for f, _ in segments]  # as K9p's views gave them

            def merge():
                merged = (tuple(torch.cat(r) for r in zip(*rows)) if len(rows) > 1
                          else rows[0])
                return domain.compact(merged, torch.cat([m for _, m in segments]), capacity)

            def k9c():
                return domain.compact(fields, mask, capacity)

        out = merge()
        ref = domain.compact_reference(fields, mask, capacity)
        same = (all(cs.same_bits(x, y) for x, y in zip(out[0], ref[0]))
                and torch.equal(out[1], ref[1]) and int(out[2]) == int(ref[2]))
        rec = {"label": label, "call": str(key), "lanes": int(mask.numel()),
               "members": int(mask.sum()), "capacity": capacity, "identical": same,
               "bound_ms": cs.exchange_bytes(8, [mask], (capacity,)) / cs.HBM_BYTES_PER_S * 1e3,
               "merge_a_ms": launch_cost.per_call_ms(merge),
               "merge_b_ms": launch_cost.graph_ms(merge),
               "merge_c_us": launch_cost.host_us({"w": merge}, 2000)["w"],
               "merge_split_ms": launch_cost.device_split(merge)}
        if k9c is not merge and b is not None:
            rec["k9c_b_ms"] = launch_cost.graph_ms(k9c)
            rec["k9c_c_us"] = launch_cost.host_us({"w": k9c}, 2000)["w"]

            def cats():
                return (tuple(torch.cat(r) for r in zip(*rows)),
                        torch.cat([m for _, m in segments]))

            rec["cats_b_ms"] = launch_cost.graph_ms(cats)
            rec["cats_c_us"] = launch_cost.host_us({"w": cats}, 2000)["w"]
        rec["argsort_gather_ms"] = launch_cost.per_call_ms(
            lambda: cs.argsort_gather(fields, mask, capacity))
        emit(rec)
    emit({"label": label, "host_split_us": launch_cost.host_us(
        _k9c_host_steps(kept, segmented, device, domain, compact_ops), 4000)})


def _k9c_host_steps(kept, segmented, device, domain, compact_ops) -> dict:
    """The host's steps of one K9c call at a kept merge, by the checkout's
    wrapper."""
    import numpy as np
    import torch

    (fa, ma), (fb, mb), capacity = next(v for k, v in kept.items() if k != "copy")
    fa, ma, fb, mb = fa.to(device), ma.to(device), fb.to(device), mb.to(device)
    if segmented:
        segs = [(fa, ma), (fb, mb)]
        values, dev, index, n, _ = compact_ops._check_segments("compact_cuda", segs)
        resident = compact_ops._resident(index, dev, compact_ops.COMPACT)
        scratch = compact_ops._scratch(index, dev, -(-n // 256), resident)
        size = 16 + 33 * capacity
        out = torch.empty(size, dtype=torch.uint8, device=device)
        rows = (ctypes.c_int64 * 30)()
        empty = (ctypes.c_int64 * 30)()
        empty[:10] = [values[0], 0] + values[2:10]
        fn = compact_ops._COMPACT.bind()
        stream = compact_ops.raw_stream(index)

        def fill():
            rows[:len(values)] = values

        return {
            "whole call": lambda: domain.compact_segments(segs, capacity),
            "checks + table values": lambda: compact_ops._check_segments("compact_cuda", segs),
            "resident + scratch lookup": lambda: (
                compact_ops._resident(index, dev, compact_ops.COMPACT),
                compact_ops._scratch(index, dev, -(-n // 256), resident)),
            "allocation": lambda: torch.empty(size, dtype=torch.uint8, device=device),
            "table fill": fill,
            "ctypes + launch (n = 0)": lambda: fn(empty, out.data_ptr(), scratch.data_ptr(), 1,
                                                  8, 0, resident, stream),
            "views": lambda: compact_ops.compact_views(out, 8, capacity),
        }
    fields = tuple(torch.cat([x, y]) for x, y in zip(fa, fb))
    mask = torch.cat([ma, mb])
    n_blocks = -(-mask.numel() // compact_ops.LANES_PER_BLOCK)
    launch = compact_ops._launcher()
    outs = [torch.empty(capacity, device=device) for _ in range(8)]
    in_range = torch.empty(capacity, dtype=torch.bool, device=device)
    scratch = torch.empty(2 * n_blocks + 1, dtype=torch.int32, device=device)
    counts = torch.empty((1, 2), dtype=torch.int64, device=device)
    caps, shifts, has = (np.asarray([capacity], np.int32), np.zeros(1, np.float32),
                         np.zeros(1, np.int32))
    p_in = (ctypes.c_void_p * 8)(*(f.data_ptr() for f in fields))
    p_out = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in outs))
    p_range = (ctypes.c_void_p * 1)(in_range.data_ptr())
    stream = torch.cuda.current_stream(device).cuda_stream

    def arrays():
        return ((ctypes.c_void_p * 8)(*(f.data_ptr() for f in fields)),
                (ctypes.c_void_p * 8)(*(t.data_ptr() for t in outs)),
                (ctypes.c_void_p * 1)(in_range.data_ptr()),
                np.asarray([capacity], np.int32), np.asarray([0.0], np.float32),
                np.asarray([0], np.int32))

    def context():
        with torch.cuda.device(device):
            pass

    return {
        "checks": lambda: compact_ops._check("compact_cuda", fields, mask, torch.bool),
        "mask.view(int8)": lambda: mask.view(torch.int8),
        "10 torch.empty": lambda: ([torch.empty(capacity, device=device) for _ in range(8)],
                                   torch.empty(capacity, dtype=torch.bool, device=device),
                                   torch.empty(2 * n_blocks + 1, dtype=torch.int32,
                                               device=device),
                                   torch.empty((1, 2), dtype=torch.int64, device=device)),
        "ctypes arrays + numpy": arrays,
        "current_stream": lambda: torch.cuda.current_stream(device).cuda_stream,
        "device context": context,
        "launch (n = 0)": lambda: launch(p_in, 8, mask.data_ptr(), 0, 1, p_out, p_range,
                                         caps.ctypes.data, shifts.ctypes.data, has.ctypes.data,
                                         scratch.data_ptr(), counts.data_ptr(), stream),
        "result list": lambda: [(tuple(outs), in_range, counts[b, 1]) for b in range(1)],
    }


def k9p_host(label, root):
    _load(root)
    import numpy as np
    import torch

    from cmacionize_torch.kernels import compact
    from cmacionize_torch.parallel import domain
    from cmacionize_torch.tools import launch_cost

    device = torch.device("cuda")
    rng = np.random.default_rng(3)
    n, cap = 2_000_000, 531_250
    fields = tuple(torch.tensor(rng.standard_normal(n).astype(np.float32), device=device)
                   for _ in range(8))
    for members in (0, 4952):
        codes = np.full(n, -1, np.int8)
        codes[rng.choice(n, members, replace=False)] = 0
        bucket = torch.tensor(codes, device=device)

        def call():
            return domain.partition(fields, bucket, (cap, cap), (16.0, -16.0))

        out = bucket.new_empty(32 + 33 * 2 * cap, dtype=torch.uint8)
        emit({"label": label, "members": members, "a_ms": launch_cost.per_call_ms(call),
              "b_ms": launch_cost.graph_ms(call),
              "c_us": launch_cost.host_us({"w": call}, 4000)["w"],
              "views_us": launch_cost.host_us(
                  {"w": lambda: compact.partition_views(out, 8, (cap, cap))}, 4000)["w"]})


# ----------------------------------------------------------------------- K7


def _sbv_simulation(cs, grid, device):
    from cmacionize_torch.models import voronoi_hydro

    return voronoi_hydro.VoronoiRHDSimulation(
        grid, device=device, gamma=1.0001, timestep=0.141 * cs.MYR / cs.SBV_STEPS,
        luminosity=cs.SBV_LUMINOSITY, source_position=(0.0, 0.0, 0.0),
        cross_section=cs.SBV_SIGMA, recombination_rate=cs.SBV_ALPHA,
        n_photons=cs.SBV_PHOTONS, nloop=cs.SBV_NLOOP, number_density=cs.SBV_DENSITY,
        temperature=100.0, mesh_motion=False, seed=42)


def k7_capture(root):
    cs = _load(root)
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.models import voronoi_hydro

    device = torch.device("cuda")
    for name in ("trace_voronoi", "voronoi_flux"):
        build.load_library(name)
    grid, seconds = cs.timed_voronoi_grid(cs.SBV_BOX, cs.SBV_GENERATORS, cs.SBV_SEED,
                                          cs.SBV_LLOYD)
    with open(_saved(SBV_GRID), "wb") as f:
        pickle.dump(grid, f)
    emit({"grid_s": seconds, "cells": grid.n_cells, "K": grid.max_faces})
    sim = _sbv_simulation(cs, grid, device)
    kept, count = {}, [0]
    original = voronoi_hydro.voronoi_flux_update

    def wrapper(*args, **kwargs):
        if count[0] in (0, cs.SBV_STEPS - 1):
            state, gen_vel, dt, gamma = args[5], args[6], args[7], args[8]
            kept["first" if count[0] == 0 else "last"] = (
                tuple(f.clone() for f in state), gen_vel.clone(), dt, gamma)
        count[0] += 1
        return original(*args, **kwargs)

    voronoi_hydro.voronoi_flux_update = wrapper
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(cs.SBV_STEPS)
    torch.cuda.synchronize()
    voronoi_hydro.voronoi_flux_update = original
    emit({"phase18_wall_with_capture": time.perf_counter() - t0, "calls": count[0]})
    torch.save({"tables": tuple(sim._hydro_tables), "kept": kept}, _saved(K7_INPUTS))


def ptxas_layout(text: str) -> dict:
    """Registers, stack and spill bytes of each kernel in a ``ptxas -v``
    report, by the kernel's name as the report gives it."""
    rows, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = next((k for k in K7_KERNELS if k in m.group(1)), m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current:
            rows.setdefault(current, {}).update(stack=int(m.group(1)),
                                                spill=[int(m.group(2)), int(m.group(3))])
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            rows.setdefault(current, {})["registers"] = int(m.group(1))
    return rows


def blocks_per_sm(registers: int, threads: int) -> int:
    """The register file's limit on a kernel's resident blocks (64 warps and
    32 blocks a SM at most, registers given out 256 a warp)."""
    per_warp = -(-registers * 32 // 256) * 256
    return min(min(65536 // per_warp, 64) // (threads // 32), 32)


def k7_time(label, root):
    _load(root)
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.models import voronoi_hydro
    from cmacionize_torch.tools import launch_cost

    device = torch.device("cuda")
    build.load_library("voronoi_flux")
    layout = ptxas_layout(build.library_path("voronoi_flux").with_suffix(".log").read_text())
    saved = torch.load(_saved(K7_INPUTS), weights_only=False)
    tables = tuple(t.to(device) for t in saved["tables"])
    nbr = tables[0]
    real = nbr != -2
    emit({"label": label, "real_face_share": float(real.double().mean()),
          "real_faces": int(real.sum()), "mean_real_per_cell": float(real.sum(1).double().mean())})
    for which, (state, gen_vel, dt, gamma) in saved["kept"].items():
        state = voronoi_hydro.VoronoiHydroState(*(f.to(device) for f in state))
        gen_vel = gen_vel.to(device)
        rec = {"label": label, "state": which}
        for second_order in (True, False):
            sk, sr = {}, {}
            out = voronoi_hydro.voronoi_flux_update(*tables, state, gen_vel, dt, gamma,
                                                    second_order, stats=sk)
            ref = voronoi_hydro.voronoi_flux_update_reference(*tables, state, gen_vel, dt, gamma,
                                                              second_order, stats=sr)
            torch.cuda.synchronize()
            key = "second" if second_order else "first"
            rec[key] = {"rel_err": [float((a - b).abs().max() / a.abs().max())
                                    for a, b in zip(ref, out)],
                        "bit_for_bit": all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                                           for a, b in zip(ref, out))}
            if second_order:
                flag = sr["flag"]
                touching = flag[:, None] | ((nbr >= 0) & flag[nbr.clamp_min(0).long()])
                rec[key].update(
                    flags_identical=bool(torch.equal(sk["flag"], flag)),
                    flagged_cells=int(flag.sum()),
                    faces_touching_flagged_share_of_real=float((touching & real).sum())
                    / float(real.sum()),
                    grads_identical=bool(torch.equal(sk["gradients"].view(torch.int32),
                                                     sr["gradients"].view(torch.int32))))

            def call():
                return voronoi_hydro.voronoi_flux_update(*tables, state, gen_vel, dt, gamma,
                                                         second_order)

            rec[key].update(a_ms=launch_cost.per_call_ms(call, 50),
                            split_ms=launch_cost.device_split(call, 20),
                            c_us=launch_cost.host_us({"w": call}, 400)["w"])
        emit(rec)
    from cmacionize_torch.kernels import voronoi_flux

    # a thread a face slot in blocks of 256 (this design), or a thread a cell in 128
    row_threads = 256 if hasattr(voronoi_flux, "MAX_SLOTS") else 128
    for name, row in layout.items():
        if "registers" in row:
            threads = 128 if name == "primitives_kernel" else row_threads
            row["blocks_per_sm_from_registers"] = blocks_per_sm(row["registers"], threads)
    emit({"label": label, "layout": layout})
    if hasattr(voronoi_flux, "occupancy"):
        emit({"label": label, "occupancy": voronoi_flux.occupancy(device)})


def k7_wall(label, root):
    cs = _load(root)
    import torch

    from cmacionize_torch import kernels
    from cmacionize_torch.kernels import build

    device = torch.device("cuda")
    for name in ("trace_voronoi", "voronoi_flux"):
        build.load_library(name)
    with open(_saved(SBV_GRID), "rb") as f:
        grid = pickle.load(f)
    sim = _sbv_simulation(cs, grid, device)
    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(cs.SBV_STEPS)
    torch.cuda.synchronize()
    rec = {"label": label, "phase18_wall": time.perf_counter() - t0,
           "front_pc": sim.ionization_front_radius() / cs.PC, "launches": dict(kernels.LAUNCHES)}
    shares = cs.profile_window("16 starbench_voronoi steps", lambda: sim.run(16),
                               {"K6": ("trace_voronoi_kernel",), "K7": K7_KERNELS})
    rec["profile"] = {k: list(v) for k, v in (shares or {}).items()}
    emit(rec)


def sharded_wall(label, root):
    cs = _load(root)
    import torch

    from cmacionize_torch import kernels
    from cmacionize_torch.kernels import build

    for name in ("compact", "trace_packets", "hydro_step"):
        build.load_library(name)
    sim = _sharded_starbench(cs, warm=True)
    kernels.LAUNCHES.clear()
    wall = _run_to_cut(cs, sim)
    rec = {"label": label, "wall": wall, "steps": len(sim.supersteps),
           "supersteps": int(sum(sim.supersteps)), "launches": dict(kernels.LAUNCHES),
           "front_pc": sim.ionization_front_radius() / cs.PC}
    shares = cs.profile_window(
        "one sharded starbench step", lambda: sim.advance(1, log_every=10**9),
        {"K9p": ("partition_kernel", "compact_count_kernel<2", "compact_scan_kernel<2",
                 "compact_scatter_kernel<2", "exchange_kernel<2"),
         "K9c": ("compact_count_kernel<1", "compact_scan_kernel<1", "compact_scatter_kernel<1",
                 "exchange_kernel<1"),
         "K1": ("trace_packets_kernel",), "cat": ("CatArrayBatchedCopy",)})
    rec["profile"] = {k: list(v) for k, v in (shares or {}).items()}
    rec["profiled_step_supersteps"] = sim.supersteps[-1]
    emit(rec)

# ------------------------------------------------------------- K3, K6s, K2


def variant_library(name: str, substitutions: dict):
    """``csrc/<name>.cu`` built with each key of ``substitutions`` replaced by
    its value (each must occur), with the package's nvcc flags, into the
    temporary directory; returns the loaded library."""
    import shutil

    from cmacionize_torch.kernels import build

    tmp = tempfile.mkdtemp(prefix=f"variant_{name}_")
    csrc = os.path.join(tmp, "csrc")
    shutil.copytree(build.CSRC_DIR, csrc)
    source = os.path.join(csrc, f"{name}.cu")
    text = open(source).read()
    for old, new in substitutions.items():
        assert old in text, f"{name}.cu: {old!r} not found"
        text = text.replace(old, new)
    with open(source, "w") as f:
        f.write(text)
    target = os.path.join(tmp, f"lib{name}.so")
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", target, source],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    return ctypes.CDLL(target)


class swapped_library:
    """While active, the kernels of library ``name`` launch from ``library``:
    the package's cache of loaded libraries gives it, and the module's
    ``Launcher`` objects bind anew."""

    def __init__(self, module, name: str, library):
        from cmacionize_torch.kernels import build, launch

        self.build, self.name, self.library = build, name, library
        self.launchers = [v for v in vars(module).values() if isinstance(v, launch.Launcher)]

    def _reset(self):
        for launcher in self.launchers:
            launcher.function = None

    def __enter__(self):
        self.saved = self.build._LIBRARIES.get(self.name)
        self.build._LIBRARIES[self.name] = self.library
        self._reset()

    def __exit__(self, *exc):
        self.build._LIBRARIES[self.name] = self.saved
        self._reset()


def _bits_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a.reshape(-1).view(torch.int32),
                                              b.reshape(-1).view(torch.int32))


def _kernel_registers(name: str) -> dict:
    """Registers of each kernel in the ``ptxas -v`` report of library
    ``name``, with the register file's limit on its blocks of 256 a SM."""
    from cmacionize_torch.kernels import build

    rows = {}
    current = None
    for line in build.library_path(name).with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            rows[current] = {"registers": int(m.group(1)),
                             "blocks_of_256_per_sm": blocks_per_sm(int(m.group(1)), 256)}
        m = re.search(r"(\d+) bytes smem", line)
        if m and current and current in rows:
            rows[current]["smem"] = int(m.group(1))
    return rows


def k3_capture(root):
    cs = _load(root)
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.ops import hydro

    device = torch.device("cuda")
    for name in ("trace_packets", "hydro_step"):
        build.load_library(name)
    sim = cs.starbench_simulation(device)
    kept, count = {}, [0]
    original = hydro.hydro_step

    def wrapper(u, dt, **kwargs):
        snap = (tuple(f.clone() for f in u), float(dt), kwargs)
        kept.setdefault("first", snap)
        kept["last"] = snap
        count[0] += 1
        return original(u, dt, **kwargs)

    hydro.hydro_step = wrapper
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    hydro.hydro_step = original
    emit({"phase7_wall_with_capture": time.perf_counter() - t0, "steps": count[0]})
    torch.save({k: (tuple(f.cpu() for f in u), dt, kw) for k, (u, dt, kw) in kept.items()},
               _saved(K3_INPUTS))


def _step_launches(sim, steps: int = 16) -> dict:
    """Starbench steps after two warm-up steps: the host ms a step without and
    with the profiler, and the device's events (kernels, copies, sets) a step
    under it: their count and the most frequent names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sim.advance(2, log_every=10**9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.advance(steps, log_every=10**9)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.advance(steps, log_every=10**9)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) / steps * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    top = sorted(events, key=lambda e: -e.count)[:12]
    return {"launches": sum(e.count for e in events) / steps,
            "device_ms": sum(e.self_device_time_total for e in events) * 1e-3 / steps,
            "host_ms": plain_ms, "profiled_host_ms": profiled_ms,
            "top": {e.key[:60]: e.count for e in top}}


def k3_time(label, root):
    cs = _load(root)
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.ops import hydro
    from cmacionize_torch.tools import launch_cost

    device = torch.device("cuda")
    for name in ("trace_packets", "hydro_step"):
        build.load_library(name)
    saved = torch.load(_saved(K3_INPUTS), weights_only=False)
    star = cs.starbench_simulation(device)
    gamma = star.config.gamma
    kw6 = dict(boundaries=((hydro.BC_REFLECTIVE,) * 2,) * 3,
               cell_size=(float(star.geometry.cell_size[0]),) * 3, gamma=gamma,
               riemann_solver="HLLC")
    u6 = hydro.conserved_from_primitives(cs.hydro_parity_state(star.geometry, device), gamma)
    states = {"phase6": (tuple(u6), star.timeline().current_timestep, kw6)}
    states.update({k: (tuple(f.to(device) for f in u), dt, kw) for k, (u, dt, kw) in saved.items()})
    outs = {}
    for which, (u, dt, kw) in states.items():
        u = hydro.HydroState(*u)
        padded_kw = {k: kw[k] for k in ("cell_size", "gamma", "riemann_solver")}

        def prims_pad():
            return hydro.pad_primitives(hydro.primitives_from_conserved(u, kw["gamma"]),
                                        kw["boundaries"])

        wp = prims_pad()

        def step():
            return hydro.hydro_step(u, dt, **kw)

        def padded():
            return hydro.hydro_step_padded(u, wp, dt, **padded_kw)

        out_step, out_padded = step(), padded()
        torch.cuda.synchronize()
        n = u.rho.numel()
        rec = {"label": label, "state": which, "shape": list(u.rho.shape), "dt": dt,
               "step_vs_padded_identical": all(_bits_equal(a, b)
                                               for a, b in zip(out_step, out_padded)),
               "bound_u_ms": 40 * n / cs.HBM_BYTES_PER_S * 1e3}
        for part, fn in (("step", step), ("prims_pad", prims_pad), ("padded", padded)):
            rec[part] = {"a_ms": launch_cost.per_call_ms(fn), "b_ms": launch_cost.graph_ms(fn),
                         "c_us": launch_cost.host_us({"w": fn}, 2000)["w"],
                         "split_ms": launch_cost.device_split(fn)}
        outs[which] = {"step": [f.cpu() for f in out_step],
                       "padded": [f.cpu() for f in out_padded]}
        emit(rec)
    emit({"label": label, "layout": _kernel_registers("hydro_step")})
    torch.save(outs, _saved(f"turns_k3_out_{label}.pt"))
    for other in os.listdir(tempfile.gettempdir()):
        m = re.fullmatch(r"turns_k3_out_(.+)\.pt", other)
        if not m or m.group(1) == label:
            continue
        theirs = torch.load(_saved(other), weights_only=False)
        emit({"label": label, "against": m.group(1), "identical": {
            f"{which} {part}": [_bits_equal(a, b) for a, b in zip(outs[which][part],
                                                                   theirs[which][part])]
            for which in outs if which in theirs for part in ("step", "padded")}})
    emit({"label": label, "starbench_step": _step_launches(star)})


# the variants of K3's source that k3-parts times: the brick, and the step
# without a piece (its outputs are then wrong; only the time is read)
K3_PARTS = {
    "brick 4x8x16 (as built)": {},
    "brick 4x8x8": {"constexpr int kBX = 4, kBY = 8, kBZ = 16;":
                     "constexpr int kBX = 4, kBY = 8, kBZ = 8;"},
    "brick 8x8x8": {"constexpr int kBX = 4, kBY = 8, kBZ = 16;":
                     "constexpr int kBX = 8, kBY = 8, kBZ = 8;"},
    "brick 2x8x16": {"constexpr int kBX = 4, kBY = 8, kBZ = 16;":
                     "constexpr int kBX = 2, kBY = 8, kBZ = 16;"},
    "brick 4x8x32": {"constexpr int kBX = 4, kBY = 8, kBZ = 16;":
                     "constexpr int kBX = 4, kBY = 8, kBZ = 32;"},
    "brick 8x8x16": {"constexpr int kBX = 4, kBY = 8, kBZ = 16;":
                     "constexpr int kBX = 8, kBY = 8, kBZ = 16;"},
    "brick 4x16x16": {"constexpr int kBX = 4, kBY = 8, kBZ = 16;":
                     "constexpr int kBX = 4, kBY = 16, kBZ = 16;"},
    "no Riemann solves": {"""    hllc_flux(left[0], left[n], left[t1], left[t2], left[4], right[0],
              right[n], right[t1], right[t2], right[4], c, ff);""":
                          "    for (int q = 0; q < 5; ++q) ff[q] = left[q] - right[q];"},
    "no slopes at the faces": {
        "left[f] = t.pred[f][L] + 0.5f * slope_at(t, f, wL, kAxis);": "left[f] = t.pred[f][L];",
        "right[f] = t.pred[f][R] - 0.5f * slope_at(t, f, wR, kAxis);": "right[f] = t.pred[f][R];"},
    "no prediction": {"  predict(t, x0, y0, z0, nx, ny, nz, c);\n": ""},
}


def k3_parts(label, root):
    cs = _load(root)
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.kernels import hydro_step as k3_module
    from cmacionize_torch.ops import hydro
    from cmacionize_torch.tools import launch_cost

    device = torch.device("cuda")
    build.load_library("hydro_step")
    star = cs.starbench_simulation(device)
    gamma = star.config.gamma
    walls = ((hydro.BC_REFLECTIVE,) * 2,) * 3
    kw = dict(boundaries=walls, cell_size=(float(star.geometry.cell_size[0]),) * 3,
              gamma=gamma, riemann_solver="HLLC")
    u = hydro.conserved_from_primitives(cs.hydro_parity_state(star.geometry, device), gamma)
    dt = star.timeline().current_timestep
    for name, substitutions in K3_PARTS.items():
        library = variant_library("hydro_step", substitutions)
        with swapped_library(k3_module, "hydro_step", library):
            def step():
                return hydro.hydro_step(u, dt, **kw)

            step()
            torch.cuda.synchronize()
            split = launch_cost.device_split(step, 20)
            b_ms = launch_cost.graph_ms(step, 20, 3)
            occupancy = {}
            for form in ("u", "p"):
                fn = getattr(library, f"cmi_hydro_step_{form}_occupancy")
                fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
                values = [ctypes.c_int(0) for _ in range(3)]
                fn(*(ctypes.byref(v) for v in values))
                occupancy[form] = [v.value for v in values]
        emit({"label": label, "variant": name, "b_ms": b_ms, "split_ms": split,
              "registers_blocks_sms": occupancy})


def k6s_capture(root):
    cs = _load(root)
    grid, seconds = cs.timed_voronoi_grid(cs.MF_BOX, cs.MF_GENERATORS, cs.MF_SEED, cs.MF_LLOYD)
    with open(_saved(MF_GRID), "wb") as f:
        pickle.dump(grid, f)
    emit({"grid_s": seconds, "cells": grid.n_cells, "K": grid.max_faces})


NO_DEPOSIT = ("atomicAdd(bin_tally + row, ell * w);",  # the parent's K6s
              "cmi_warp::run_deposit(tally, slot, dep, lane);")  # on run deposits


def _mf_simulation(cs, grid, device):
    from cmacionize_torch.models import voronoi

    return voronoi.MultiFreqVoronoiSimulation(
        grid, lambda p: cs.np.full(len(cs.np.atleast_2d(p)), cs.MF_DENSITY), device=device,
        source_position=(0.0, 0.0, 0.0), luminosity=cs.MF_LUMINOSITY, n_photons=cs.MF_PHOTONS,
        abundances=cs.ABUND, do_temperature=True, diffuse_field=True, n_bins=cs.MF_BINS,
        n_reemission_rounds=cs.MF_ROUNDS, seed=11)


def k6s_bound(cs, tables, tally, n_bins: int, n: int, n_active: int, steps: int,
              faces: int) -> dict:
    """The least time of one K6s march (chip_smoke.py's roofline): of each
    visited cell (one the plain march deposited in) its real faces' packed
    rows and their neighbours and shifts (32 B a face), its face count, chi_H
    and chi_He; each tally slot deposited in, read and written; per active
    packet its state in (50 B) and out (22 B), per inactive packet its
    flag; the operations of the real faces tested and the packet steps."""
    C = tables.neighbors.shape[0]
    visited = (tally.reshape(n_bins, C) != 0).any(0)
    real = (tables.neighbors != -2).sum(1)
    n_visited, visited_faces = int(visited.sum()), int(real[visited].sum())
    slots = int((tally != 0).sum())
    n_bytes = 32 * visited_faces + 12 * n_visited + 8 * slots + 72 * n_active + (n - n_active)
    n_ops = cs.OPS_PER_VORONOI_FACE * faces + cs.OPS_PER_K6S_STEP * steps
    t_bytes = n_bytes / cs.HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / cs.F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "visited_cells": n_visited, "visited_faces": visited_faces,
            "slots": slots}


def k6s_time(label, root):
    cs = _load(root)
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.kernels import trace_voronoi_spectral as k6s_module
    from cmacionize_torch.models import voronoi

    device = torch.device("cuda")
    for name in ("trace_voronoi_spectral", "temperature"):
        build.load_library(name)
    source = (build.CSRC_DIR / "trace_voronoi_spectral.cu").read_text()
    no_deposit = variant_library("trace_voronoi_spectral",
                                 {next(p for p in NO_DEPOSIT if p in source): ""})
    with open(_saved(MF_GRID), "rb") as f:
        grid = pickle.load(f)
    C = grid.n_cells
    march = dict(eps=voronoi.march_eps(C), max_steps=voronoi.default_max_steps(C))
    original = voronoi.trace_packets_voronoi_spectral
    rows = []

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    def wrapper(grid_, chi_h, chi_he, packets, **kw):
        n_active = int(packets.active.sum())
        ms, out = timed(lambda: original(grid_, chi_h, chi_he, packets, **kw))
        with swapped_library(k6s_module, "trace_voronoi_spectral", no_deposit):
            no_dep_ms, _ = timed(lambda: original(grid_, chi_h, chi_he, packets, **kw))
        stats = {}
        n_bins = kw["n_bins"]
        tally_r, out_r = voronoi.trace_packets_voronoi_spectral_reference(
            kw["tables"], chi_h * grid.scale, chi_he * grid.scale, packets,
            torch.zeros(n_bins * C, device=device), stats=stats, **march)
        steps, faces = int(stats["packet_steps"]), int(stats["face_tests"])
        same = all(_bits_equal(getattr(out[1], f).float(), getattr(out_r, f).float())
                   for f in ("pos", "tau_left", "active", "absorbed")) and torch.equal(
                       out[1].cell, out_r.cell)
        rows.append({"march": len(rows), "ms": ms, "no_deposit_ms": no_dep_ms,
                     "active": n_active, "packet_steps": steps, "face_tests": faces,
                     "state_identical": same,
                     **k6s_bound(cs, kw["tables"], tally_r, n_bins, packets.cell.numel(),
                                 n_active, steps, faces)})
        return out

    voronoi.trace_packets_voronoi_spectral = wrapper
    try:
        sim = _mf_simulation(cs, grid, device)
        sim.run(cs.MF_ITERATIONS)
    finally:
        voronoi.trace_packets_voronoi_spectral = original
    for row in rows:
        emit({"label": label, **row})
    loss = sum(r["ms"] - r["bound_ms"] for r in rows)
    emit({"label": label, "marches": len(rows), "sum_ms": sum(r["ms"] for r in rows),
          "loss_ms": loss, "layout": _kernel_registers("trace_voronoi_spectral")})


def k6s_wall(label, root):
    cs = _load(root)
    import torch

    from cmacionize_torch import kernels
    from cmacionize_torch.kernels import build

    device = torch.device("cuda")
    for name in ("trace_voronoi_spectral", "temperature"):
        build.load_library(name)
    with open(_saved(MF_GRID), "rb") as f:
        grid = pickle.load(f)
    sim = _mf_simulation(cs, grid, device)
    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(cs.MF_ITERATIONS)
    torch.cuda.synchronize()
    rec = {"label": label, "phase19_wall": time.perf_counter() - t0,
           "transport_s": sum(t for t, _ in sim.phase_seconds),
           "solve_s": sum(s for _, s in sim.phase_seconds),
           "transport_per_iteration": [t for t, _ in sim.phase_seconds],
           "launches": dict(kernels.LAUNCHES)}
    shares = cs.profile_window("one multi-frequency Voronoi iteration", lambda: sim.run(1),
                               {"K6s": ("trace_voronoi_spectral_kernel",),
                                "K4": ("temperature",)})
    rec["profile"] = {k: list(v) for k, v in (shares or {}).items()}
    emit(rec)


def k2_time(label, root):
    cs = _load(root)
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.ops import traversal

    device = torch.device("cuda")
    for name in ("trace_packets_spectral", "temperature"):
        build.load_library(name)
    sim = cs.lexington_simulation(device)
    ncell = sim.geometry.n_cells
    original = traversal.trace_packets_spectral
    rows, kept = [], {}

    def wrapper(chi_h, chi_he, packets, tally2d, **kw):
        n_active = int(packets.active.sum())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = original(chi_h, chi_he, packets, tally2d, **kw)
        end.record()
        torch.cuda.synchronize()
        stats = {}
        tally_r, _ = traversal.trace_packets_spectral_reference(
            chi_h, chi_he, packets, torch.zeros_like(tally2d), stats=stats, **kw)
        steps, slots = int(stats["packet_steps"]), int((tally_r != 0).sum())
        n = packets.px.numel()
        # chi_H, chi_He of the cells deposited in; each slot deposited in read
        # and written; per active packet 88 B in and out, per inactive its flag
        cells = int((tally_r.reshape(-1, ncell) != 0).any(0).sum())
        n_bytes = 8 * cells + 8 * slots + 88 * n_active + (n - n_active)
        t_bytes = n_bytes / cs.HBM_BYTES_PER_S * 1e3
        t_ops = cs.OPS_PER_K2_STEP * steps / cs.F32_OPS_PER_S * 1e3
        # the table's bound: the whole binned tally read and written
        whole = (8 * ncell + 8 * tally2d.numel() + 88 * n) / cs.HBM_BYTES_PER_S * 1e3
        if len(rows) in KEPT_K2:
            kept[KEPT_K2[len(rows)]] = (chi_h.clone(), chi_he.clone(),
                                        type(packets)(*(f.clone() for f in packets)), kw)
        rows.append({"launch": len(rows), "ms": start.elapsed_time(end), "active": n_active,
                     "packet_steps": steps, "slots": slots, "bound_ms": max(t_bytes, t_ops),
                     "bound_whole_tally_ms": max(whole, t_ops)})
        return out

    traversal.trace_packets_spectral = wrapper
    try:
        sim.run()
    finally:
        traversal.trace_packets_spectral = original
    for row in rows:
        emit({"label": label, **row})
    from cmacionize_torch.tools import launch_cost

    for which, (chi_h, chi_he, packets, kw) in kept.items():
        tally = torch.zeros(kw["n_bins"] * ncell, device=device)

        def call():
            return traversal.trace_packets_spectral(chi_h, chi_he, packets, tally, **kw)

        try:
            b_ms = launch_cost.graph_ms(call, 10, 3)
        except RuntimeError as e:  # a call that cannot be captured
            b_ms = str(e)[:80]
        emit({"label": label, "march": which, "active": int(packets.active.sum()),
              "a_ms": launch_cost.per_call_ms(call, 20), "b_ms": b_ms,
              "c_us": launch_cost.host_us({"w": call}, 200)["w"],
              "split_ms": launch_cost.device_split(call, 10)})
    emit({"label": label, "launches": len(rows), "sum_ms": sum(r["ms"] for r in rows),
          "loss_ms": sum(r["ms"] - r["bound_ms"] for r in rows),
          "loss_whole_tally_ms": sum(r["ms"] - r["bound_whole_tally_ms"] for r in rows),
          "layout": _kernel_registers("trace_packets_spectral")})


def k2_wall(label, root):
    cs = _load(root)
    import torch

    from cmacionize_torch import kernels
    from cmacionize_torch.kernels import build

    device = torch.device("cuda")
    for name in ("trace_packets_spectral", "temperature"):
        build.load_library(name)
    sim = cs.lexington_simulation(device)
    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    rec = {"label": label, "phase11_wall": time.perf_counter() - t0,
           "transport_s": sum(t for t, _ in sim.phase_seconds),
           "solve_s": sum(v for _, v in sim.phase_seconds),
           "transport_per_iteration": [t for t, _ in sim.phase_seconds],
           "launches": dict(kernels.LAUNCHES)}
    shares = cs.profile_window("one more lexington iteration",
                               lambda: sim.run(sim.iteration + 1),
                               {"K2": ("trace_packets_spectral_kernel",),
                                "K4": ("temperature_kernel",)})
    rec["profile"] = {k: list(v) for k, v in (shares or {}).items()}
    emit(rec)


MODES = {"k9c-capture": k9c_capture, "k9c-time": k9c_time, "k9p-host": k9p_host,
         "k7-capture": k7_capture, "k7-time": k7_time, "k7-wall": k7_wall,
         "sharded-wall": sharded_wall, "k3-capture": k3_capture, "k3-time": k3_time,
         "k6s-capture": k6s_capture, "k6s-time": k6s_time, "k6s-wall": k6s_wall,
         "k2-time": k2_time, "k2-wall": k2_wall, "k3-parts": k3_parts}


def main(argv=None) -> None:
    global OUT
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=sorted(MODES))
    parser.add_argument("args", nargs="+", help="LABEL ROOT, or ROOT for the capture modes")
    parser.add_argument("--out", help="append each JSON line to this file too")
    ns = parser.parse_args(argv)
    OUT = ns.out
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=False).stdout.strip()
    except FileNotFoundError:
        card = "no nvidia-smi"
    emit({"card": card, "mode": ns.mode, "args": ns.args})
    MODES[ns.mode](*ns.args)


if __name__ == "__main__":
    main()
