"""Two checkouts of the repository, measured in turns on one card: K9c on
the sharded starbench run's merges, K7 on the starbench_voronoi run's
updates, K9p's host cost a call, and the walls of both runs; K3 on the
starbench states and the launches of a starbench step; K6s on each march of
the multi-frequency Voronoi run and that run's transport seconds; K2 on each
launch of a lexington run; K10 on phase 32's final χ and the hunt for the
lanes that phase 33's check refuses; K13e at the probe's shape; K13h at
the tools' shapes; every K8 and K8p launch of the dusty_galaxy runs, and
the intensity run's wall of two checkouts in alternating pairs.

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
    python3 cmacionize_torch/tools/turns.py k10-hunt LABEL ROOT [REPEATS SECONDS FOCUS NEW]
    python3 cmacionize_torch/tools/turns.py k10-capture ROOT
    python3 cmacionize_torch/tools/turns.py k10-time LABEL ROOT
    python3 cmacionize_torch/tools/turns.py k10-study LABEL ROOT
    python3 cmacionize_torch/tools/turns.py k13e-time LABEL ROOT
    python3 cmacionize_torch/tools/turns.py k13h-time LABEL ROOT
    python3 cmacionize_torch/tools/turns.py k13h-parts LABEL ROOT
    python3 cmacionize_torch/tools/turns.py k8-time LABEL ROOT
    python3 cmacionize_torch/tools/turns.py k8-parts LABEL ROOT
    python3 cmacionize_torch/tools/turns.py k8-wall LABEL ROOT OTHER_LABEL OTHER_ROOT [PAIRS]

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
- ``k10-hunt`` reruns phase 32 (or, with NEW 1, draws phase 33's 2^20 lanes
  anew each repeat) and keeps the lanes that phase 33's first check
  refuses, with χ and their chunks, under ``out/``; ``k10-capture`` keeps
  phase 32's final χ and phase 33's lanes for ``k10-time`` (K10 on both χ
  fields, K1 on the same lanes, the SASS's opcode counts, the outputs held
  bit for bit against an earlier checkout's) and ``k10-study`` (K10 built
  with clock64 counters: phases a chunk, lanes that walk, warp cycles a
  candidate cell, the walk's share of a warp's cycles).
- ``k13e-time`` times K13e at the probe's 1024 lanes × 7808 steps, with a
  clocked build's warp cycles a step and the SASS's opcode counts.
- ``k13h-time`` times K13h at the tools' 1024 packets × 7808 steps and at
  2^16 seeded packets ((a), (b), (c), the device split, ``torch.bincount``)
  and holds its outputs to the plain version, to a second call and to an
  earlier checkout's; ``k13h-parts`` times this checkout's K13h built with
  a piece changed (64 or 256 blocks, no ``__syncwarp``).
- ``k8-time`` times every K8 and K8p launch of one intensity and one
  polarized dusty_galaxy run (in the run, back to back, on the device) with
  its active events, the plain march's mean and largest steps, its bound,
  and its τ and pixels against the plain version and an earlier checkout's;
  ``k8-parts`` times this checkout's K8 and K8p with variants of the march
  (8 steps a batch, IEEE walls); ``k8-wall`` times the intensity run's wall
  of two checkouts in alternating pairs, each in a process of its own
  (``k8-wall-worker``).
"""

from __future__ import annotations

import argparse
import contextlib
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


def variant_library(name: str, substitutions: dict, append: str = ""):
    """``csrc/<name>.cu`` built with each key of ``substitutions`` replaced by
    its value (each must occur) and ``append`` added at its end, with the
    package's nvcc flags, into the temporary directory; returns the loaded
    library, with its ``ptxas -v`` report and path as ``ptxas_log`` and
    ``path``."""
    return variant_library_files(name, {f"{name}.cu": substitutions}, append)


def variant_library_files(name: str, edits: dict, append: str = ""):
    """``variant_library`` with the substitutions of each file of ``csrc/``
    in ``edits`` (file name: substitutions), ``append`` added to
    ``<name>.cu``."""
    import shutil

    from cmacionize_torch.kernels import build

    tmp = tempfile.mkdtemp(prefix=f"variant_{name}_")
    csrc = os.path.join(tmp, "csrc")
    shutil.copytree(build.CSRC_DIR, csrc)
    for file, substitutions in {f"{name}.cu": {}, **edits}.items():
        path = os.path.join(csrc, file)
        text = open(path).read()
        for old, new in substitutions.items():
            assert old in text, f"{file}: {old!r} not found"
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text + (append if file == f"{name}.cu" else ""))
    source = os.path.join(csrc, f"{name}.cu")
    target = os.path.join(tmp, f"lib{name}.so")
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", target, source],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    library = ctypes.CDLL(target)
    library.ptxas_log, library.path = proc.stdout + proc.stderr, target
    return library


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


# ------------------------------------------------------------- K10, K13e

K10_INPUTS = "turns_k10.pt"
OUT_DIR = "out"  # what the K10 and K13e modes keep (hunted lanes, SASS)
# phase 33's first checks of K10's lanes: positions within CONE_TOLERANCE
# where the states agree, and an unplaced lane placed ahead on its ray
# within the slab's diagonal
CONE_TOLERANCE = 1e-4
MAX_EVIDENCE_FILES = 5  # of each kind: runs with refused lanes, runs with unplaced ones


def _variant(name: str, substitutions: dict, kernel: str, append: str = ""):
    """``variant_library`` with the variant's ``kernel`` registers and stack
    from its ``ptxas -v`` report: (library, {"registers", "stack"})."""
    library = variant_library(name, substitutions, append)
    return library, _ptxas_kernel(library.ptxas_log, kernel)


def _ptxas_kernel(log: str, kernel: str) -> dict:
    """The ``ptxas_layout`` row of the kernel whose name holds ``kernel``."""
    return next(row for name, row in ptxas_layout(log).items() if kernel in name)


def _cone_phase32(cs, sim, device, seed=42):
    """Phase 32's final neutral fraction: two warm-up iterations, then the 20
    iterations from the initial state, the generator seeded as
    ``chip_smoke.cone_stromgren`` seeds it."""
    import torch

    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    initial = sim.neutral_fraction.clone()
    for n in (2, sim.config.n_iterations):
        x = initial
        for _ in range(n):
            x, _, _ = cs.cone_iteration(sim, generator, x)
    return x


def _cone_lanes(cs, sim, device, seed):
    """Phase 33's 2^20 stratified parity lanes from ``seed``, packed."""
    import torch

    from cmacionize_torch.tools import experimental_cone_kernel as cone
    from cmacionize_torch.tools import experimental_emission_octa as octa

    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    packets = octa.emit_point_source_stratified(generator, cs.CONE_PHOTONS, sim._source_gpos,
                                                device)
    return cone.pack_packets(*packets, sim.geometry.shape)


def _cone_setup(cs, device):
    """The cone Strömgren simulation and phase 33's parity packets."""
    config = cs.HOnlyConfig.from_params(cs.ParameterFile(cs.STROMGREN_PARAM))
    sim = cs.HOnlyIonizationSimulation(config, device=device)
    return (sim, *_cone_lanes(cs, sim, device, cs.PARITY_SEED))


def _chi(cs, sim, x):
    return (sim.number_density * x * (sim.config.cross_section * sim.dx)).contiguous()


def _cone_offenders(out_k, out_r, unplaced) -> dict:
    """The lanes that phase 33's first checks refuse, with their
    measures: state flips, positions off by more than 1e-4 cells where the
    states agree, and unplaced lanes that K10 did not absorb within one slab
    diagonal ahead on their ray."""
    import torch

    (_, pf_k, pi_k), (_, pf_r, pi_r) = out_k, out_r
    sk, sr = pi_k[:, 3], pi_r[:, 3]
    step = pf_k[:, :3] - pf_r[:, :3]
    along = (step * pf_r[:, 3:6]).sum(dim=1)
    off_ray = (step - along[:, None] * pf_r[:, 3:6]).abs().amax(dim=1)
    same = (sk == sr) & ~unplaced
    placed_off = same & (step.abs().amax(dim=1) > CONE_TOLERANCE)
    ahead = unplaced & (sk == 1)
    diagonal = 8 * 3**0.5
    unplaced_off = ahead & ((along < -CONE_TOLERANCE) | (along > diagonal + CONE_TOLERANCE)
                            | (off_ray > CONE_TOLERANCE))
    lanes = torch.nonzero(placed_off | unplaced_off | (sk != sr)).reshape(-1)
    return {"lanes": lanes.tolist(), "along": along[lanes].tolist(),
            "off_ray": off_ray[lanes].tolist(), "states_k": sk[lanes].tolist(),
            "states_r": sr[lanes].tolist(), "unplaced": unplaced[lanes].tolist(),
            "unplaced_along": along[ahead].tolist()[:32], "n_unplaced": int(unplaced.sum()),
            "n_state_flips": int((sk != sr).sum())}


def _save_cone_evidence(path, chi, pf, pi, lanes, out_k, out_r, **meta) -> None:
    """χ, and the chunks of ``lanes`` (their 512 input lanes and both
    outputs), as .npz at ``path``."""
    import numpy as np
    import torch

    chunks = sorted({lane // 512 for lane in lanes})
    rows = torch.cat([torch.arange(c * 512, (c + 1) * 512) for c in chunks]).to(pf.device)
    np.savez(path, chi=chi.cpu().numpy(), lanes=np.asarray(lanes), chunks=np.asarray(chunks),
             pf=pf[rows].cpu().numpy(), pi=pi[rows].cpu().numpy(),
             pf_k=out_k[1][rows].cpu().numpy(), pi_k=out_k[2][rows].cpu().numpy(),
             pf_r=out_r[1][rows].cpu().numpy(), pi_r=out_r[2][rows].cpu().numpy(),
             **{k: np.asarray(v) for k, v in meta.items()})


def k10_hunt(label, root, repeats="60", budget_s="360", focus_after="0", new_lanes="0"):
    """Phase 32 again and again (its final χ changes with the order of the
    tally's atomics), each final χ through K10 and the plain version on phase
    33's 2^20 parity lanes; the lanes that phase 33's first checks
    refuse, and the unplaced ones, are kept with χ and their chunks under
    ``out/``.  After ``focus_after`` repeats (0: never) the plain
    version marches only the chunks in which those runs met an unplaced or
    refused lane.  With ``new_lanes`` 1, phase 32 runs once and each repeat
    draws phase 33's 2^20 lanes anew (seed PARITY_SEED + repeat)."""
    cs = _load(root)
    import importlib.util

    import numpy as np
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.tools import experimental_cone_kernel as cone

    # the plain version of this file's checkout, whose stats hold each lane's
    # hits (its arithmetic is the parent's); K10 is the checkout's at root
    spec = importlib.util.spec_from_file_location(
        "plain_cone", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "experimental_cone_kernel.py"))
    plain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(plain)
    device = torch.device("cuda")
    for name in ("trace_packets", "trace_packets_cone"):
        build.load_library(name)
    sim, pf, pi = _cone_setup(cs, device)
    shape = sim.geometry.shape
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start, focus, seen = time.perf_counter(), set(), {}
    kept = {"refused": 0, "unplaced": 0}
    rows = None  # the lanes the plain version marches; None: all
    x = _cone_phase32(cs, sim, device)
    for repeat in range(int(repeats)):
        if time.perf_counter() - t_start > float(budget_s):
            break
        if rows is None and 0 < int(focus_after) <= repeat and focus:
            rows = torch.cat([torch.arange(c * 512, (c + 1) * 512) for c in sorted(focus)])
            rows = rows.to(device)
        if int(new_lanes):
            pf, pi = _cone_lanes(cs, sim, device, cs.PARITY_SEED + repeat)
        elif repeat:
            x = _cone_phase32(cs, sim, device)
        chi = _chi(cs, sim, x)
        out_k = cone.trace_packets_cone(chi, pf, pi, shape=shape)
        stats = {}
        if rows is None:
            out_r = plain.trace_packets_cone_reference(chi, pf, pi, shape=shape, stats=stats)
            found = _cone_offenders(out_k, out_r, stats["unplaced"])
            lanes_of = list(range(pf.shape[0]))
        else:
            out_r = plain.trace_packets_cone_reference(chi, pf[rows], pi[rows], shape=shape,
                                                       stats=stats)
            found = _cone_offenders((None, out_k[1][rows], out_k[2][rows]), out_r,
                                    stats["unplaced"])
            lanes_of = rows.tolist()
        found["lanes"] = [lanes_of[i] for i in found["lanes"]]
        unplaced = [lanes_of[i] for i in torch.nonzero(stats["unplaced"]).reshape(-1).tolist()]
        # a state flip alone passes (it is counted); the rest are refused
        refused = [lane for lane, u, sk, sr in zip(found["lanes"], found["unplaced"],
                                                   found["states_k"], found["states_r"])
                   if sk == sr or u]
        focus.update(lane // 512 for lane in unplaced + refused)
        rec = {"label": label, "repeat": repeat, "seconds": time.perf_counter() - t_start,
               "focus_chunks": None if rows is None else sorted(focus), **found,
               "unplaced_lanes": unplaced, "refused": refused}
        new = [lane for lane in unplaced if seen.get(lane, 0) < 2]
        if ((refused and kept["refused"] < MAX_EVIDENCE_FILES)
                or (new and kept["unplaced"] < MAX_EVIDENCE_FILES)):
            for lane in new:
                seen[lane] = seen.get(lane, 0) + 1
            kept["refused" if refused else "unplaced"] += 1
            path = os.path.join(OUT_DIR, f"k10_evidence_{label}_{repeat}.npz")
            full_r = out_r if rows is None else None
            if full_r is None:  # the plain outputs of the marched chunks, in place
                full_r = [t.clone() for t in out_k]
                full_r[1][rows], full_r[2][rows] = out_r[1], out_r[2]
            _save_cone_evidence(path, chi, pf, pi, refused + unplaced, out_k, full_r,
                                x=x.cpu().numpy(), refused=np.asarray(refused, np.int64),
                                unplaced=np.asarray(unplaced, np.int64),
                                seed=cs.PARITY_SEED + (repeat if int(new_lanes) else 0))
            rec["evidence"] = path
        emit(rec)


def k10_capture(root):
    """Phase 32's final χ and phase 33's parity lanes, kept for k10-time."""
    cs = _load(root)
    import torch

    from cmacionize_torch.kernels import build

    device = torch.device("cuda")
    for name in ("trace_packets", "trace_packets_cone"):
        build.load_library(name)
    sim, pf, pi = _cone_setup(cs, device)
    x = _cone_phase32(cs, sim, device)
    torch.save({"neutral": _chi(cs, sim, torch.ones_like(x)).cpu(), "final": _chi(cs, sim, x).cpu(),
                "pf": pf.cpu(), "pi": pi.cpu(), "shape": tuple(sim.geometry.shape)},
               _saved(K10_INPUTS))


# the counters of k10-study, added to K10: phases of each chunk, lanes that
# walk, the walk's candidate cells, cells with l > 0, a warp's cycles in the
# walk and its slowest lane's candidates, a block's cycles
K10_STUDY_COUNTERS = ("phases", "max_phases", "walking_lanes", "candidates", "path_cells",
                      "warp_walk_cycles", "warp_max_candidates", "block_cycles", "blocks")
K10_STUDY_END = "  reinterpret_cast<float2*>(pf + row)[0] = make_float2(px, py);\n"
K10_STUDY = {
    "namespace {\n\nconstexpr int kS = 8;":
        "namespace {\n\n__device__ unsigned long long g_study[16];\n\nconstexpr int kS = 8;",
    "  const int lane = threadIdx.x;\n":
        "  const int lane = threadIdx.x;\n"
        "  unsigned st_cand = 0, st_path = 0, st_walkers = 0, st_phases = 0;\n"
        "  unsigned long long st_walk = 0, st_wmax = 0;\n"
        "  const long long st_start = clock64();\n",
    "    const int gx = cx - bx, gy = cy - by, gz = cz - bz;\n":
        "    ++st_phases;\n    const int gx = cx - bx, gy = cy - by, gz = cz - bz;\n",
    "            const float tzi = Z.t_in(cgz);\n":
        "            ++st_n;\n            const float tzi = Z.t_in(cgz);\n",
    "            const int slot = (cgx * kS + cgy) * kS + cgz;\n":
        "            ++st_path;\n            const int slot = (cgx * kS + cgy) * kS + cgz;\n",
    "    if (march) {\n":
        "    {\n      const unsigned ballot = __ballot_sync(0xffffffffu, march);\n"
        "      if ((lane & 31) == 0) st_walkers += __popc(ballot);\n    }\n"
        "    const long long st_w0 = clock64();\n    unsigned st_n = 0;\n    if (march) {\n",
    "      state = absorbed ? 1 : (outside ? 2 : 0);\n    }\n":
        "      state = absorbed ? 1 : (outside ? 2 : 0);\n    }\n"
        "    {\n      const long long st_w1 = clock64();\n      st_cand += st_n;\n"
        "      const unsigned most = __reduce_max_sync(0xffffffffu, st_n);\n"
        "      if ((lane & 31) == 0 && most > 0) {\n        st_walk += st_w1 - st_w0;\n"
        "        st_wmax += most;\n      }\n    }\n",
    K10_STUDY_END:
        "  {\n    const unsigned c = __reduce_add_sync(0xffffffffu, st_cand);\n"
        "    const unsigned p = __reduce_add_sync(0xffffffffu, st_path);\n"
        "    if ((lane & 31) == 0) {\n      atomicAdd(g_study + 2, st_walkers);\n"
        "      atomicAdd(g_study + 3, c);\n      atomicAdd(g_study + 4, p);\n"
        "      atomicAdd(g_study + 5, st_walk);\n      atomicAdd(g_study + 6, st_wmax);\n    }\n"
        "    if (lane == 0) {\n      atomicAdd(g_study + 0, st_phases);\n"
        "      atomicMax(g_study + 1, static_cast<unsigned long long>(st_phases));\n"
        "      atomicAdd(g_study + 7, static_cast<unsigned long long>(clock64() - st_start));\n"
        "      atomicAdd(g_study + 8, 1ull);\n    }\n  }\n" + K10_STUDY_END,
}
K10_STUDY_READ = (
    '\nextern "C" int cmi_cone_study(unsigned long long* out, int reset) {\n'
    "  if (reset) {\n    const unsigned long long zeros[16] = {};\n"
    "    return static_cast<int>(cudaMemcpyToSymbol(g_study, zeros, sizeof(zeros)));\n  }\n"
    "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_study, 16 * sizeof(*out)));\n}\n")


def k10_study(label, root):
    """K10 with the study's counters on the kept inputs (k10-capture): phases
    a chunk, the share of a phase's lanes that walk, the walk's cycles a
    candidate cell and its share of a block's cycles; the counted kernel's
    registers, and the kernel as built: registers and blocks a SM."""
    cs = _load(root)
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.kernels import trace_packets_cone as k10
    from cmacionize_torch.tools import experimental_cone_kernel as cone

    device = torch.device("cuda")
    build.load_library("trace_packets_cone")
    saved = torch.load(_saved(K10_INPUTS), weights_only=False)
    pf, pi, shape = saved["pf"].to(device), saved["pi"].to(device), saved["shape"]
    library, layout = _variant("trace_packets_cone", K10_STUDY, "trace_packets_cone_kernel",
                               append=K10_STUDY_READ)
    read = library.cmi_cone_study
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    counters = (ctypes.c_ulonglong * 16)()
    emit({"label": label, "built": _ptxas_kernel(
        build.library_path("trace_packets_cone").with_suffix(".log").read_text(),
        "trace_packets_cone_kernel"), "counted": layout})
    with swapped_library(k10, "trace_packets_cone", library):
        for field in ("neutral", "final"):
            chi = saved[field].to(device)
            assert read(counters, 1) == 0
            cone.trace_packets_cone(chi, pf, pi, shape=shape)
            torch.cuda.synchronize()
            assert read(counters, 0) == 0
            c = dict(zip(K10_STUDY_COUNTERS, list(counters)))
            emit({"label": label, "chi": field, **c,
                  "phases_a_chunk": c["phases"] / c["blocks"],
                  "walking_share": c["walking_lanes"] / (512 * c["phases"]),
                  "candidates_a_walk": c["candidates"] / max(c["walking_lanes"], 1),
                  "path_cells_a_walk": c["path_cells"] / max(c["walking_lanes"], 1),
                  "warp_cycles_a_candidate": c["warp_walk_cycles"] / max(c["warp_max_candidates"],
                                                                         1),
                  "walk_share_of_block_cycles": c["warp_walk_cycles"]
                  / max(c["block_cycles"] * 16, 1)})


def k10_time(label, root):
    """K10 as built on the kept inputs: the fully neutral χ and phase 32's
    final one, CUDA events over 20 launches, K1 on the same packets, its
    registers and blocks a SM; the outputs kept and held bit for bit against
    those of a checkout timed before it in the same call."""
    cs = _load(root)
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.ops import traversal
    from cmacionize_torch.tools import experimental_cone_kernel as cone

    device = torch.device("cuda")
    for name in ("trace_packets", "trace_packets_cone"):
        build.load_library(name)
    saved = torch.load(_saved(K10_INPUTS), weights_only=False)
    pf, pi, shape = saved["pf"].to(device), saved["pi"].to(device), saved["shape"]
    k1_packets = traversal.make_packets(pf[:, :3], pf[:, 3:6], pf[:, 6].contiguous(),
                                        pf[:, 7].contiguous(), shape)
    outs = {}
    for field in ("neutral", "final"):
        chi = saved[field].to(device)
        out = cone.trace_packets_cone(chi, pf, pi, shape=shape)
        torch.cuda.synchronize()
        outs[field] = [t.cpu() for t in out]
        ms = [cs.time_cuda(lambda: cone.trace_packets_cone(chi, pf, pi, shape=shape), 20)
              for _ in range(3)]
        scratch = torch.zeros(chi.numel(), device=device)
        k1_ms = cs.time_cuda(lambda: traversal.trace_packets(chi.reshape(-1), k1_packets, scratch,
                                                             shape=shape), 20)
        states = torch.bincount(out[2][:, 3], minlength=3).tolist()
        emit({"label": label, "chi": field, "ms": ms, "k1_ms": k1_ms, "states": states})
    sass = _sass_counts(str(build.library_path("trace_packets_cone")), "trace_packets_cone_kernel")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"k10_{label}.sass"), "w") as f:
        f.write(sass["sass"])
    emit({"label": label, "layout": _ptxas_kernel(
        build.library_path("trace_packets_cone").with_suffix(".log").read_text(),
        "trace_packets_cone_kernel"), "sass_counts": sass["counts"]})
    torch.save(outs, _saved(f"turns_k10_out_{label}.pt"))
    for other in os.listdir(tempfile.gettempdir()):
        m = re.fullmatch(r"turns_k10_out_(.+)\.pt", other)
        if not m or m.group(1) == label:
            continue
        theirs = torch.load(_saved(other), weights_only=False)
        emit({"label": label, "against": m.group(1), "identical_states_and_positions": {
            field: [_bits_equal(outs[field][k], theirs[field][k]) for k in (1, 2)]
            for field in outs},
            "tally_rel_l1": {field: float((outs[field][0] - theirs[field][0]).abs().sum()
                                          / theirs[field][0].abs().sum()) for field in outs}})


# K13e's clocked variant: each lane's cycles a step in place of its output
# (the output kept live, so that the loop is not dropped)
K13E_CYCLES = {
    "  for (int i = 0; i < nstep; i += kDdaBlockSteps) {\n":
        "  const long long t_clock = clock64();\n"
        "  for (int i = 0; i < nstep; i += kDdaBlockSteps) {\n",
    "  out[lane] = s.px + s.tau;\n":
        "  out[lane] = static_cast<float>(clock64() - t_clock) / nstep + 0.0f * (s.px + s.tau);\n",
}


def _sass_counts(path: str, kernel: str) -> dict:
    """Opcode counts of ``kernel``'s SASS in the library at ``path``
    (``cuobjdump -sass``), and the SASS itself."""
    from cmacionize_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    body, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            body.append(line)
    counts = {}
    for line in body:
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m:
            op = m.group(1).split(".")[0]
            counts[op] = counts.get(op, 0) + 1
    return {"counts": counts, "sass": "\n".join(body)}


def _k13e_clocked(library, a, b, nstep):
    """Per-warp cycles a step of a clocked K13e library on lanes (a, b): the
    first lane of each warp."""
    import torch

    fn = library.cmi_dda_math
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    out = torch.empty_like(a)
    assert fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), nstep,
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    return out.reshape(-1)[::32].cpu()


def k13e_time(label, root):
    """K13e as built on the tool's 1024 lanes × 7808 steps: ms (CUDA events,
    three windows of 20 calls), registers, each warp's cycles a step from a
    clocked build of the same source, the SASS's opcode counts (kept under
    ``out/``), and its output held bit for bit to the plain version
    and to a checkout timed before it in the same call."""
    cs = _load(root)
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.kernels import probe_deposit as pd
    from cmacionize_torch.tools import probe_deposit as tool

    device = torch.device("cuda")
    build.load_library("probe_deposit")
    nstep = tool.NSTEP
    a, b = (t.reshape(-1).contiguous() for t in tool.e_inputs(device))
    out = pd.dda_math(a, b, nstep)
    ref = pd.dda_math_reference(a, b, nstep)
    torch.cuda.synchronize()
    ms = [cs.time_cuda(lambda: pd.dda_math(a, b, nstep), 20) for _ in range(3)]
    clocked, layout = _variant("probe_deposit", K13E_CYCLES, "dda_math_kernel")
    cycles = _k13e_clocked(clocked, a, b, nstep)
    sass = _sass_counts(str(build.library_path("probe_deposit")), "dda_math_kernel")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"k13e_{label}.sass"), "w") as f:
        f.write(sass["sass"])
    clock = cs.sm_clock_hz()
    emit({"label": label, "ms": ms, "identical_to_plain": _bits_equal(out, ref),
          "built": _ptxas_kernel(build.library_path("probe_deposit").with_suffix(".log")
                                 .read_text(), "dda_math_kernel"),
          "warp_cycles_a_step": {"min": float(cycles.min()), "median": float(cycles.median()),
                                 "max": float(cycles.max()), "all": cycles.tolist()},
          "cycles_a_step_from_ms": min(ms) * 1e-3 * clock / nstep, "clock_hz": clock,
          "sass_counts": sass["counts"]})
    torch.save(out.cpu(), _saved(f"turns_k13e_out_{label}.pt"))
    for other in os.listdir(tempfile.gettempdir()):
        m = re.fullmatch(r"turns_k13e_out_(.+)\.pt", other)
        if m and m.group(1) != label:
            emit({"label": label, "against": m.group(1), "identical": _bits_equal(
                out.cpu(), torch.load(_saved(other), weights_only=False))})


# ------------------------------------------------------------------ K13h, K8, K8p

def k13h_time(label, root):
    """K13h at the tools' 1024 packets × 7808 steps (``[1024, 1]``, lidx
    13t mod 128, unit weights) and at 2^16 seeded packets × 7808 steps: (a),
    (b), (c) as ``tools/launch_cost.py`` takes them, the device time by kernel,
    ``torch.bincount`` on the tools' expanded cells; each output held to the
    plain version (exact on integer weights, per-cell rel err on random ones),
    two calls against each other, and the outputs against a checkout timed
    before it in the same call."""
    cs = _load(root)
    import numpy as np
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.kernels import probe_deposit as pd
    from cmacionize_torch.tools import launch_cost as lc
    from cmacionize_torch.tools import probe_deposit as tool

    device = torch.device("cuda")
    build.load_library("probe_deposit")
    nstep = tool.NSTEP
    rng = np.random.default_rng(cs.PARITY_SEED)
    dep, lidx = tool.sublane_inputs(device)
    cases = {"tools": (dep, lidx, "integer"),
             "seeded 1024 integer": (*cs.histogram_inputs(rng, 1024, device, "integer"),
                                     "integer"),
             "seeded 65536 random": (*cs.histogram_inputs(rng, 1 << 16, device, "random"),
                                     "random")}
    outs = {}
    for case, (d, l, weights) in cases.items():
        def call():
            return pd.shifted_histogram(d, l, nstep)

        first, second = call(), call()
        ref = pd.shifted_histogram_reference(d, l, nstep)
        torch.cuda.synchronize()
        rel = float(((first.double() - ref.double()).abs() / ref.double().abs()).max())
        rec = {"label": label, "case": case, "packets": d.numel(), "steps": nstep,
               "identical_to_plain": bool(torch.equal(first, ref)), "rel_err": rel,
               "two_calls_identical": _bits_equal(first, second),
               "a_ms": lc.per_call_ms(call), "b_ms": lc.graph_ms(call),
               "c_us": lc.host_us({"w": call}, 2000 if d.numel() <= 1024 else 200)["w"],
               "split_ms": lc.device_split(call)}
        if case == "tools":
            cells = ((l.reshape(1, -1).long() + torch.arange(nstep, device=device)[:, None])
                     % 128).reshape(-1)
            w = d.reshape(1, -1).expand(nstep, -1).reshape(-1).contiguous()

            def library():
                return torch.bincount(cells, w, minlength=128)

            # bincount reads its input's largest value to the host, so no CUDA
            # graph captures it: its device time comes from the profiler
            rec["bincount"] = {"a_ms": lc.per_call_ms(library),
                               "device_ms": sum(lc.device_split(library).values()),
                               "c_us": lc.host_us({"w": library}, 500)["w"]}
            del cells, w
        if case == "tools" and "K13h" in getattr(lc, "NEW_PATH", {}):
            rec["host_split_us"] = lc.host_us(lc.new_path_steps("K13h", (d, l, nstep)), 2000)
        emit(rec)
        outs[case] = first.cpu()
    torch.save(outs, _saved(f"turns_k13h_out_{label}.pt"))
    for other in os.listdir(tempfile.gettempdir()):
        m = re.fullmatch(r"turns_k13h_out_(.+)\.pt", other)
        if m and m.group(1) != label:
            theirs = torch.load(_saved(other), weights_only=False)
            emit({"label": label, "against": m.group(1),
                  "identical": {k: _bits_equal(v, theirs[k]) for k, v in outs.items()
                                if k in theirs}})


K13H_PARTS = {
    "at most 64 blocks": {"constexpr int kHistBlocks = 128;": "constexpr int kHistBlocks = 64;"},
    "at most 256 blocks": {"constexpr int kHistBlocks = 128;": "constexpr int kHistBlocks = 256;"},
    "no __syncwarp": {"        __syncwarp(leaders);\n": ""},
}


def k13h_parts(label, root):
    """This checkout's K13h with each piece changed (:data:`K13H_PARTS`: a grid
    of at most 64 or 256 blocks, the leaders' steps without a ``__syncwarp``)
    at the tools' 1024 × 7808: (b) on the device alone, the outputs against
    the plain version, registers."""
    cs = _load(root)
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.kernels import probe_deposit as pd
    from cmacionize_torch.tools import launch_cost as lc
    from cmacionize_torch.tools import probe_deposit as tool

    device = torch.device("cuda")
    build.load_library("probe_deposit")
    pd.histogram_scratch(torch.cuda.current_device(), 1024 * 1024)  # rows for larger grids
    dep, lidx = tool.sublane_inputs(device)
    seeded = cs.histogram_inputs(__import__("numpy").random.default_rng(7), 1024, device, "integer")
    nstep = tool.NSTEP

    def reading():
        rec = {}
        for case, (d, l) in {"tools": (dep, lidx), "seeded": seeded}.items():
            out = pd.shifted_histogram(d, l, nstep)
            rec[case] = {"b_ms": lc.graph_ms(lambda: pd.shifted_histogram(d, l, nstep)),
                         "identical_to_plain": bool(torch.equal(
                             out, pd.shifted_histogram_reference(d, l, nstep)))}
        return rec

    emit({"label": label, "piece": "kept", **reading(),
          "layout": _ptxas_kernel(build.library_path("probe_deposit").with_suffix(".log")
                                  .read_text(), "shifted_histogram_kernel")})
    for piece, substitutions in K13H_PARTS.items():
        library = variant_library("probe_deposit", substitutions)
        with swapped_library(pd, "probe_deposit", library):
            emit({"label": label, "piece": piece, **reading(),
                  "layout": _ptxas_kernel(library.ptxas_log, "shifted_histogram_kernel")})


def _dust(cs, device):
    config = cs.dust_simulation.dust_config_from_params(cs.ParameterFile(cs.DUSTY_GALAXY_PARAMS))
    return cs.dust_simulation.DustSimulation(config, device=device, seed=cs.DUST_SEED)


def _k8_calls(cs, sim):
    """Every K8 and K8p call of one intensity run and one polarized run of
    dusty_galaxy, each timed in the run by CUDA events (synchronised before,
    so the figure holds the call's host time as the device sees it), with
    its inputs cloned: [(kernel, run, order, active, ms, args, kwargs)]."""
    import torch

    from cmacionize_torch.ops import peel_off

    calls, run = [], ["intensity"]

    def timed(kernel, original, active_at):
        def wrapper(*args, **kwargs):
            active = args[active_at]
            n_active = int(active.sum())
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = original(*args, **kwargs)
            end.record()
            torch.cuda.synchronize()
            calls.append((kernel, run[0], sum(c[1] == run[0] for c in calls), n_active,
                          start.elapsed_time(end), _clone(args), dict(kwargs)))
            return out
        return wrapper

    originals = (peel_off.peel_off_deposit, peel_off.peel_off_deposit_polarized)
    peel_off.peel_off_deposit = timed("K8", originals[0], 3)
    peel_off.peel_off_deposit_polarized = timed("K8p", originals[1], 5)
    try:
        sim.run()
        run[0] = "polarized"
        sim.run_polarized()
    finally:
        peel_off.peel_off_deposit, peel_off.peel_off_deposit_polarized = originals
    return calls


def _clone(args):
    import torch

    def one(a):
        if torch.is_tensor(a):
            return a.clone()
        if isinstance(a, tuple) and a and torch.is_tensor(a[0]):
            return tuple(t.clone() for t in a)
        return a

    return tuple(one(a) for a in args)


def _replay(kernel, args, kwargs):
    """A function of no arguments that makes the call again into scratch
    images."""
    import torch

    from cmacionize_torch.ops import peel_off

    if kernel == "K8":
        chi, position, weight, active, ccd = args
        scratch = torch.zeros_like(ccd)
        return lambda: peel_off.peel_off_deposit(chi, position, weight, active, scratch, **kwargs)
    chi, position, direction, nref, stokes, active, planes = args
    scratch = tuple(torch.zeros_like(p) for p in planes)
    return lambda: peel_off.peel_off_deposit_polarized(chi, position, direction, nref, stokes,
                                                       active, scratch, **kwargs)


def _k8_outputs(kernel, args, kwargs):
    """(τ, pixel) of every event from the checkout's K8 / K8p wrapper."""
    import torch

    from cmacionize_torch.kernels.peel_off import peel_off_cuda
    from cmacionize_torch.kernels.peel_off_polarized import peel_off_polarized_cuda

    n = args[1].shape[0]
    tau = torch.empty(n, device=args[1].device)
    pix = torch.empty(n, dtype=torch.int32, device=args[1].device)
    if kernel == "K8":
        chi, position, weight, active, ccd = args
        kw = dict(kwargs)
        direction = kw.pop("direction", None)
        peel_off_cuda(chi, position, direction, weight, active, torch.zeros_like(ccd),
                      tau_out=tau, pix_out=pix, **kw)
    else:
        chi, position, direction, nref, stokes, active, planes = args
        peel_off_polarized_cuda(chi, position, direction, nref, stokes, active,
                                tuple(torch.zeros_like(p) for p in planes), tau_out=tau,
                                pix_out=pix, **kwargs)
    torch.cuda.synchronize()
    return tau, pix


def k8_time(label, root):
    """Every K8 launch of phases 26-27 (the 11 of the intensity run, the
    polarized run's emission) and K8p's 11, on dusty_galaxy (201³, 5e5
    photons): each launch's time in the run (CUDA events), its time back to
    back over 20 calls on its own inputs (``chip_smoke.py:time_cuda``, the
    figure of PERF.md's table), its active events and the plain march's mean
    and largest steps over them, the bound of each K8 launch
    (``chip_smoke.py``'s operation counts), cycles a step where one event is
    active; each launch's τ and pixels held to the plain version's and,
    bit for bit, to a checkout timed before it in the same call."""
    cs = _load(root)
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.ops import peel_off
    from cmacionize_torch.tools import launch_cost as lc

    device = torch.device("cuda")
    for name in ("trace_packets", "peel_off", "peel_off_polarized"):
        build.load_library(name)
    sim = _dust(cs, device)
    sim.run()
    sim.run_polarized()  # warm
    calls = _k8_calls(cs, sim)
    clock = cs.sm_clock_hz()
    view, chi = sim.view, sim.chi
    npix = view.pixels[0] * view.pixels[1]
    kept, totals = {}, {"K8": [0.0] * 4, "K8p": [0.0] * 4}
    for kernel, run, order, n_active, ms_run, args, kwargs in calls:
        active = args[3] if kernel == "K8" else args[5]
        position = args[1]
        stats = {}
        peel_off.peel_off_tau_reference(chi, position[active], view=view, stats=stats)
        steps = int(stats["packet_steps"])
        ms = cs.time_cuda(_replay(kernel, args, kwargs), 20)
        tau_k, pix_k = _k8_outputs(kernel, args, kwargs)
        tau_r = peel_off.peel_off_tau_reference(chi, position, view=view)
        pix_r = peel_off.ccd_pixel_reference(position, view=view)
        n = position.shape[0]
        if kernel == "K8":
            per_active = 16 + (0 if kwargs.get("direction") is None else 12)
            ops = cs.OPS_PER_K8_STEP * steps + cs.OPS_PER_K8_EVENT * n_active
            if kwargs.get("direction") is not None:
                ops += cs.OPS_PER_K8_PHASE * n_active
            n_bytes = 4 * chi.numel() + n + per_active * n_active + 8 * npix
        else:
            ops = cs.OPS_PER_K8_STEP * steps + cs.OPS_PER_K8P_EVENT * n_active
            n_bytes = 4 * chi.numel() + n + 52 * n_active + 32 * npix
        bound = max(n_bytes / cs.HBM_BYTES_PER_S, ops / cs.F32_OPS_PER_S) * 1e3
        key = f"{kernel} {run} {order}"
        kept[key] = (tau_k.cpu(), pix_k.cpu(), float(position.sum()))
        split = lc.device_split(_replay(kernel, args, kwargs), 10)
        rec = {"label": label, "kernel": kernel, "run": run, "order": order, "active": n_active,
               "ms_in_run": ms_run, "ms": ms, "packet_steps": steps,
               "mean_steps": steps / max(n_active, 1), "max_steps": stats.get("loop_steps"),
               "bound_ms": bound, "loss_ms": ms - bound, "device_ms": sum(split.values()),
               "split_ms": split,
               "tau_identical_to_plain": bool(torch.equal(tau_k[active], tau_r[active])),
               "pix_identical_to_plain": bool(torch.equal(pix_k[active], pix_r[active]))}
        if n_active == 1:
            rec["cycles_a_step"] = ms * 1e-3 * clock / max(steps, 1)
        totals[kernel][0] += ms
        totals[kernel][1] += bound
        totals[kernel][2] += ms_run
        totals[kernel][3] += rec["device_ms"]
        emit(rec)
    emit({"label": label, "sums": {k: {"ms": v[0], "bound_ms": v[1], "loss_ms": v[0] - v[1],
                                       "ms_in_run": v[2], "device_ms": v[3]}
                                   for k, v in totals.items()},
          "launches": {k: sum(c[0] == k for c in calls) for k in totals},
          "layout": _kernel_registers("peel_off")})
    torch.save(kept, _saved(f"turns_k8_out_{label}.pt"))
    for other in os.listdir(tempfile.gettempdir()):
        m = re.fullmatch(r"turns_k8_out_(.+)\.pt", other)
        if m and m.group(1) != label:
            theirs = torch.load(_saved(other), weights_only=False)
            emit({"label": label, "against": m.group(1), "identical": {
                key: (v[2] == theirs[key][2] and torch.equal(v[0], theirs[key][0])
                      and torch.equal(v[1], theirs[key][1]))
                for key, v in kept.items() if key in theirs}})


K8_PARTS = {
    "ahead 8": {"peel_march.cuh": {"constexpr int kAhead = 4;": "constexpr int kAhead = 8;"}},
    "IEEE walls": {"peel_march.cuh": {
        "walk<false>(w, ax, ay, az, g,": "walk<true>(w, ax, ay, az, g,"}},
}


def k8_parts(label, root):
    """This checkout's K8 and K8p with each piece forced or changed, on every
    call of one intensity and one polarized run: back to back over 20 calls
    (``chip_smoke.py:time_cuda``), the device time in a profiler window (all
    kernels, and the march's alone) and, for the emission and the last order,
    the host µs a call; variants of the sources (:data:`K8_PARTS`) with their
    registers, each call's τ and pixels held to the kept build's bit for bit;
    the SASS's opcode counts of the kept build."""
    cs = _load(root)
    import torch

    from cmacionize_torch.kernels import build
    from cmacionize_torch.kernels import peel_off as k8
    from cmacionize_torch.kernels import peel_off_polarized as k8p
    from cmacionize_torch.tools import launch_cost as lc

    device = torch.device("cuda")
    for name in ("trace_packets", "peel_off", "peel_off_polarized"):
        build.load_library(name)
    sim = _dust(cs, device)
    sim.run()
    calls = _k8_calls(cs, sim)

    def call_of(kernel, args, kwargs):
        if kernel == "K8p":
            chi, position, direction, nref, stokes, active, planes = args
            scratch = tuple(torch.zeros_like(p) for p in planes)
            return lambda: k8p.peel_off_polarized_cuda(chi, position, direction, nref, stokes,
                                                       active, scratch, **kwargs)
        kw = dict(kwargs)
        chi, position, weight, active, ccd = args
        scratch = torch.zeros_like(ccd)
        direction = kw.pop("direction", None)
        return lambda: k8.peel_off_cuda(chi, position, direction, weight, active, scratch, **kw)

    def times(kernels=("K8", "K8p")):
        row = []
        for kernel, run, order, n_active, _, args, kwargs in calls:
            if kernel not in kernels:
                continue
            call = call_of(kernel, args, kwargs)
            split = lc.device_split(call, 10)
            rec = {"kernel": kernel, "run": run, "order": order, "active": n_active,
                   "ms": cs.time_cuda(call, 20), "device_ms": sum(split.values()),
                   "march_ms": sum(v for k, v in split.items() if "peel_off" in k)}
            if order in (0, 11) and run == "intensity":
                rec["c_us"] = lc.host_us({"w": call}, 500)["w"]
            row.append(rec)
        return row

    def same_outputs():
        return all(torch.equal(a, b) for (kernel, *_, args, kwargs), outputs in
                   zip(calls, kept_outputs) for a, b in zip(_k8_outputs(kernel, args, kwargs),
                                                           outputs))

    kept_outputs = [_k8_outputs(c[0], c[5], c[6]) for c in calls]
    emit({"label": label, "piece": "kept", "launches": times()})
    sass = _sass_counts(str(build.library_path("peel_off")), "peel_off_kernel")
    emit({"label": label, "piece": "kept build", "layout": {
        **_kernel_registers("peel_off"), **_kernel_registers("peel_off_polarized")},
        "sass_counts": sass["counts"]})
    for piece, edits in K8_PARTS.items():
        names = ["peel_off"] + (["peel_off_polarized"] if "peel_march.cuh" in edits else [])
        libraries = {name: variant_library_files(name, edits) for name in names}
        with contextlib.ExitStack() as stack:
            for name, module in (("peel_off", k8), ("peel_off_polarized", k8p)):
                if name in libraries:
                    stack.enter_context(swapped_library(module, name, libraries[name]))
            emit({"label": label, "piece": piece,
                  "launches": times(("K8", "K8p") if len(names) == 2 else ("K8",)),
                  "same_outputs": same_outputs(),
                  "layout": {name: _ptxas_kernel(lib.ptxas_log, f"{name}_kernel")
                             for name, lib in libraries.items()}})


def k8_wall(label, root, other_label, other_root, pairs="20"):
    """The dusty_galaxy intensity run's wall (host clock, synchronised around
    ``run()``) of the checkout at ROOT against the one at OTHER_ROOT, in
    ``pairs`` alternating pairs (ROOT's run first in the even pairs, last in
    the odd ones): each checkout in a process of its own (``k8-wall-worker``),
    built and warmed by two runs before the first pair, the two never
    running at once; each wall, each pair's difference (ROOT − OTHER), its
    median and the pairs in which ROOT's run was faster."""
    import statistics

    workers = {who: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "k8-wall-worker", path],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for who, path in ((label, root), (other_label, other_root))}

    def reply(worker, tag):
        for line in worker.stdout:
            if line.startswith(tag):
                return line[len(tag):].strip()
        raise RuntimeError(f"k8-wall: a worker ended (rc {worker.wait()})")

    walls = {label: [], other_label: []}
    try:
        for worker in workers.values():
            reply(worker, "READY")
        for i in range(int(pairs)):
            for who in (label, other_label) if i % 2 == 0 else (other_label, label):
                workers[who].stdin.write("run\n")
                workers[who].stdin.flush()
                walls[who].append(float(reply(workers[who], "WALL ")))
    finally:
        for worker in workers.values():
            worker.stdin.close()
        for worker in workers.values():
            try:
                worker.wait(timeout=60)
            except subprocess.TimeoutExpired:
                worker.kill()
                worker.wait()
    diffs = [a - b for a, b in zip(walls[label], walls[other_label])]
    emit({"label": label, "against": other_label,
          "piece": "intensity run walls (s), alternating pairs", "walls": walls, "diffs": diffs,
          "median_diff": statistics.median(diffs),
          "medians": {who: statistics.median(w) for who, w in walls.items()},
          "pairs_faster": sum(d < 0 for d in diffs), "pairs": len(diffs)})


def k8_wall_worker(root):
    """``k8-wall``'s worker: the checkout at ROOT's dusty_galaxy, two warm
    intensity runs, then one timed run for each line on its input, its wall
    printed after ``WALL``."""
    cs = _load(root)
    import torch

    from cmacionize_torch.kernels import build

    for name in ("trace_packets", "peel_off"):
        build.load_library(name)
    sim = _dust(cs, torch.device("cuda"))
    sim.run()
    sim.run()
    print("READY", flush=True)
    for _ in sys.stdin:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        print(f"WALL {time.perf_counter() - t0!r}", flush=True)

MODES = {"k9c-capture": k9c_capture, "k9c-time": k9c_time, "k9p-host": k9p_host,
         "k7-capture": k7_capture, "k7-time": k7_time, "k7-wall": k7_wall,
         "sharded-wall": sharded_wall, "k3-capture": k3_capture, "k3-time": k3_time,
         "k6s-capture": k6s_capture, "k6s-time": k6s_time, "k6s-wall": k6s_wall,
         "k2-time": k2_time, "k2-wall": k2_wall, "k3-parts": k3_parts,
         "k10-hunt": k10_hunt, "k10-capture": k10_capture, "k10-study": k10_study,
         "k10-time": k10_time, "k13e-time": k13e_time, "k13h-time": k13h_time,
         "k13h-parts": k13h_parts, "k8-time": k8_time, "k8-parts": k8_parts,
         "k8-wall": k8_wall, "k8-wall-worker": k8_wall_worker}


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
