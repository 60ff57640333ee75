"""Two checkouts of the repository, measured in turns on one card: K9c on
the sharded starbench run's merges, K7 on the starbench_voronoi run's
updates, K9p's host cost a call, and the walls of both runs.

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


MODES = {"k9c-capture": k9c_capture, "k9c-time": k9c_time, "k9p-host": k9p_host,
         "k7-capture": k7_capture, "k7-time": k7_time, "k7-wall": k7_wall,
         "sharded-wall": sharded_wall}


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
