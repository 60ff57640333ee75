"""K5 on the input of ``chip_smoke.py``'s phase 23: where its steps go, and
its time on the card.

The input is stromgren_amr's: ``benchmarks/stromgren.param``'s box, gas,
source and σ/α on a 64³ coarse grid with [-2.5 pc, 2.5 pc)³ refined to level
3 (17,006,592 leaves), its neutral fraction after 20 iterations of 1.6e7
packets, and 1.6e7 fresh packets from the source.

- :func:`march_study` reads the plain version's ``stats``
  (``ops.amr_traversal.trace_packets_octree_reference``): the packets still
  active at the step cap, those at a fixed point of their step and the steps
  they take before and after it; the steps per packet; the longest lane's
  steps per warp (32 consecutive packets) and per block (256), the layout of
  a kernel with one thread per packet; and the warps and blocks that hold a
  stalled lane.
- :func:`main` builds the input, prints the study, the kernel's registers
  and resident blocks per SM, and its time at the default ``max_steps`` and
  at one above the longest packet that ends before the cap (that reading's
  output differs from the default's, so nothing uses it), each call on a
  fresh copy of the packets' state.

Times are CUDA events around each call, the mean of :data:`REPEATS` calls.
Run on the card, from the root of a checkout::

    python -m cmacionize_torch.tools.octree_study
"""

from __future__ import annotations

import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from cmacionize_torch.device import describe, require_cuda
from cmacionize_torch.kernels import trace_octree as k5
from cmacionize_torch.models import amr
from cmacionize_torch.models.ionization_simulation import HOnlyConfig
from cmacionize_torch.ops import amr_traversal
from cmacionize_torch.utils.params import ParameterFile

PC = 3.086e16
STROMGREN_PARAM = Path(__file__).resolve().parents[2] / "benchmarks" / "stromgren.param"
ZONE, MAX_LEVEL, PHOTONS, ITERATIONS = 2.5 * PC, 3, 16_000_000, 20  # chip_smoke.py's
WARP, BLOCK = 32, 256
REPEATS = 3  # timed calls of each measurement, after one to warm up


def phase23_input(device):
    """(root, children, chi, packets, march kwargs): stromgren_amr's final χ
    per coarse unit and 1.6e7 fresh packets in coarse units."""
    config = HOnlyConfig.from_params(ParameterFile(str(STROMGREN_PARAM)))
    scheme = amr.SpatialRefinement((-ZONE,) * 3, (2 * ZONE,) * 3, MAX_LEVEL)
    density = config.number_density
    t0 = time.perf_counter()
    grid = amr.build_amr_grid(config.geometry, scheme, lambda p: np.full(len(p), density),
                              max_level=MAX_LEVEL)
    sim = amr.AMRIonizationSimulation(
        config.geometry, scheme, lambda p: np.full(len(p), density), device=device,
        source_position=config.source_position, luminosity=config.luminosity,
        cross_section=config.cross_section, recombination_rate=config.recombination_rate,
        n_photons=PHOTONS, max_level=MAX_LEVEL, seed=42, grid=grid)
    t1 = time.perf_counter()
    sim.run(ITERATIONS)
    torch.cuda.synchronize()
    print(f"octree_study: {grid.n_cells} leaves built in {t1 - t0:.2f} s; {ITERATIONS} "
          f"iterations of {PHOTONS} packets in {time.perf_counter() - t1:.2f} s", flush=True)
    root, children = grid.octree_tables(device)
    chi = sim.number_density * sim.neutral_fraction * sim.cross_section * float(
        grid.geometry.cell_size[0])
    scale = 2.0 ** (-grid.max_level)
    pk = sim.emit()
    pk = pk._replace(px=pk.px * scale, py=pk.py * scale, pz=pk.pz * scale)
    march = dict(coarse_shape=tuple(grid.geometry.shape), max_level=grid.max_level)
    return root, children, chi, pk, march


def _quantiles(x: torch.Tensor) -> str:
    q = torch.tensor([0.5, 0.9, 0.99, 0.999, 1.0], dtype=torch.float64, device=x.device)
    values = torch.quantile(x.double()[: 1 << 24], q).tolist()  # quantile's size limit
    return ", ".join(f"q{p:g} {v:.0f}" for p, v in zip(q.tolist(), values))


def march_study(stats: dict, max_steps: int, label: str) -> dict:
    """The stall and step distributions of one plain march's ``stats``
    (with ``steps`` and ``fixed_point_step`` per packet), printed; returns
    the counts."""
    steps, fixed = stats["steps"].long(), stats["fixed_point_step"].long()
    n = steps.numel()
    capped = steps >= max_steps
    stalled = fixed >= 0
    ended = ~capped
    record = {
        "packets": n, "at_cap": int(capped.sum()), "fixed_points": int(stalled.sum()),
        "packet_steps": int(stats["packet_steps"]), "noop_steps": int(stats["noop_steps"]),
        "descent_levels": int(stats["descent_levels"]),
        "noop_descent_levels": int(stats["noop_descent_levels"]),
        "longest_ended": int(steps[ended].max()) if bool(ended.any()) else 0,
    }
    print(f"{label}: {n} packets, {record['at_cap']} active at the cap of {max_steps} steps, "
          f"{record['fixed_points']} of them at a fixed point; {record['packet_steps']} packet "
          f"steps, {record['noop_steps']} of them no-ops "
          f"({record['noop_steps'] / max(record['packet_steps'], 1):.4f}); descent levels "
          f"{record['descent_levels']}, {record['noop_descent_levels']} in no-op steps", flush=True)
    if bool(stalled.any()):
        print(f"  steps before the fixed point: {_quantiles(fixed[stalled])}; after it: "
              f"{_quantiles(max_steps - fixed[stalled])}", flush=True)
    print(f"  steps per packet that ends before the cap: {_quantiles(steps[ended])}, mean "
          f"{float(steps[ended].double().mean()):.2f}; longest {record['longest_ended']}",
          flush=True)
    for width, name in ((WARP, "warp"), (BLOCK, "block")):
        m = n // width * width
        longest = steps[:m].reshape(-1, width).max(1).values
        with_stall = capped[:m].reshape(-1, width).any(1)
        busy = steps[:m].sum() / (longest.sum() * width)
        record[f"{name}s_with_a_capped_lane"] = float(with_stall.double().mean())
        record[f"{name}_lane_use"] = float(busy)
        print(f"  longest lane per {name} of {width} consecutive packets: {_quantiles(longest)}; "
              f"{float(with_stall.double().mean()):.4f} of {name}s hold a lane at the cap; steps "
              f"taken / ({name}s x longest lane x {width}) = {float(busy):.4f}", flush=True)
    return record


def _state_copy(pk) -> dict:
    return {f: getattr(pk, f).clone() for f in k5._FLOAT_FIELDS + k5._BOOL_FIELDS}


def _events_ms(fn) -> float:
    """Mean ms of :data:`REPEATS` calls of ``fn(events)``, which records the
    (start, end) CUDA events around its launch after its setup; warmed up
    first (``events`` None)."""
    fn(None)
    total = 0.0
    for _ in range(REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn((start, end))
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / REPEATS


def _k5_call(root, children, chi, pk, march, max_steps: int):
    eps = amr_traversal.wall_eps(march["coarse_shape"], march["max_level"])
    steps = amr_traversal.default_max_steps(march["coarse_shape"], march["max_level"], max_steps)

    def call(events):
        fields, tally = _state_copy(pk), torch.zeros_like(chi)
        if events:
            events[0].record()
        k5.trace_octree_cuda(root, children, chi, tally, fields, eps=eps, max_steps=steps,
                             **march)
        if events:
            events[1].record()
        return tally, fields

    return call


def main() -> dict:
    device = require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    print(f"octree_study on {describe(device)}; {smi.stdout.strip()}", flush=True)
    root, children, chi, pk, march = phase23_input(device)
    max_steps = amr_traversal.default_max_steps(march["coarse_shape"], march["max_level"])
    results = {}

    stats = {}
    t0 = time.perf_counter()
    amr_traversal.trace_packets_octree_reference(root, children, chi, pk, torch.zeros_like(chi),
                                                 stats=stats, **march)
    torch.cuda.synchronize()
    print(f"octree_study: the plain march took {time.perf_counter() - t0:.2f} s", flush=True)
    results["study"] = march_study(stats, max_steps, "the plain march on phase 23's input")
    del stats
    below = results["study"]["longest_ended"] + 1  # one above the longest packet that ends
    for key, steps in (("ms", 0), ("capped_ms", below)):
        results[key] = ms = _events_ms(_k5_call(root, children, chi, pk, march, steps))
        print(f"  K5 at max_steps {steps or max_steps}"
              f"{' (a throwaway reading)' if steps else ''}: {ms:.4f} ms", flush=True)
    regs = k5.occupancy(device)
    print(f"octree_study: K5 takes {regs['registers']} registers, {regs['blocks_per_sm']} blocks "
          f"of {BLOCK} per SM x {regs['sms']} SMs", flush=True)
    results["occupancy"] = regs
    return results


if __name__ == "__main__":
    main()
