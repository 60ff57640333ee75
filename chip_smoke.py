"""Drive the port's main path once on one CUDA card and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero):

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles K1 (``cmacionize_torch/csrc/trace_packets.cu``) with nvcc;
3. kernel parity: K1 against its plain PyTorch version on the card, on the
   same inputs made with numpy from a fixed seed (a 64³ Strömgren-like
   opacity with an ionized cone; 2^17 packets from the centre, then the
   main path's 1e6), both timed;
4. main path: ``benchmarks/stromgren.param`` at full size (64³ cells, 1e6
   packets, 20 iterations) through ParameterFile → HOnlyConfig.from_params →
   HOnlyIonizationSimulation(config, device="cuda").run(), timed, with K1's
   launch count and the Strömgren radius against the analytic one.

The line before the last is a JSON object with K1's results; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from cmacionize_torch import kernels
from cmacionize_torch.device import describe, require_cuda
from cmacionize_torch.kernels import build
from cmacionize_torch.models.ionization_simulation import (
    HOnlyConfig,
    HOnlyIonizationSimulation,
)
from cmacionize_torch.ops import traversal
from cmacionize_torch.utils.params import ParameterFile

ROOT = os.path.dirname(os.path.abspath(__file__))
STROMGREN_PARAM = os.path.join(ROOT, "benchmarks", "stromgren.param")

PARITY_SEED = 1234
# Tolerances of K1 against the plain version.  Both run the same IEEE f32
# operations per packet (K1 is built with --fmad=false), so flags and
# positions should match; the tally differs only by the order in which
# atomics add, i.e. at f32 round-off.
MAX_FLAG_MISMATCH_FRACTION = 1e-5
MAX_POSITION_DIFF = 5e-4  # cells
MAX_TALLY_REL_L1 = 1e-4
# Strömgren 50%-crossing radius / analytic radius
RADIUS_RATIO_RANGE = (0.98, 1.02)


def log(message: str) -> None:
    print(message, flush=True)


def check(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError(f"chip_smoke: check failed: {message}")


def parity_inputs(config: HOnlyConfig, n_packets: int, device):
    """A Strömgren-like 64³ opacity and isotropic packets from the centre,
    made with numpy: an ionized sphere (χ ≈ 0.1 per cell) in neutral gas
    (χ ≈ 300), with a fully ionized cone along +z through which packets
    escape; the rest are absorbed in the sphere or at its front."""
    rng = np.random.default_rng(PARITY_SEED)
    shape = config.geometry.shape
    dx = float(config.geometry.cell_size[0])
    chi_neutral = config.number_density * config.cross_section * dx
    centre = np.asarray(shape, np.float64) / 2.0
    offset = np.indices(shape).astype(np.float64) + 0.5 - centre[:, None, None, None]
    r = np.sqrt((offset**2).sum(0))
    x = np.where(r < 0.7 * centre[0], rng.uniform(1.5e-4, 4.5e-4, shape), 1.0)
    cone = offset[2] > r * np.cos(np.radians(20.0))
    x = np.where(cone, 1e-6, x)
    chi = (chi_neutral * x).astype(np.float32).reshape(-1)

    cos_t = rng.uniform(-1.0, 1.0, n_packets)
    phi = rng.uniform(0.0, 2.0 * np.pi, n_packets)
    sin_t = np.sqrt(1.0 - cos_t**2)
    direction = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], 1)
    position = centre[None, :] + 1e-4 * direction
    tau = -np.log1p(-rng.uniform(0.0, 1.0, n_packets))

    def on_device(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    packets = traversal.make_packets(
        on_device(position), on_device(direction), on_device(tau),
        torch.ones(n_packets, dtype=torch.float32, device=device), shape,
    )
    return on_device(chi), packets


def time_cuda(fn, repeats: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def kernel_parity(config: HOnlyConfig, device, n_packets: int) -> dict:
    shape = config.geometry.shape
    chi, packets = parity_inputs(config, n_packets, device)
    zeros = torch.zeros_like(chi)

    tally_k, out_k = traversal.trace_packets(chi, packets, zeros.clone(), shape=shape)
    tally_r, out_r = traversal.trace_packets_reference(
        chi, packets, zeros.clone(), shape=shape
    )
    torch.cuda.synchronize()

    n = packets.size
    flag_mismatch = int(
        ((out_k.absorbed != out_r.absorbed) | (out_k.active != out_r.active)).sum()
    )
    cell_mismatch = int(
        ((out_k.cx != out_r.cx) | (out_k.cy != out_r.cy) | (out_k.cz != out_r.cz)).sum()
    )
    pos_diff = max(
        float((getattr(out_k, f) - getattr(out_r, f)).abs().max())
        for f in ("px", "py", "pz")
    )
    tally_abs = (tally_k - tally_r).abs()
    tally_rel_l1 = float(tally_abs.sum() / tally_r.abs().sum())
    n_absorbed = int(out_r.absorbed.sum())
    log(
        f"parity: {n} packets, {n_absorbed} absorbed / {n - n_absorbed} escaped "
        f"(plain); absorbed/active flag mismatches {flag_mismatch}, cell "
        f"mismatches {cell_mismatch}, max |position diff| {pos_diff:.3e} cells, "
        f"tally rel L1 {tally_rel_l1:.3e}, max |tally diff| "
        f"{float(tally_abs.max()):.3e}"
    )
    check(0 < n_absorbed < n, "parity input has both absorbed and escaping packets")
    check(
        flag_mismatch <= MAX_FLAG_MISMATCH_FRACTION * n,
        f"flag mismatches {flag_mismatch} > {MAX_FLAG_MISMATCH_FRACTION} of {n}",
    )
    check(pos_diff <= MAX_POSITION_DIFF, f"position diff {pos_diff} > {MAX_POSITION_DIFF}")
    check(
        tally_rel_l1 <= MAX_TALLY_REL_L1,
        f"tally rel L1 {tally_rel_l1} > {MAX_TALLY_REL_L1}",
    )

    scratch = zeros.clone()
    ms = time_cuda(
        lambda: traversal.trace_packets(chi, packets, scratch, shape=shape), 20
    )
    plain_ms = time_cuda(
        lambda: traversal.trace_packets_reference(chi, packets, scratch, shape=shape), 3
    )
    log(
        f"timing at {shape[0]}^3 / {n} packets: K1 {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms per march (CUDA events, incl. the packet-state copy)"
    )
    return {
        "max_abs_err": float(tally_abs.max()),
        "ms": ms,
        "plain_ms": plain_ms,
    }


def stromgren_radius_ratio(sim: HOnlyIonizationSimulation, xH: np.ndarray) -> float:
    """50%-crossing radius of the binned xH profile / analytic radius
    (the estimator of benchmarks/run_stromgren.py)."""
    centers = sim.geometry.cell_centers()
    r = np.sqrt((centers**2).sum(-1))
    rbins = np.linspace(0, r.max(), 80)
    idx = np.digitize(r.ravel(), rbins)
    prof = np.array(
        [
            xH.ravel()[idx == i].mean() if (idx == i).any() else np.nan
            for i in range(1, len(rbins))
        ]
    )
    rmid = 0.5 * (rbins[1:] + rbins[:-1])
    good = ~np.isnan(prof)
    cross = np.interp(0.5, prof[good], rmid[good])
    return float(cross / sim.stromgren_radius_analytic())


def main_path(config: HOnlyConfig) -> dict:
    sim = HOnlyIonizationSimulation(config, device="cuda")
    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xH = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.LAUNCHES["trace_packets"]

    n_packets = config.n_photons * config.n_iterations
    xH_host = xH.cpu().numpy()
    escaped = sim.n_escaped.tolist()
    ratio = stromgren_radius_ratio(sim, xH_host)
    log(
        f"main path: stromgren.param {config.geometry.shape}, "
        f"{config.n_photons} packets x {config.n_iterations} iterations in "
        f"{wall:.4f} s wall, cold: the process's first run of the path "
        f"({n_packets / wall:.6g} packets/s); "
        f"K1 launches {launches}"
    )
    log(f"escaped per iteration: {escaped}")
    log(f"Stromgren 50%-radius / analytic: {ratio:.5f}")
    check(launches == config.n_iterations, f"K1 launches {launches}")
    check(xH_host.shape == tuple(config.geometry.shape), f"xH shape {xH_host.shape}")
    check(bool(np.isfinite(xH_host).all()), "xH is finite")
    check(bool(((xH_host > 0) & (xH_host <= 1)).all()), "xH in (0, 1]")
    check(
        RADIUS_RATIO_RANGE[0] <= ratio <= RADIUS_RATIO_RANGE[1],
        f"radius ratio {ratio} outside {RADIUS_RATIO_RANGE}",
    )
    return launches


def main() -> None:
    device = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    log(f"card: {smi.stdout.strip()}")
    log(f"device: {describe(device)}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib_path = build.compile_library("trace_packets")
    build.load_library("trace_packets")
    log(f"build: K1 built in {time.perf_counter() - t0:.2f} s -> {lib_path.name}")
    log(lib_path.with_suffix(".log").read_text().strip())

    config = HOnlyConfig.from_params(ParameterFile(STROMGREN_PARAM))
    small = kernel_parity(config, device, 2**17)
    # the shapes the main path gives K1: 64^3 cells, 1e6 packets
    parity = kernel_parity(config, device, config.n_photons)
    launches = main_path(config)

    record = {
        "name": "trace_packets",
        "route": "cuda",
        "source": "cmacionize_torch/csrc/trace_packets.cu",
        "replaces": "cmacionize_tpu/ops/traversal.py:115",
        "launches": launches,
        **parity,
        "max_abs_err": max(small["max_abs_err"], parity["max_abs_err"]),
    }
    print(json.dumps({"kernels": [record]}), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
