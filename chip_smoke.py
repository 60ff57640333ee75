"""Drive the port's main path once on one CUDA card and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero):

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles K1 (``cmacionize_torch/csrc/trace_packets.cu``) with nvcc,
   while K3's build (phase 5) runs beside it: one nvcc per source, started
   together;
3. kernel parity: K1 against its plain PyTorch version on the card, on the
   same inputs made with numpy from a fixed seed (a 64³ Strömgren-like
   opacity with an ionized cone; 2^17 packets from the centre, then the
   main path's 1e6), both timed;
4. main path: ``benchmarks/stromgren.param`` at full size (64³ cells, 1e6
   packets, 20 iterations) through ParameterFile → HOnlyConfig.from_params →
   HOnlyIonizationSimulation(config, device="cuda").run(), timed, with K1's
   launch count and the Strömgren radius against the analytic one;
5. build: K3 (``cmacionize_torch/csrc/hydro_step.cu``), its seconds and the
   ``ptxas -v`` report;
6. K3 parity: the MUSCL-Hancock step against its plain PyTorch version on
   the card at 64³, on a starbench-like state made with numpy from a fixed
   seed (a hot ionized bubble, an outward shell, a Sod-like jump along x),
   for HLLC and Exact with reflective and with periodic/outflow walls, both
   timed;
7. main path: ``benchmarks/starbench.param`` at full size (64³ cells, 10 ×
   1e6 packets per step, 2048 steps to 0.141 Myr) through
   RHDSimulation.from_params(..., device="cuda").run(snapshot_callback=...),
   timed, with the K1 and K3 launch counts, conservation, the ionization
   state and the front radius R(t) at the ten outputs against the Spitzer /
   Hosokawa-Inutsuka band and the JAX package's trajectory; then K1 alone in
   this (opaque) regime.

The line before the last is a JSON object with the kernels' results; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
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
from cmacionize_torch import constants
from cmacionize_torch.models import sources
from cmacionize_torch.models.ionization_simulation import (
    HOnlyConfig,
    HOnlyIonizationSimulation,
)
from cmacionize_torch.models.rhd_simulation import (
    RHDSimulation,
    hosokawa_inutsuka_radius,
    spitzer_radius,
)
from cmacionize_torch.ops import hydro, traversal
from cmacionize_torch.utils.params import ParameterFile

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCHMARKS = os.path.join(ROOT, "benchmarks")
STROMGREN_PARAM = os.path.join(BENCHMARKS, "stromgren.param")
STARBENCH_PARAM = "starbench.param"  # opened from BENCHMARKS, like its .yml
PC = 3.086e16
MYR = 3.15576e13

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
# K3 against its plain version: max |Δ| per conserved field relative to the
# field's largest magnitude.  Both run the same f32 operations in the same
# order (K3 is built with --fmad=false); the exact solver's powf may differ
# from torch's pow shortcuts.
MAX_HYDRO_REL_ERR = {"HLLC": 1e-6, "Exact": 1e-5}
# starbench: the JAX package's production trajectory R(t) (pc) at the ten
# outputs (benchmarks/RESULTS.md, "starbench snapshot-series trajectory"),
# and how far the port's may stray from it
JAX_STARBENCH_R_PC = (0.452, 0.582, 0.703, 0.811, 0.910, 1.001, 1.085, 1.166, 1.245, 1.301)
MAX_TRAJECTORY_DEVIATION = 0.05
MAX_MASS_DRIFT = 1e-4


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


def timed_build(name: str):
    """Compile ``csrc/<name>.cu`` and load it: (library path, seconds)."""
    t0 = time.perf_counter()
    path = build.compile_library(name)
    build.load_library(name)
    return path, time.perf_counter() - t0


def report_build(label: str, future) -> None:
    path, seconds = future.result()
    log(f"build: {label} built in {seconds:.2f} s -> {path.name}")
    log(path.with_suffix(".log").read_text().strip())


# ------------------------------------------------------------------- K3


def hydro_parity_state(geometry, device):
    """A starbench-like 64³ state in SI units, made with numpy: a hot
    ionized bubble (10⁴ K, 2% of the cloud density) of radius 12 cells, a
    shell 4 cells thick at three times the density moving outwards at 12
    km/s, the 100 K cloud, and for x < 16 cells a Sod-like jump (4× the
    density, 10× the temperature); 2% noise."""
    rng = np.random.default_rng(PARITY_SEED)
    shape = geometry.shape
    centre = np.asarray(shape, np.float64) / 2.0
    offset = np.indices(shape) + 0.5 - centre[:, None, None, None]
    r = np.sqrt((offset**2).sum(0))
    inside, shell = r < 12.0, (r >= 12.0) & (r < 16.0)
    nd = 3.113e9 * rng.uniform(0.98, 1.02, shape)
    T = np.full(shape, 100.0)
    nd = np.where(inside, 0.02 * nd, np.where(shell, 3.0 * nd, nd))
    T = np.where(inside, 1e4, T)
    jump = (np.indices(shape)[0] < 16) & ~inside & ~shell
    nd = np.where(jump, 4.0 * nd, nd)
    T = np.where(jump, 10.0 * T, T)
    radial = offset / np.maximum(r, 1e-9)
    vel = np.where(shell, 1.2e4, 0.0) * radial + rng.uniform(-50.0, 50.0, (3,) + shape)
    fields = (nd * constants.PROTON_MASS, *vel, nd * constants.BOLTZMANN * T)
    return hydro.Primitives(*(
        torch.tensor(np.asarray(f, np.float32), device=device) for f in fields
    ))


def hydro_parity(device, geometry, gamma, dt) -> dict:
    """K3 against hydro_step_padded_reference on the card; both timed.

    Returns the HLLC (main path) times and, as ``max_abs_err``, the largest
    max |Δ| of any conserved field in units of that field's largest
    magnitude (the fields' SI scales differ by ten orders)."""
    w = hydro_parity_state(geometry, device)
    u = hydro.conserved_from_primitives(w, gamma)
    cell = (float(geometry.cell_size[0]),) * 3
    walls = {
        "reflective": ((hydro.BC_REFLECTIVE,) * 2,) * 3,
        "periodic/outflow": (
            (hydro.BC_PERIODIC,) * 2, (hydro.BC_OUTFLOW,) * 2, (hydro.BC_PERIODIC,) * 2,
        ),
    }
    worst = 0.0
    timings = {}
    for solver in ("HLLC", "Exact"):
        for wall, boundaries in walls.items():
            wp = hydro.pad_primitives(w, boundaries)
            kwargs = dict(cell_size=cell, gamma=gamma, riemann_solver=solver)
            out_k = hydro.hydro_step_padded(u, wp, dt, **kwargs)
            out_r = hydro.hydro_step_padded_reference(u, wp, dt, **kwargs)
            torch.cuda.synchronize()
            errs = {}
            for name, a, b in zip(out_r._fields, out_r, out_k):
                check(bool(torch.isfinite(b).all()), f"K3 {solver} {wall}: {name} finite")
                errs[name] = float((a - b).abs().max() / a.abs().max())
            moved = float((out_r.energy - u.energy).abs().max() / u.energy.abs().max())
            log(
                f"K3 parity {solver}, {wall} walls, {geometry.shape}, gamma {gamma}: "
                "max |diff| / max |field| "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f" (the step moved the energy by {moved:.3e} of its max)"
            )
            check(moved > 0.0, "the parity step changed the state")
            for name, err in errs.items():
                check(
                    err <= MAX_HYDRO_REL_ERR[solver],
                    f"K3 {solver} {wall} {name}: {err} > {MAX_HYDRO_REL_ERR[solver]}",
                )
            worst = max(worst, *errs.values())  # the JSON's max_abs_err
            if wall == "reflective":  # the main path's walls
                ms = time_cuda(lambda: hydro.hydro_step_padded(u, wp, dt, **kwargs), 50)
                plain_ms = time_cuda(
                    lambda: hydro.hydro_step_padded_reference(u, wp, dt, **kwargs), 5
                )
                log(
                    f"timing K3 {solver} at {geometry.shape}: K3 {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms per step (CUDA events; padding excluded)"
                )
                timings[solver] = (ms, plain_ms)
    ms, plain_ms = timings["HLLC"]
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


# ------------------------------------------------------------- starbench


def starbench_simulation(device) -> RHDSimulation:
    prev = os.getcwd()
    os.chdir(BENCHMARKS)
    try:
        return RHDSimulation.from_params(ParameterFile(STARBENCH_PARAM), device=device, seed=42)
    finally:
        os.chdir(prev)


def starbench_main_path(device) -> dict:
    # warm-up: a throwaway driver takes two steps, so that the timed run
    # does not pay the first use of the path's kernels
    starbench_simulation(device).advance(2)
    sim = starbench_simulation(device)
    cfg = sim.config
    timeline = sim.timeline()  # starbench pins the minimum and maximum step
    n_steps = 1
    while timeline.advance():
        n_steps += 1
    n_cells = sim.geometry.n_cells
    mass0 = float(sim.state.rho.double().sum())

    outputs = []

    def snapshot(s, index):
        outputs.append((index, s.time, s.ionization_front_radius()))

    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, xH = sim.run(snapshot_callback=snapshot)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in ("trace_packets", "hydro_step")}

    log(
        f"starbench main path: {cfg.geometry.shape}, {cfg.nloop} x {cfg.n_photons} packets "
        f"per step, {n_steps} steps to {cfg.total_time / MYR:.4f} Myr in {wall:.4f} s wall, "
        f"warm ({wall / n_steps * 1e3:.4f} ms per step, {n_steps * n_cells / wall:.6g} "
        f"cell-updates/s, {n_steps * cfg.nloop * cfg.n_photons / wall:.6g} packets/s); "
        f"launches {launches}"
    )
    n_h = mass0 / n_cells / constants.PROTON_MASS  # the uniform cloud
    r_st = (3 * cfg.luminosity / (4 * np.pi * n_h**2 * cfg.recombination_rate)) ** (1 / 3)
    log("  t (Myr)   R (pc)  Spitzer   Hos-In  R/Rsp  R/R_JAX")
    for (index, t, r), r_jax in zip(outputs, JAX_STARBENCH_R_PC):
        log(
            f"  {t / MYR:7.4f}  {r / PC:7.3f}  {spitzer_radius(t, r_st) / PC:7.3f}  "
            f"{hosokawa_inutsuka_radius(t, r_st) / PC:7.3f}  "
            f"{r / spitzer_radius(t, r_st):5.3f}  {r / (r_jax * PC):6.4f}"
        )

    check(launches["hydro_step"] == n_steps, f"K3 launches {launches} != {n_steps} steps")
    check(
        launches["trace_packets"] == cfg.nloop * n_steps,
        f"K1 launches {launches} != {cfg.nloop} x {n_steps}",
    )
    check([i for i, _, _ in outputs] == list(range(1, 11)), f"outputs {outputs}")
    for name, f in zip(state._fields, state):
        check(bool(torch.isfinite(f).all()), f"{name} is finite")
    check(bool(torch.isfinite(xH).all()), "xH is finite")
    w = hydro.primitives_from_conserved(state, cfg.gamma)
    check(float(w.p.min()) > 0.0, "pressure > 0")
    drift = float(state.rho.double().sum()) / mass0 - 1.0
    log(f"mass drift over the run: {drift:.3e} (reflective box)")
    check(abs(drift) <= MAX_MASS_DRIFT, f"mass drift {drift}")
    x_host = xH.cpu().numpy()
    c = cfg.geometry.shape[0] // 2
    log(f"xH at the centre {x_host[c, c, c]:.3e}, at the corner {x_host[0, 0, 0]:.6f}")
    check(x_host[c, c, c] < 1e-3 and x_host[0, 0, 0] > 0.99, "ionized centre, neutral corner")
    t_end, r_end = outputs[-1][1], outputs[-1][2]
    lo, hi = 0.85 * spitzer_radius(t_end, r_st), 1.1 * hosokawa_inutsuka_radius(t_end, r_st)
    check(lo < r_end < hi, f"R({t_end / MYR:.4f} Myr) = {r_end / PC:.3f} pc outside "
                           f"({lo / PC:.3f}, {hi / PC:.3f}) pc")
    for (_, t, r), r_jax in zip(outputs, JAX_STARBENCH_R_PC):
        check(abs(r / (r_jax * PC) - 1.0) <= MAX_TRAJECTORY_DEVIATION,
              f"R({t / MYR:.4f} Myr) = {r / PC:.3f} pc vs JAX {r_jax} pc")

    # K1 alone in this regime: the final opacity, a fresh packet batch
    sigma_dx = cfg.cross_section * sim.dx
    chi = (w.rho / constants.PROTON_MASS * xH * sigma_dx).reshape(-1).contiguous()
    px, py, pz, dx, dy, dz, tau, weight = sources.emit_point_source(
        sim.generator, cfg.n_photons, sim._source_gpos)
    packets = traversal.make_packets(
        torch.stack([px, py, pz], 1), torch.stack([dx, dy, dz], 1), tau, weight,
        sim.geometry.shape)
    scratch = torch.zeros_like(chi)
    shape = sim.geometry.shape
    k1_ms = time_cuda(lambda: traversal.trace_packets(chi, packets, scratch, shape=shape), 20)
    k1_plain_ms = time_cuda(
        lambda: traversal.trace_packets_reference(chi, packets, scratch, shape=shape), 3)
    log(
        f"timing K1 in the starbench regime (final state, {shape}, {cfg.n_photons} packets): "
        f"K1 {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms per march (CUDA events)"
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

    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        k1_build = pool.submit(timed_build, "trace_packets")
        k3_build = pool.submit(timed_build, "hydro_step")
        report_build("K1", k1_build)

        config = HOnlyConfig.from_params(ParameterFile(STROMGREN_PARAM))
        small = kernel_parity(config, device, 2**17)
        # the shapes the main path gives K1: 64^3 cells, 1e6 packets
        parity = kernel_parity(config, device, config.n_photons)
        launches = main_path(config)

        report_build("K3", k3_build)
    star = starbench_simulation(device)
    hydro_record = hydro_parity(
        device, star.geometry, star.config.gamma,
        star.timeline().current_timestep,  # the main path's dt
    )
    del star
    star_launches = starbench_main_path(device)

    record = {
        "name": "trace_packets",
        "route": "cuda",
        "source": "cmacionize_torch/csrc/trace_packets.cu",
        "replaces": "cmacionize_tpu/ops/traversal.py:115",
        "launches": launches + star_launches["trace_packets"],
        **parity,
        "max_abs_err": max(small["max_abs_err"], parity["max_abs_err"]),
    }
    hydro_kernel = {
        "name": "hydro_step",
        "route": "cuda",
        "source": "cmacionize_torch/csrc/hydro_step.cu",
        "replaces": "cmacionize_tpu/ops/hydro.py:353",
        "launches": star_launches["hydro_step"],
        **hydro_record,
    }
    print(json.dumps({"kernels": [record, hydro_kernel]}), flush=True)
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
