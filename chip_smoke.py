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
   this (opaque) regime;
8. build: K2 (``cmacionize_torch/csrc/trace_packets_spectral.cu``) and K4
   (``cmacionize_torch/csrc/temperature.cu``), started with K1 and K3, their
   seconds and ``ptxas -v`` reports;
9. K2 parity: the spectral march against its plain PyTorch version on the
   card, on a 64³ lexington-like state made with numpy from a fixed seed
   (χ_H, χ_He, 1e6 packets from the centre in Planck-sampled bins): flags,
   positions, the binned tally and the ion integrals (also against an f64
   product), both timed;
10. main path: ``benchmarks/lexingtonHII20.param`` at the archived budget
    (32³, 1e6 packets × 10 iterations) through ParameterFile →
    MultiFreqConfig.from_params → MultiFreqIonizationSimulation(...,
    device="cuda").run(), with the H front radius against the JAX package's
    archived 9.223e16 m;
11. main path: ``benchmarks/lexingtonHII20.param`` at full size (64³, 1e6
    packets × 20 iterations, 128 bins, 8 re-emission generations, the
    temperature balance from iteration 3 on), timed per phase, with the K2
    and K4 launch counts, the re-emitted packets, the secant sweeps and the
    physical bands of the Lexington HII20 benchmark;
12. K4 parity: the temperature balance against its plain PyTorch version on
    the card, on the inputs the full-size run handed to its fourth
    temperature solve (all cells), both timed;
13. main path: ``benchmarks/stromgren_diffuse.param`` at full size (64³, 1e6
    packets × 20 iterations, FixedValue σ/α, re-emission, K2 only), with the
    H front radius against the archived 1.617e17 m.

The line before the last is a JSON object with the kernels' results; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
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
from cmacionize_torch.models import ions, multifreq_simulation, reemission, sources
from cmacionize_torch.models.density_functions import density_function_from_params
from cmacionize_torch.models.ionization_simulation import (
    HOnlyConfig,
    HOnlyIonizationSimulation,
)
from cmacionize_torch.models.multifreq_simulation import (
    MultiFreqConfig,
    MultiFreqIonizationSimulation,
)
from cmacionize_torch.models.rhd_simulation import (
    RHDSimulation,
    hosokawa_inutsuka_radius,
    spitzer_radius,
)
from cmacionize_torch.ops import hydro, recombination, temperature, traversal
from cmacionize_torch.utils.params import ParameterFile

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCHMARKS = os.path.join(ROOT, "benchmarks")
STROMGREN_PARAM = os.path.join(BENCHMARKS, "stromgren.param")
STARBENCH_PARAM = "starbench.param"  # opened from BENCHMARKS, like its .yml
LEXINGTON_PARAM = "lexingtonHII20.param"  # opened from BENCHMARKS, like its .yml
DIFFUSE_PARAM = os.path.join(BENCHMARKS, "stromgren_diffuse.param")
# the kernels each build phase compiles, all started together
KERNEL_SOURCES = {
    "K1": "trace_packets", "K3": "hydro_step",
    "K2": "trace_packets_spectral", "K4": "temperature",
}
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
# K2 against its plain version: the tolerances of K1, and the ion integrals'
# f32 product against an f64 product of the same tally (a TF32 product would
# be off by ~1e-3)
MAX_INTEGRAL_REL_L1 = 1e-5
# K4 against its plain version, per cell: both run the same f64 operations,
# but libdevice's exp/log/pow and torch's CUDA ones may differ in the last
# bit, which the branchy secant can turn into another freeze sweep
MIN_T_MATCH_FRACTION = 0.99
T_MATCH_REL = 1e-9
MAX_T_REL_ERR = 5e-3
# H front radii (the estimator of benchmarks/compare_reference.py) of the JAX
# package's archived runs (benchmarks/RESULTS.md) and the allowed deviation
JAX_LEXINGTON_FRONT_M = 9.223e16  # lexingtonHII20 at 32³ / 1e6 × 10
JAX_DIFFUSE_FRONT_M = 1.617e17  # stromgren_diffuse at full size
MAX_FRONT_DEVIATION = 0.04
# Lexington HII20 bands (tests/test_lexington.py, benchmarks/run_lexington.py)
INTERIOR_T_BAND = (6000.0, 8300.0)
STROMGREN_RATIO_BAND = (0.85, 1.15)


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


# ------------------------------------------------------------- K2 and K4


def lexington_simulation(device, **overrides) -> MultiFreqIonizationSimulation:
    """lexingtonHII20.param through the entry point (the BlockSyntax cavity
    and its initial temperature), with ``overrides`` of the configuration
    (a ``shape`` replaces the grid's)."""
    prev = os.getcwd()
    os.chdir(BENCHMARKS)
    try:
        params = ParameterFile(LEXINGTON_PARAM)
        config = MultiFreqConfig.from_params(params)
        if "shape" in overrides:
            geometry = dataclasses.replace(config.geometry, shape=overrides.pop("shape"))
            config = dataclasses.replace(config, geometry=geometry)
        config = dataclasses.replace(config, **overrides)
        df = density_function_from_params(params, config.geometry)
    finally:
        os.chdir(prev)
    return MultiFreqIonizationSimulation(
        config, density=df.number_density, initial_temperature=df.temperature,
        seed=42, device=device)


def front_radius(r, x, level=0.5, n=None):
    """The radius of the first crossing of ``level`` by the radially binned
    profile of x (48 bins), over cells with gas: the estimator of
    benchmarks/compare_reference.py, copied."""
    sel = np.ones(r.shape, bool) if n is None else (n > 0)
    order = np.argsort(r[sel])
    rs, xs = r[sel][order], np.clip(x[sel][order], 0.0, 1.0)
    nb = 48
    edges = np.linspace(0, rs.max(), nb + 1)
    prof = np.array([
        xs[(rs >= e0) & (rs < e1)].mean() if ((rs >= e0) & (rs < e1)).any() else np.nan
        for e0, e1 in zip(edges[:-1], edges[1:])
    ])
    mid = 0.5 * (edges[:-1] + edges[1:])
    ok = np.isfinite(prof)
    above = np.where(prof[ok] > level)[0]
    if len(above) == 0:
        return mid[ok][-1]
    return mid[ok][above[0]]


def spectral_parity_inputs(sim: MultiFreqIonizationSimulation, n_packets: int, device):
    """A lexington-like state on sim's 64³ grid, made with numpy: 100 cm⁻³
    gas around the 0.97 pc cavity, H ionized (x_H 1e-4..1e-3) out to 2.9 pc
    and He (x_He 1e-3..1e-2) out to 2 pc, neutral beyond, with a fully
    ionized cone along +z through which packets escape; packets from the
    centre in bins drawn from the 20 kK Planck spectrum over sim's bins."""
    rng = np.random.default_rng(PARITY_SEED)
    geom = sim.geometry
    centers = geom.cell_centers().reshape(-1, 3)
    r = np.sqrt((centers**2).sum(-1))
    cone = centers[:, 2] > r * np.cos(np.radians(20.0))
    nd = np.where(r < 3.0e16, 0.0, 1e8)
    xH = np.where(r < 2.9 * PC, rng.uniform(1e-4, 1e-3, r.shape), 1.0)
    xHe = np.where(r < 2.0 * PC, rng.uniform(1e-3, 1e-2, r.shape), 1.0)
    xH, xHe = np.where(cone, 1e-6, xH), np.where(cone, 1e-6, xHe)
    chi_h = nd * xH * sim.dx
    chi_he = nd * sim.config.abundances["He"] * xHe * sim.dx

    pdf = sources.planck_bin_pdf(sim.bin_centers, 20000.0)
    fbin = rng.choice(sim.config.n_bins, size=n_packets, p=pdf / pdf.sum())
    cos_t = rng.uniform(-1.0, 1.0, n_packets)
    phi = rng.uniform(0.0, 2.0 * np.pi, n_packets)
    sin_t = np.sqrt(1.0 - cos_t**2)
    direction = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], 1)
    centre = np.asarray(geom.shape, np.float64) / 2.0
    position = centre[None, :] + 1e-4 * direction
    tau = -np.log1p(-rng.uniform(0.0, 1.0, n_packets))

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    packets = traversal.make_spectral_packets(
        f32(position), f32(direction), f32(tau), torch.ones(n_packets, device=device),
        f32(sim.sigma_table[ions.ION_H_n][fbin]), f32(sim.sigma_table[ions.ION_He_n][fbin]),
        torch.tensor(fbin, dtype=torch.int32, device=device), geom.shape,
    )
    return f32(chi_h), f32(chi_he), packets


def spectral_parity(device) -> dict:
    """K2 against trace_packets_spectral_reference on the card; both timed."""
    sim = lexington_simulation(device)
    shape, n_bins, ncell = sim.geometry.shape, sim.config.n_bins, sim.geometry.n_cells
    chi_h, chi_he, packets = spectral_parity_inputs(sim, sim.config.n_photons, device)
    zeros = torch.zeros(n_bins * ncell, dtype=torch.float32, device=device)
    march = dict(shape=shape, n_bins=n_bins)
    tally_k, out_k = traversal.trace_packets_spectral(
        chi_h, chi_he, packets, zeros.clone(), **march)
    tally_r, out_r = traversal.trace_packets_spectral_reference(
        chi_h, chi_he, packets, zeros.clone(), **march)
    torch.cuda.synchronize()

    n = packets.size
    flag_mismatch = int(
        ((out_k.absorbed != out_r.absorbed) | (out_k.active != out_r.active)).sum())
    cell_mismatch = int(
        ((out_k.cx != out_r.cx) | (out_k.cy != out_r.cy) | (out_k.cz != out_r.cz)).sum())
    pos_diff = max(
        float((getattr(out_k, f) - getattr(out_r, f)).abs().max()) for f in ("px", "py", "pz"))
    tally_abs = (tally_k - tally_r).abs()
    tally_rel_l1 = float(tally_abs.sum() / tally_r.abs().sum())

    def rel_l1(a, b):  # the worst row of [n_ion + 2, ncell] integrals
        a, b = a.double(), b.double()
        return float(((a - b).abs().sum(1) / b.abs().sum(1).clamp_min(1e-300)).max())

    weights = (sim._sigma_table32, sim._heating32)
    ions_k = traversal.spectral_tallies_to_ion_integrals(tally_k, *weights, ncell)
    ions_r = traversal.spectral_tallies_to_ion_integrals(tally_r, *weights, ncell)
    ions64 = torch.cat(weights).double() @ tally_k.double().reshape(n_bins, ncell)
    integral_kr, integral_64 = rel_l1(ions_k, ions_r), rel_l1(ions_k, ions64)
    n_absorbed = int(out_r.absorbed.sum())
    log(
        f"K2 parity: {shape}, {n_bins} bins, {n} packets, {n_absorbed} absorbed / "
        f"{n - n_absorbed} escaped (plain); flag mismatches {flag_mismatch}, cell "
        f"mismatches {cell_mismatch}, max |position diff| {pos_diff:.3e} cells, tally rel "
        f"L1 {tally_rel_l1:.3e}, max |tally diff| {float(tally_abs.max()):.3e}; ion "
        f"integrals rel L1 (worst row) K2 vs plain {integral_kr:.3e}, f32 product vs f64 "
        f"product {integral_64:.3e}"
    )
    check(0 < n_absorbed < n, "K2 parity input has both absorbed and escaping packets")
    check(flag_mismatch <= MAX_FLAG_MISMATCH_FRACTION * n,
          f"K2 flag mismatches {flag_mismatch} > {MAX_FLAG_MISMATCH_FRACTION} of {n}")
    check(pos_diff <= MAX_POSITION_DIFF, f"K2 position diff {pos_diff} > {MAX_POSITION_DIFF}")
    check(tally_rel_l1 <= MAX_TALLY_REL_L1, f"K2 tally rel L1 {tally_rel_l1}")
    check(integral_kr <= MAX_TALLY_REL_L1, f"K2 ion integrals vs plain {integral_kr}")
    check(integral_64 <= MAX_INTEGRAL_REL_L1, f"ion integrals vs f64 product {integral_64}")

    scratch = zeros.clone()
    ms = time_cuda(
        lambda: traversal.trace_packets_spectral(chi_h, chi_he, packets, scratch, **march), 20)
    plain_ms = time_cuda(
        lambda: traversal.trace_packets_spectral_reference(
            chi_h, chi_he, packets, scratch, **march), 3)
    log(
        f"timing K2 at {shape} / {n_bins} bins / {n} packets: K2 {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms per march (CUDA events, incl. the packet-state copy)"
    )
    return {"max_abs_err": float(tally_abs.max()), "ms": ms, "plain_ms": plain_ms}


def run_multifreq(sim: MultiFreqIonizationSimulation, label: str):
    """Run ``sim`` with the launch counts set to 0 just before; returns
    (xion, T, wall seconds, {kernel: launches})."""
    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xion, T = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in ("trace_packets_spectral", "temperature")}
    cfg = sim.config
    transport = sum(t for t, _ in sim.phase_seconds)
    solve = sum(s for _, s in sim.phase_seconds)
    log(
        f"{label}: {sim.geometry.shape}, {cfg.n_photons} packets x {cfg.n_iterations} "
        f"iterations, {cfg.n_bins} bins, {cfg.n_reemission_rounds if cfg.diffuse_field else 0} "
        f"re-emission generations, in {wall:.4f} s wall ({transport:.4f} s transport, "
        f"{solve:.4f} s solve; {cfg.n_photons * cfg.n_iterations / wall:.6g} source "
        f"packets/s); launches {launches}"
    )
    marches = cfg.n_iterations * (1 + (cfg.n_reemission_rounds if cfg.diffuse_field else 0))
    solves = (max(cfg.n_iterations - cfg.minimum_iteration_number, 0)
              if cfg.do_temperature else 0)
    check(launches["trace_packets_spectral"] == marches,
          f"{label}: K2 launches {launches} != {marches}")
    check(launches["temperature"] == solves, f"{label}: K4 launches {launches} != {solves}")
    for name, value in {"T": T, **xion}.items():
        check(tuple(value.shape) == tuple(sim.geometry.shape), f"{label}: {name} shape")
        check(bool(torch.isfinite(value).all()), f"{label}: {name} is finite")
    return xion, T, wall, launches


def lexington_archived(device) -> int:
    """lexingtonHII20 at the archived 32³ / 1e6 × 10 budget: the H front
    radius against the JAX package's."""
    sim = lexington_simulation(device, shape=(32, 32, 32), n_iterations=10)
    xion, _, _, launches = run_multifreq(sim, "lexingtonHII20 at 32^3")
    r = np.sqrt((sim.geometry.cell_centers() ** 2).sum(-1))
    nd = sim.number_density.cpu().numpy()
    front = front_radius(r, xion["H_n"].cpu().numpy(), n=nd)
    log(f"  H front radius {front:.4e} m, JAX archived {JAX_LEXINGTON_FRONT_M:.4e} m, "
        f"ratio {front / JAX_LEXINGTON_FRONT_M:.4f}")
    check(abs(front / JAX_LEXINGTON_FRONT_M - 1.0) <= MAX_FRONT_DEVIATION,
          f"lexingtonHII20 32^3 front {front} vs {JAX_LEXINGTON_FRONT_M}")
    return launches


def lexington_full(device):
    """lexingtonHII20 at full size, with the inputs of its fourth temperature
    solve kept for K4's parity phase."""
    captured = []
    solve = multifreq_simulation.temperature.solve_temperature

    def capturing_solve(T_prev, j, h, nd, abundances, **kwargs):
        if len(captured) == 3:  # keep what the fourth solve is handed
            captured.append((T_prev.clone(), {k: v.clone() for k, v in j.items()},
                             (h[0].clone(), h[1].clone()), nd.clone(), dict(abundances), kwargs))
        else:
            captured.append(None)
        return solve(T_prev, j, h, nd, abundances, **kwargs)

    sim = lexington_simulation(device)
    multifreq_simulation.temperature.solve_temperature = capturing_solve
    try:
        xion, T, wall, launches = run_multifreq(sim, "lexingtonHII20 at full size")
    finally:
        multifreq_simulation.temperature.solve_temperature = solve
    cfg = sim.config
    log("  per iteration: transport s, solve s, re-emitted packets per generation")
    for k, ((t_tr, t_sv), counts) in enumerate(zip(sim.phase_seconds, sim.reemitted)):
        log(f"  {k + 1:2d}  {t_tr:.4f}  {t_sv:.4f}  {counts.tolist()}")
    sweeps = [(int(s.max()), float(s.double().mean())) for s in sim.sweeps]
    log(f"  secant sweeps per temperature solve (max, mean over cells): {sweeps}")

    geom = sim.geometry
    r = np.sqrt((geom.cell_centers() ** 2).sum(-1))
    nd = sim.number_density.cpu().numpy()
    T = T.cpu().numpy()
    x = {name: value.cpu().numpy() for name, value in xion.items()}

    def shell(lo, hi):
        return (r > lo * PC) & (r < hi * PC) & (nd > 0)

    T_shell = float(T[shell(1.0, 2.0)].mean())
    xH_med = float(np.median(x["H_n"][shell(1.0, 2.5)]))
    vol_H, vol_He = int((x["H_n"] < 0.5).sum()), int((x["He_n"] < 0.5).sum())
    o_p = float(np.median(x["O_n"][shell(1.0, 2.0)]))
    o_pp = float(np.median(x["O_p1"][shell(1.0, 2.0)]))
    # the cavity holds no gas: it counts into the ionized volume, and into
    # the Strömgren volume, as it does in the JAX package's runs
    n_cavity = int((nd <= 0).sum())
    r_ion = (3 * (vol_H + n_cavity) * geom.cell_volume / (4 * np.pi)) ** (1 / 3)
    far = r > 1.2 * r_ion
    xH_far = float(np.median(x["H_n"][far]))
    T_in = float(T[(r < 0.8 * r_ion) & (nd > 0)].mean())
    n_h = float(nd.max())

    def stromgren(alpha):
        return (3 * (n_cavity * geom.cell_volume + cfg.luminosity / (n_h**2 * alpha))
                / (4 * np.pi)) ** (1 / 3)

    # benchmarks/run_lexington.py takes the total (case A) rate.  With the
    # diffuse field on, a fraction p_H of the recombinations goes to the
    # ground state and is re-emitted as an ionizing packet, so the run's
    # front sits where the other recombinations (case B) balance the source:
    # that is the radius checked, with p_H of the port's re-emission model
    alpha_a = float(recombination.recombination_rate("H_n", T_in))
    p_h = float(reemission.reemission_probabilities(torch.tensor(T_in, dtype=torch.float64))[0])
    r_st_a, r_st = stromgren(alpha_a), stromgren(alpha_a * (1.0 - p_h))
    front = front_radius(r, x["H_n"], n=nd)
    log(
        f"  T in 1-2 pc {T_shell:.1f} K; median xH in 1-2.5 pc {xH_med:.3e}; cells "
        f"xH<0.5 {vol_H}, xHe<0.5 {vol_He}; median O+ {o_p:.4f}, O++ {o_pp:.3e} in 1-2 pc; "
        f"median xH beyond 1.2 r_ion {xH_far:.4f}; r_ion {r_ion / PC:.3f} pc; at "
        f"T_in = {T_in:.0f} K r_Stromgren {r_st / PC:.3f} pc (ratio {r_ion / r_st:.4f}) with "
        f"case B = (1 - p_H) alpha_A, {r_st_a / PC:.3f} pc (ratio {r_ion / r_st_a:.4f}) with "
        f"alpha_A; H front radius {front:.4e} m"
    )
    check(INTERIOR_T_BAND[0] < T_shell < INTERIOR_T_BAND[1], f"interior T {T_shell}")
    check(xH_med < 3e-3, f"median xH in 1-2.5 pc {xH_med}")
    check(vol_He <= 1.05 * vol_H, f"He front outside the H front: {vol_He} > {vol_H}")
    check(o_p > 0.9 and o_pp < 0.1, f"O+ {o_p}, O++ {o_pp}")
    check(xH_far > 0.9, f"exterior median xH {xH_far}")
    check(STROMGREN_RATIO_BAND[0] < r_ion / r_st < STROMGREN_RATIO_BAND[1],
          f"r_ion / r_Stromgren {r_ion / r_st}")
    check(len(captured) == len(sim.sweeps) > 3 and captured[3] is not None,
          f"the run made {len(captured)} temperature solves")
    return launches, captured[3]


def temperature_parity(solve_inputs) -> dict:
    """K4 against solve_temperature_reference on the card, on every cell of
    the full-size run's fourth temperature solve; both timed."""
    T_prev, j, h, nd, abundances, kwargs = solve_inputs
    got = temperature.solve_temperature(T_prev, j, h, nd, abundances, **kwargs)
    ref = temperature.solve_temperature_reference(T_prev, j, h, nd, abundances, **kwargs)
    torch.cuda.synchronize()

    def diff(a, b, scale=1.0):  # |a - b| / scale: 0 where both are NaN, inf where one is
        both = torch.isnan(a) & torch.isnan(b)
        d = torch.where(both, 0.0, (a - b).abs() / scale)
        return torch.nan_to_num(d, nan=float("inf"))

    rel = diff(got.T, ref.T, ref.T.abs())
    match = float((rel <= T_MATCH_REL).double().mean())
    max_rel = float(rel.max())
    state = {"h0": float(diff(got.h0, ref.h0).max()), "he0": float(diff(got.he0, ref.he0).max())}
    state["metals"] = max(float(diff(got.metals[k], ref.metals[k]).max()) for k in ref.metals)
    same_sweeps = float((got.sweeps == ref.sweeps).double().mean())
    log(
        f"K4 parity: {T_prev.numel()} cells of the fourth solve, "
        f"{int((nd <= 0).sum())} without gas: {match:.6f} of cells within {T_MATCH_REL} "
        f"relative in T, max |dT|/T {max_rel:.3e}, max |d| h0 {state['h0']:.3e}, he0 "
        f"{state['he0']:.3e}, metals {state['metals']:.3e}; same sweep count in "
        f"{same_sweeps:.6f} of cells (max {int(ref.sweeps.max())}, mean "
        f"{float(ref.sweeps.double().mean()):.2f})"
    )
    check(match >= MIN_T_MATCH_FRACTION, f"K4: {match} of cells match, < {MIN_T_MATCH_FRACTION}")
    check(max_rel <= MAX_T_REL_ERR, f"K4: max |dT|/T {max_rel} > {MAX_T_REL_ERR}")

    ms = time_cuda(lambda: temperature.solve_temperature(T_prev, j, h, nd, abundances,
                                                         **kwargs), 3)
    plain_ms = time_cuda(lambda: temperature.solve_temperature_reference(
        T_prev, j, h, nd, abundances, **kwargs), 1)
    log(f"timing K4 on {T_prev.numel()} cells: K4 {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"per solve (CUDA events)")
    return {"max_abs_err": float(diff(got.T, ref.T).max()), "ms": ms, "plain_ms": plain_ms}


def stromgren_diffuse(device) -> dict:
    """stromgren_diffuse.param at full size: the H front radius against the
    JAX package's archived one."""
    config = MultiFreqConfig.from_params(ParameterFile(DIFFUSE_PARAM))
    sim = MultiFreqIonizationSimulation(config, seed=42, device=device)
    xion, _, _, launches = run_multifreq(sim, "stromgren_diffuse at full size")
    r = np.sqrt((sim.geometry.cell_centers() ** 2).sum(-1))
    front = front_radius(r, xion["H_n"].cpu().numpy(), n=sim.number_density.cpu().numpy())
    log(f"  H front radius {front:.4e} m, JAX archived {JAX_DIFFUSE_FRONT_M:.4e} m, "
        f"ratio {front / JAX_DIFFUSE_FRONT_M:.4f}; re-emitted in the last iteration "
        f"{sim.reemitted[-1].tolist()}")
    check(abs(front / JAX_DIFFUSE_FRONT_M - 1.0) <= MAX_FRONT_DEVIATION,
          f"stromgren_diffuse front {front} vs {JAX_DIFFUSE_FRONT_M}")
    return launches


def main() -> None:
    device = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    log(f"card: {smi.stdout.strip()}")
    log(f"device: {describe(device)}, python {sys.version.split()[0]}")

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(KERNEL_SOURCES)) as pool:
        builds = {label: pool.submit(timed_build, name) for label, name in KERNEL_SOURCES.items()}
        report_build("K1", builds["K1"])

        config = HOnlyConfig.from_params(ParameterFile(STROMGREN_PARAM))
        small = kernel_parity(config, device, 2**17)
        # the shapes the main path gives K1: 64^3 cells, 1e6 packets
        parity = kernel_parity(config, device, config.n_photons)
        launches = main_path(config)

        report_build("K3", builds["K3"])
        star = starbench_simulation(device)
        hydro_record = hydro_parity(
            device, star.geometry, star.config.gamma,
            star.timeline().current_timestep,  # the main path's dt
        )
        del star
        star_launches = starbench_main_path(device)

        report_build("K2", builds["K2"])
        report_build("K4", builds["K4"])
    spectral_record = spectral_parity(device)
    multifreq_launches = [lexington_archived(device)]
    full_launches, solve_inputs = lexington_full(device)
    multifreq_launches.append(full_launches)
    temperature_record = temperature_parity(solve_inputs)
    del solve_inputs
    multifreq_launches.append(stromgren_diffuse(device))

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
    spectral_kernel = {
        "name": "trace_packets_spectral",
        "route": "cuda",
        "source": "cmacionize_torch/csrc/trace_packets_spectral.cu",
        "replaces": "cmacionize_tpu/ops/traversal.py:503",
        "launches": sum(run["trace_packets_spectral"] for run in multifreq_launches),
        **spectral_record,
    }
    temperature_kernel = {
        "name": "temperature",
        "route": "cuda",
        "source": "cmacionize_torch/csrc/temperature.cu",
        "replaces": "cmacionize_tpu/ops/temperature.py:283",
        "launches": sum(run["temperature"] for run in multifreq_launches),
        **temperature_record,
    }
    kernel_records = [record, spectral_kernel, hydro_kernel, temperature_kernel]
    print(json.dumps({"kernels": kernel_records}), flush=True)
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
