"""Drive the port's main path once on one CUDA card and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero):

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles K1 (``cmacionize_torch/csrc/trace_packets.cu``) with nvcc,
   while the builds of K2-K7, K5, K5s, K8, K8p, K9 (K9c and K9p, one
   library), K10, K11 (K11 and K11r, one library), K12 (K12t, K12r, K12s
   and K12a, one library), K13 (K13h, K13e, K13w and K13f, one library) and
   K14 (K14a, K14b and K14c, one library) run beside it (one nvcc per source,
   all started together), and two spawned worker processes build
   the Voronoi grids of phases 14 and 19 and the AMR grids of phase 21 on the
   host;
3. kernel parity: K1 against its plain PyTorch version on the card, on the
   same inputs made with numpy from a fixed seed (a 64³ Strömgren-like
   opacity with an ionized cone; 2^17 packets from the centre, then the
   main path's 1e6): no flag or cell mismatch, identical positions and
   tau_left, the tally against the plain march summed in f64; both timed,
   with K1's registers and blocks per SM;
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
   Hosokawa-Inutsuka band and the JAX package's trajectory; then K1 against
   its plain version in this (opaque) regime, on the final state and a
   fresh batch (as in phase 3), and 16 more steps under torch.profiler;
8. build: K2, K4 (with K4f), K6, K6s, K7, K5 (with K5d), K5s, K8, K8p, K9,
   K10, K11, K12, K13 and K14 (``cmacionize_torch/csrc/{trace_packets_spectral,
   temperature,trace_voronoi,trace_voronoi_spectral,voronoi_flux,
   trace_octree,trace_octree_spectral,peel_off,peel_off_polarized,compact,
   trace_packets_cone,gather,probe_gather,probe_deposit,probe_cohort}.cu``),
   their seconds and ``ptxas -v`` reports;
9. K2 parity (once the AMR grids of phase 21 have arrived from their worker,
   so that their transfer does not load the host during the timed phases):
   the spectral march against its plain PyTorch version on the card, on a 64³ lexington-like state made with numpy from a fixed seed
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
    temperature solve (all cells), both timed, with K4's layout (registers,
    stack and spills from the build's ptxas report, blocks per SM, the lanes
    a cell) and the share of lanes one thread a cell would keep busy on the
    plain version's sweeps (as in 12b and the multi-frequency Voronoi and
    AMR runs' last solves);
12a. main path: the same full-size lexingtonHII20 run with
    ``TemperatureCalculator: backend: f32-device`` set on the parsed
    parameters (the same seed), so that every temperature solve launches
    K4f: the K2 and K4f launch counts, the per-iteration split, the sweeps,
    every Lexington band, and the final state against the f64 run's with the
    bands of tests/test_multifreq.py:151-162; after each of the two
    full-size runs, one more iteration under torch.profiler;
12b. K4f parity: the f32 balance against its plain version on the inputs of
    that run's fourth solve (all 262144 cells), both timed, and K4 timed on
    the same cells widened to f64;
13. main path: ``benchmarks/stromgren_diffuse.param`` at full size (64³, 1e6
    packets × 20 iterations, FixedValue σ/α, re-emission, K2 only), with the
    H front radius against the archived 1.617e17 m;
14. grid: the starbench_voronoi tessellation exactly as
    ``benchmarks/run_starbench_voronoi.py:32-45`` builds it (40000
    UniformRandom generators from seed 42, 2 Lloyd iterations), its cells,
    faces per row and host seconds;
15. K6 parity on that grid: the face-plane march against its plain version
    on the card (an ionized sphere of 0.5 pc in the 3.113e9 m⁻³ gas with an
    escape cone, 5e5 packets from the source, made with numpy from the
    seed): no flag or cell mismatch, identical positions and tau_left, the
    tally against the plain march summed in f64; both timed, with K6's
    registers and blocks per SM;
16. main path: HOnlyVoronoiSimulation on the same grid (starbench_voronoi's
    gas, source and microphysics, 5e5 packets × 20 iterations), the ionized
    volume against the Strömgren volume;
17. K7 parity on the same grid: the moving-face Godunov update against its
    plain version (a hot rarefied interior, a dense shell, random
    velocities), second and first order: trial flags, each field and
    whether every field and gradient is bit for bit, the share of cells
    with non-zero density and pressure gradients and of the real faces that
    touch a flagged cell; both timed, K7 also by kernel, with its four
    kernels' registers, spills and blocks a SM, and its bound over the real
    faces beside the old one over all K slots;
18. main path: starbench_voronoi at full size (5e5 × 10 packets per step,
    1024 steps, static mesh, second order) through VoronoiRHDSimulation.run,
    timed, with the K6 and K7 launch counts, the front radius at ten outputs
    against Spitzer / Hosokawa-Inutsuka, the band of
    run_starbench_voronoi.py:83-85 and the mass drift; then 16 more steps
    under torch.profiler (device time by kernel, launches and mean time a
    launch, idle share), and K6 against its plain version on the last march
    of one more step (the final χ, long marches), as in phase 15;
19. main path: MultiFreqVoronoiSimulation (tests/test_multifreq_grids.py's
    configuration at 12000 generators, 1 Lloyd iteration, cut from a
    64³-equivalent grid; 1e6 packets × 10 iterations, 64 bins, 4 re-emission
    generations, the temperature balance), its structure checks and the K6s
    and K4 launch counts;
20. K6s parity: the spectral face-plane march against its plain version on
    the inputs of that run's first and last source marches: flags,
    positions, tally, ion integrals; both timed; then K4 against its plain
    version on the inputs of that run's last temperature solve, both timed;
21. grids: the two AMR hierarchies and their octree tables, built on the
    host in a worker process: leaves per level, whether the dense owner map
    was left out (``owner is None``: the octree path), host seconds;
22. main path: stromgren_amr, ``benchmarks/stromgren.param``'s box, gas,
    source, FixedValue σ/α and 20 iterations, with 1.6e7 packets each, on a
    64³ coarse grid with the zone [-2.5 pc, 2.5 pc)³ refined to level 3
    (17,006,592 leaves, a 512³ finest lattice) through AMRIonizationSimulation(..., device="cuda").run,
    timed, with K5's launch count, the packets still active at the step cap
    per iteration, the ionized volume against the Strömgren volume and the
    50%-crossing radius over the leaf centers against the analytic one; then
    2 more iterations under torch.profiler;
23. K5 parity: the octree march against its plain version on the card, on
    that run's final χ and 1.6e7 fresh packets from the source: flags,
    positions, tally, and the count of packets active at the step cap
    (equal); the plain version's fixed points and no-op steps, its steps per
    packet, warp and block (``tools/octree_study.py:march_study``), K5's
    registers and resident blocks per SM; both timed, and K5's bound with
    and without the no-op steps;
24. main path: MultiFreqAMRSimulation on tests/test_multifreq_grids.py:40-72's
    box, gas, abundances, source and zone at tests/test_amr.py:438-470's
    depth (16³ coarse, level 5: 2,101,184 leaves), 8e6 packets × 10
    iterations, 64 bins, 4 re-emission generations, the temperature balance:
    its structure checks and the K5s, K5d and K4 launch counts, the
    transport / solve split, and the run's last temperature solve (K4 and
    its wrapper) timed by CUDA events around the run's own call, beside K4's
    bound from that solve's sweeps; then one more iteration under
    torch.profiler (K4's own time);
25. K5s parity on the inputs of that run's first and last source marches:
    every packet's final state identical, tally, ion integrals; the plain
    version's fixed points and no-op steps (``march_study``), K5s's
    registers, stack, spills and resident blocks per SM, its bound with and
    without the no-op steps, and its time on the last iteration's first
    re-emission generation; K5d against its plain version on the last
    generation's absorption sites (identical leaf ids); all timed;
26. main path: dusty_galaxy (models/dusty_galaxy.py's DUSTY_GALAXY_PARAMS,
    built in code with the CLI's keys: 201³ cells, 5e5 photons, 12 orders, a 200 × 200 CCD, θ =
    89.7°) through ParameterFile → dust_config_from_params →
    DustSimulation(config, device="cuda").run(), cold and warm, with the
    scattering events per order, the K1 and K8 launch counts, and the image
    against the JAX package's (tests/torch_dust_reference.npz) by
    correlation, flux centroid, radial profile and total flux; then one run
    under torch.profiler and one whose peel-off inputs are kept;
27. main path: the same configuration through run_polarized(), with I
    against the JAX I plane, the image-integrated Q/I and U/I against the
    JAX seeds and |V| ≤ 1e-8 max I; a profiled run and a kept one;
28. K8 parity on phase 26's emission and last-order peel-off inputs, K8p
    parity on phase 27's first and last orders: identical τ and pixels, the
    images' relative L1; all timed;
29. main path: ``benchmarks/stromgren.param`` at full size through
    ShardedHOnlyIonizationSimulation(config, tiling=(2, 2, 2)): eight tiles,
    every shard on the one card, so that all three exchange axes are used;
    timed, with the K1, K9c and K9p launch counts, the supersteps, zero
    overflow and truncation, the radius ratio and the ionized volume against
    phase 4's;
30. main path: ``benchmarks/starbench.param`` at full width, run to 0.3 of
    its total time (615 of 2048 steps: the depth cut, see
    SHARDED_STARBENCH_FRACTION), through
    ShardedRHDSimulation.from_params(..., tiling=(4, 1, 1)).run():
    timed, with the K1, K3, K9c and K9p launch counts, the supersteps per
    step (one host read of the live count each), zero overflow and
    truncation, the mass drift, R(t) at the three outputs reached against
    phase 7's and the band; then one step under torch.profiler;
31. K9p and K9c parity: on the copy-phase compactions, the sends (exits
    and pending lanes) and the merges (the two received buffers as K9c's
    segments) of every slab in the first superstep of one more phase-30
    step, and on every shard of phase 29's first exchange (K9c on its three
    segments): identical lanes, bits and counts to compact_reference of the
    concatenation; K9c and K9p timed at the starbench shapes, K9c (a) back
    to back, (b) on the device alone and (c) its host µs per call beside a
    stable argsort and a gather, K9p on every slab's send and with its host
    µs per call; the shapes of every K9p call of that step, their mean
    bound, and K9p's time a launch in phase 30's profiled step;
32. main path: the cone-marched Strömgren path at full width:
    ``benchmarks/stromgren.param``'s 64³ geometry, gas, source, σ and α
    (HOnlyConfig, as in phase 4), 20 iterations of 2^20 stratified packets
    (``tools.experimental_emission_octa.emit_point_source_stratified`` →
    ``pack_packets`` → K10 → the lanes still at state 0 through K1 → the
    tally scaled as ``_h_only_iteration_body`` scales it → the H balance),
    written here as the JAX package has no such driver option; warm, timed,
    with the K10 and K1 launch counts, the stragglers per iteration, the
    radius ratio and the ionized cells against phase 4's; then 2 iterations
    under torch.profiler;
33. K10 parity on a fully neutral χ (x = 1: the absorption branch in every
    chunk) and on phase 32's final χ, on every lane of a fresh 2^20
    stratified batch: states, positions, tally against the plain version
    on the card, and K10 + the K1 finish against K1 alone (tally, absorbed
    counts); K10 timed beside K1 on the same packets, K1 on those packets
    in a random order (the same work without the direction coherence) and
    the plain version;
34. the scatter/gather microbenchmark (``cmacionize_torch.tools.
    microbench_scatter.main()``) at the tool's sizes (2^20 indices, 64³
    table), its launch counts of K11 and K11r; then K11 and K11r against
    their plain versions (identical) and timed beside ``tbl[idx]`` and
    ``tbl2[rows, lanes]``; K11 (on ``kernels/launch.py``) with one launch per
    call, on a side stream and after two replays of a CUDA graph, and its
    (a), (b), (c) and host split beside ``tbl[idx]`` at the microbenchmark's
    inputs (``launch_cost.measure``);
35. the dynamic-indexing probes (``cmacionize_torch.tools.
    probe_pallas_gather.main()``) at the tool's sizes (8192 lookups, 1024
    for the sublane gather; the baselines at 2^20), their launch counts of
    K12t, K12r, K11r (the flat 2D gather), K12s and K12a, and the sort keys
    formed on the card against the host's; then each of the five kernels
    against its plain version on the probe's inputs, on seeded inputs at
    the probe's shapes and at 2^20 lookups (identical; K12a with duplicates
    and random weights within rel L1 1e-6), and timed at the probe's shapes
    beside its plain version and its one PyTorch call; K12r also on its
    scalar path (a width not a multiple of 4, a table off 16-byte
    alignment), K11r on 2^20 - 3 lookups, 3D blocks and views off 16-byte
    alignment (rows and lanes; the table), and both with one launch per call, on a side stream and after two replays of
    a CUDA graph; then, for K11r, K12s, K12t and K12r (on
    ``kernels/launch.py``) and K12a (on the ctypes path of
    ``kernels/gather.py``), at the probe's shapes and (all but K11r) at 2^20
    lookups, beside ``tab[hi, lo]``, ``torch.gather``,
    ``torch.take_along_dim``, ``tab[idx]`` and ``zeros`` + ``index_put_``
    (``cmacionize_torch.tools.launch_cost.measure``): (a) ms per call back
    to back, (b) ms per call on the device alone (a CUDA graph of 50
    calls), (c) host µs per call with no synchronise, and the host's cost
    split step by step for the old path (K12a) and the new (K11r, K12s,
    K12t, K12r);
36. the deposit and DDA-step probes (``cmacionize_torch.tools.
    probe_deposit.main()`` and ``probe_deposit2.main()``) at the tools' sizes
    (1024 packets or lanes, 7808 steps), their launch counts of K13h (the
    shifted histogram of D2-D8b), K13e (E), K13w (W2) and K13f (D12); then
    each kernel against its plain version on the tools' inputs, on seeded
    ones at the tools' shapes (K13h also at 300 steps) and on a larger seeded
    case (K13h 2^16 packets x 7808 steps, K13e and K13w 2^20 lanes): K13h
    identical with integer weights and within rel 1e-5 per cell with random
    ones, the others identical in every lane and bit; K13f (on
    ``kernels/launch.py``) with one launch per call, on a side stream and
    after two replays of a CUDA graph, and its (a), (b), (c) and host split
    beside its one PyTorch call at [8, 128] (``launch_cost.measure``); each
    timed beside its plain version (K13h also beside ``torch.bincount`` on
    the expanded cells), K13e and K13w with their latency floors;
37. the cohort mechanics probes (``cmacionize_torch.tools.
    probe_cohort_kernel.main()``) at the tool's sizes, their launch counts
    of K14a (run_a), K14b (run_b), K14c (run_c) and K13h (run_d); then K14a,
    K14b and K14c against their plain versions on the tool's inputs, seeded
    ones at its shapes and a larger seeded case (2^20 counts, 4096 rows,
    15616 items; K14c also 1, 2, 3 and 7 items, a partial last chunk):
    identical, K14c's scalar within 1e-6 of Σ|x·y| and the same bits on a
    second run; K14c with one launch per call, on a side stream and after two
    replays of a CUDA graph; each timed beside its plain version, K14c also
    beside ``pk.clone()``, and K14c's (a), (b) and (c) beside ``pk.clone()``'s
    at the tool's 7808 items (``launch_cost.measure``).

Each kernel's record carries ``bound_ms``, the least time an H100 could take
for the same work (bytes over the HBM rate or operations over the peak
rate, whichever is larger), computed from this run's inputs.

The line before the last is a JSON object with the kernels' results; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import torch

from cmacionize_torch import kernels
from cmacionize_torch.device import describe, require_cuda
from cmacionize_torch.kernels import build
from cmacionize_torch.kernels import gather as gather_ops
from cmacionize_torch.kernels import probe_cohort as probe_cohort_ops
from cmacionize_torch.kernels import probe_deposit as probe_deposit_ops
from cmacionize_torch.kernels import probe_gather
from cmacionize_torch.kernels import temperature as temperature_kernels
from cmacionize_torch.kernels import compact as compact_ops
from cmacionize_torch.kernels import trace_octree as trace_octree_ops
from cmacionize_torch.kernels import trace_octree_spectral as trace_octree_spectral_ops
from cmacionize_torch.kernels import trace_packets as trace_packets_ops
from cmacionize_torch.kernels import trace_voronoi as trace_voronoi_ops
from cmacionize_torch.kernels import voronoi_flux as voronoi_flux_ops
from cmacionize_torch.kernels.peel_off import peel_off_cuda
from cmacionize_torch.kernels.peel_off_polarized import peel_off_polarized_cuda
from cmacionize_torch import constants
from cmacionize_torch.models import (
    amr,
    dust_simulation,
    ions,
    multifreq_simulation,
    reemission,
    sources,
    voronoi,
    voronoi_hydro,
)
from cmacionize_torch.models.density_functions import density_function_from_params
from cmacionize_torch.models.dusty_galaxy import DUSTY_GALAXY_PARAMS, image_measures
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.models.ionization_simulation import (
    HOnlyConfig,
    HOnlyIonizationSimulation,
    ShardedHOnlyIonizationSimulation,
)
from cmacionize_torch.models.multifreq_simulation import (
    MultiFreqConfig,
    MultiFreqIonizationSimulation,
)
from cmacionize_torch.models.rhd_simulation import (
    RHDSimulation,
    ShardedRHDSimulation,
    hosokawa_inutsuka_radius,
    spitzer_radius,
)
from cmacionize_torch.ops import (
    amr_traversal,
    hydro,
    ionization,
    peel_off,
    recombination,
    temperature,
    traversal,
)
from cmacionize_torch.parallel import domain as parallel_domain
from cmacionize_torch.parallel import domain3d
from cmacionize_torch.tools import experimental_cone_kernel as cone
from cmacionize_torch.tools import experimental_emission_octa as octa
from cmacionize_torch.tools import microbench_scatter
from cmacionize_torch.tools import probe_cohort_kernel, probe_deposit, probe_deposit2
from cmacionize_torch.tools import launch_cost, octree_study, probe_pallas_gather
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
    "K6": "trace_voronoi", "K6s": "trace_voronoi_spectral", "K7": "voronoi_flux",
    "K5": "trace_octree", "K5s": "trace_octree_spectral",  # K5d is built with K5
    "K8": "peel_off", "K8p": "peel_off_polarized",
    "K9": "compact",  # K9c and K9p
    "K10": "trace_packets_cone", "K11": "gather",  # K11 and K11r
    "K12": "probe_gather",  # K12t, K12r, K12s and K12a
    "K13": "probe_deposit",  # K13h, K13e, K13w and K13f
    "K14": "probe_cohort",  # K14a, K14b and K14c
}
PC = 3.086e16
MYR = 3.15576e13

# The least time one H100 SXM could take for a kernel's work, the larger of
# bytes / HBM rate and operations / peak rate (NVIDIA's data sheet, dense, no
# sparsity: 3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores, 34 TFLOP/s
# f64), counting each input read once and each output written once.  The
# operations of one unit of work are counted from each kernel's source
# (additions, multiplications, divisions, square roots, comparisons and
# min/max count 1, an FMA 2; a transcendental as the ~20 operations of its
# libdevice routine); where the work depends on the data, the units are what
# this run's inputs need (packet steps, secant sweeps).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
OPS_PER_K1_STEP = 35  # 3 wall distances, the exit, absorption, deposit, advance, snap, checks
OPS_PER_K2_STEP = 38  # K1's step with chi_H sigma_H + chi_He sigma_He
OPS_PER_K3_PREDICT_CELL = 200  # 15 limited slopes, the half-step prediction
OPS_PER_K3_CELL = 700  # 6 faces: states, HLLC, accumulation
# K4, f64, counted from temperature.cu's body with every data-dependent
# branch at its cheapest, so that the count is a lower one (pow as log + exp,
# 40).  One balance evaluation:
#   14 recombination rates, the power-law fit without a dielectronic term  14 x 44
#   the H-He fixed point: set-up 85, one iteration 79 (it runs 1-20), exit 3  167
#   electron densities 34, heating 62                                           96
#   the metal chains, each charge-transfer rate at its no-rate branch          145
#   the coolant abundances                                                      25
#   ten five-level coolants: 10 transitions x (Omega(T) 91 + Boltzmann factor
#     23), the matrix 52, Gauss-Jordan 315, the sum 30, x abundance 2     10 x 1539
#   three two-level coolants                                               3 x 124
#   free-free and recombination cooling                                        126
# and one secant sweep is three evaluations and the update (~120).
OPS_PER_K4_BALANCE = 14 * 44 + 167 + 96 + 145 + 25 + 10 * 1539 + 3 * 124 + 126
OPS_PER_K4_SWEEP = 3 * OPS_PER_K4_BALANCE + 120
# K4f, the same body in f32, but each of the 103 collision strengths comes
# from the log-Omega table (two loads, the interpolation 3, exp 20: 24 in
# place of the fit's 91), with the node and fraction once per evaluation
# (log, the clamp, the division, floor, the fraction: 26)
OPS_PER_K4F_BALANCE = OPS_PER_K4_BALANCE - (10 * 10 + 3) * (91 - 24) + 26
OPS_PER_K4F_SWEEP = 3 * OPS_PER_K4F_BALANCE + 120
# K6/K6s per real face of the cell (the padding of a row needs no test): two
# 3-term dots, the plane distance, the minimum
OPS_PER_VORONOI_FACE = 16
OPS_PER_K6_STEP = 20  # absorption, deposit, advance with the shift
OPS_PER_K6S_STEP = 23
OPS_PER_K7_FACE = 680  # per real face: gradients, trial and update passes, 2 HLLC, sums
OPS_PER_K7_CELL = 300  # the LSQ matrix, its LU and 5 solves, limiter, prediction
# K5/K5s/K5d (octree_march.cuh): one internal level of a descent (the half
# size, three midpoints and comparisons, the octant and row index, three
# box updates), and the rest of a march step (the nudged point and its
# coarse cell and root index, three wall distances, the exit, absorption,
# deposit, advance, snap and the nudged inside test); K5s adds the χ_He
# product and the FMA; K5d's point without its levels is the coarse cell
OPS_PER_OCTREE_LEVEL = 16
OPS_PER_K5_STEP = 72
OPS_PER_K5S_STEP = 75
OPS_PER_K5D_POINT = 16
# K8/K8p (cartesian_march.cuh, peel_march.cuh, peel_off.cu,
# peel_off_polarized.cu).  One march step: 3 wall distances (2 comparisons,
# the wall, the difference, the division, the max: 18), the exit (2), the
# chi index and floor (5), tau_cell
# and the absorption test (2), the advance (3 FMAs: 6), the snap (4),
# tau_left (1), the inside test (6).  One event of K8 at emission: the start
# cells (9), the pixel (6 for the SI position, 2 x 5 for the two dots, 2 x 6
# for the window, 2 for the index: 30), the factor (1), exp (20), the product
# and the deposit (2).  A scattering event adds the HG phase: the dot (5),
# the base (2), pow as log + exp (40), 2 products and the division (3).  One
# event of K8p: K8's start cells, pixel, exp and deposits (64 with four
# atomics and att), the peel-off algebra (3-term dots 4 x 5, the sine 4, the
# in-plane axes 9 + 9, two cross products 18, two Stokes rotations 22, the
# matrix with pow 40, acos 20, exp 20 and cos 20 (~120), the four observed
# components 16)
OPS_PER_K8_STEP = 44
OPS_PER_K8_EVENT = 62
OPS_PER_K8_PHASE = 50
OPS_PER_K8P_EVENT = 300

# starbench_voronoi (benchmarks/run_starbench_voronoi.py:32-60, not "small"):
# 40000 UniformRandom generators from seed 42 with 2 Lloyd iterations, 5e5
# packets x 10 iterations per step, 1024 fixed steps to 0.141 Myr
SBV_BOX = ((-1.256 * PC,) * 3, (2.512 * PC,) * 3, (32, 32, 32))
SBV_GENERATORS, SBV_LLOYD, SBV_SEED = 40000, 2, 42
SBV_PHOTONS, SBV_NLOOP, SBV_STEPS = 500000, 10, 1024
SBV_DENSITY, SBV_LUMINOSITY, SBV_SIGMA, SBV_ALPHA = 3.113e9, 1e49, 6.3e-22, 2.7e-19
HONLY_ITERATIONS = 20
PROFILED_STEPS = 16  # after the timed run, under torch.profiler
MAX_STROMGREN_VOLUME_ERROR = 0.3  # tests/test_voronoi.py:218-221
# multi-frequency on the cell graph: tests/test_multifreq_grids.py:94-121's
# geometry, density, abundances and source, scaled up
MF_BOX = ((-5 * PC,) * 3, (10 * PC,) * 3, (16, 16, 16))
MF_GENERATORS, MF_LLOYD, MF_SEED = 12000, 1, 10
MF_PHOTONS, MF_BINS, MF_ROUNDS, MF_ITERATIONS = 1_000_000, 64, 4, 10
MF_DENSITY, MF_LUMINOSITY = 1e8, 4.26e49
ABUND = {"He": 0.1, "C": 2.2e-4, "N": 4e-5, "O": 3.3e-4, "Ne": 5e-5, "S": 9e-6}
# stromgren_amr: stromgren.param's box, gas, source and budget, its 64^3 grid
# as the coarse level and the zone [-2.5 pc, 2.5 pc)^3 refined to level 3;
# the multi-frequency AMR run: tests/test_multifreq_grids.py:40-72's box
# (MF_BOX), gas, abundances, source and zone [-1.5 pc, 1.5 pc)^3 at
# tests/test_amr.py:438-470's depth, level 5; both deep (no owner map)
AMR_ZONE, AMR_MAX_LEVEL, AMR_LEAVES = 2.5 * PC, 3, 17_006_592
# stromgren.param's 1e6 packets per iteration starve the zone's level-3
# leaves (64x smaller in cross-section than its cells): at the zone's
# corners (4.3 pc) a leaf sees ~1.6 packets per iteration, so many see none,
# turn neutral and absorb what crosses them next, and the front settled at
# 0.63 of the analytic radius (this script on an H100 with 1e6).  16x the
# packets give every leaf of the zone >= 25 expected crossings.
AMR_PHOTONS = 16_000_000
MFA_ZONE, MFA_MAX_LEVEL, MFA_LEAVES = 1.5 * PC, 5, 2_101_184
# The level-5 leaves are 1/1024 of a coarse cell in cross-section: with 1e6
# packets most of them see no packet above O+'s 35 eV edge, so their O++
# rate is 0 and the median O_n slot (the O+ share) inside 2 pc came out
# 0.99997 (this script on an H100).  The share of such leaves falls as the
# packets per leaf cross-section grow; with 8e6 the median is 0.026 (this
# script on an H100).
MFA_PHOTONS = 8_000_000
AMR_PROFILED_ITERATIONS = 2
# K5/K5s against their plain versions: positions in coarse cell units
MAX_AMR_POSITION_DIFF = 1e-5
DUST_REFERENCE = os.path.join(ROOT, "tests", "torch_dust_reference.npz")
DUST_SEED = 42
# image measures (dusty_galaxy.image_measures, the order of the
# reference's pairs) and the bars of benchmarks/RESULTS.md:191-195; the
# thresholds are twice the JAX seeds' envelope where that is tighter
DUST_MEASURES = ("correlation", "centroid_px", "profile", "flux")
DUST_BARS = {"correlation": 0.98, "centroid_px": 0.5, "profile": 0.06}
# K8/K8p against their plain versions: identical tau and pixels (the same
# f32 march and projection); the images differ by the atomics' order and
# last-bit differences of pow, exp, acos and cos
MAX_PEEL_OFF_REL_L1 = 1e-5
# K6/K6s against their plain versions: the same f32 operations per packet
# (FMAs written out, --fmad=false), the tally in another atomic order
MAX_VORONOI_POSITION_DIFF = 1e-5  # box units, where the flags agree
# K7 against its plain version: identical trial flags, each field's max |Δ|
# within this share of the field's max (sums in the same face order)
MAX_VORONOI_HYDRO_REL_ERR = 1e-5

PARITY_SEED = 1234
# Tolerances of the marches against their plain versions.  Both run the same
# IEEE f32 operations per packet (the kernels are built with --fmad=false), so
# flags and positions should match (K1 and K6 are held to identical states);
# the tally differs only by the order in which the deposits add, i.e. at f32
# round-off, and is held to the plain march summed in f64 where a kernel sums
# runs or windows of deposits first (K1, K5, K6).
MAX_FLAG_MISMATCH_FRACTION = 1e-5
MAX_POSITION_DIFF = 5e-4  # cells
MAX_TALLY_REL_L1 = 1e-4
# Strömgren 50%-crossing radius / analytic radius
RADIUS_RATIO_RANGE = (0.98, 1.02)
# the sharded drivers: stromgren.param on 2 x 2 x 2 tiles (all three exchange
# axes), starbench.param on 4 x-slabs, every shard on the one card; their
# ionized volume and R(t) against the single-device runs of phases 4 and 7
SHARDED_STROMGREN_TILING = (2, 2, 2)
SHARDED_STARBENCH_TILING = (4, 1, 1)
MAX_SHARDED_DEVIATION = 0.05
# The sharded starbench run stops at this fraction of the file's 0.141 Myr
# (615 of 2048 steps, three of the ten outputs): on one card the four slabs'
# exchanges are host bound (3-4 supersteps per MC iteration once the front
# has left the source's window of three slabs, ~600 kernel launches and one
# host read each).  On an H100 (this script) the full run took 809 s, and
# the run to 0.4 of the time 239 s, which put the whole script at 621 s,
# past half its time limit.
SHARDED_STARBENCH_FRACTION = 0.3
# the cone Strömgren path: the packet count nearest stromgren.param's 1e6
# that lane_table takes (n/8 = 2 * 256^2) and K10's chunks divide, so that
# octant boundaries fall on chunk boundaries and every chunk is sign-pure
CONE_PHOTONS = 1 << 20
CONE_PROFILED_ITERATIONS = 2
MAX_CONE_VOLUME_DEVIATION = 0.02  # ionized cells against phase 4's
# K10 parity on every lane of a 2^20 stratified batch.  K10 sums a lane's
# optical depth cell by cell in travel order, the plain version over the slab
# and by prefix scans: tau_left differs at f32 round-off, which can flip a
# lane whose tau_left lies at the slab's total.  Where it lies between the
# plain version's two totals, the plain version (as the Pallas kernel) absorbs
# the lane in no cell, at the point where it entered the slab ("unplaced"),
# and K10 absorbs it further along its ray: such lanes are held to that and
# counted with the state flips.  K10 against K1 alone: two algorithms that
# split a path at other points
MAX_CONE_POSITION_DIFF = 1e-4  # cells, where the states agree
SLAB_DIAGONAL = 8 * 3**0.5  # cells: the farthest K10 may absorb a lane the plain version left
MAX_CONE_TALLY_REL_L1 = 1e-5
MAX_CONE_ABSORBED_FRACTION = 1e-4
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
# K4f against its plain version: the same f32 operations and libdevice
# expf/logf/powf, but a last-bit difference grows in f32's cancellations
T32_MATCH_REL = 1e-4
# the f32-device lexington run against the f64 one, over the cells the f64
# run ionized (tests/test_multifreq.py:151-162)
F32_BACKEND_MEDIAN_T = 5e-3
F32_BACKEND_Q95_T = 3e-2
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


def timed_call(fn):
    """(``fn()``, its milliseconds on the card by CUDA events): one call
    without a warm-up, for plain versions that take seconds, whose parity
    call is also their timing."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


@contextlib.contextmanager
def capturing(owner, name: str, keep: dict, copy):
    """While active, ``owner.<name>`` is wrapped so that the inputs of the
    calls numbered in ``keep`` (from 0) are copied by ``copy(*args,
    **kwargs)`` into the yielded dict under ``keep``'s labels; every call
    goes on to the wrapped function unchanged."""
    original = getattr(owner, name)
    captured, calls = {}, [0]

    def wrapper(*args, **kwargs):
        if calls[0] in keep:
            captured[keep[calls[0]]] = copy(*args, **kwargs)
        calls[0] += 1
        return original(*args, **kwargs)

    setattr(owner, name, wrapper)
    try:
        yield captured
    finally:
        setattr(owner, name, original)


@contextlib.contextmanager
def timing_call(owner, name: str, index: int):
    """While active, call number ``index`` (from 0) of ``owner.<name>`` is
    timed by CUDA events on the current stream around the call; the yielded
    dict then holds the events ("start", "end"), the call's result and its
    first argument."""
    original = getattr(owner, name)
    timed, calls = {}, [0]

    def wrapper(*args, **kwargs):
        calls[0] += 1
        if calls[0] - 1 != index:
            return original(*args, **kwargs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = original(*args, **kwargs)
        end.record()
        timed.update(start=start, end=end, result=out, first=args[0])
        return out

    setattr(owner, name, wrapper)
    try:
        yield timed
    finally:
        setattr(owner, name, original)


def copy_solve(T_prev, j, h, nd, abundances, **kwargs):
    """The inputs of one temperature solve, copied."""
    return (T_prev.clone(), {k: v.clone() for k, v in j.items()},
            (h[0].clone(), h[1].clone()), nd.clone(), dict(abundances), kwargs)


def roofline(label: str, n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    """The JSON fields bound_ms / bound_by / library_ms of a kernel's work:
    the larger of bytes over the HBM rate and operations over the peak rate.
    library_ms is null: no single PyTorch call computes K1-K8p's or K10's
    functions (K9c's record sets its own, a stable argsort and a gather, and
    the gathers K11-K12a theirs, the one PyTorch call of each function).

    A gather's bytes are its indices and its output once each, and of its
    table the distinct 32-byte sectors that this run's lookups touch
    (:func:`sector_bytes`): the whole table where they touch all of it (K12r
    at the probe's shapes: (7t) mod 4096 over 8192 rows), one sector per
    lookup where they touch a small part (K12t, K12s)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    log(f"bound of {label}: {n_bytes:.6g} B and {n_ops:.6g} operations -> {bound_ms:.6f} ms "
        f"(by {bound_by})")
    return {"bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def k1_parity(chi, packets, shape, label: str, escapes: bool = True) -> dict:
    """K1 against trace_packets_reference on the card: no flag or cell
    mismatch, identical positions and tau_left; the tally against the plain
    version's and, as octree_parity holds K5, K1's and the plain f32 tally
    against the plain march summed in f64 (K1's checked at MAX_TALLY_REL_L1:
    the plain f32 tally carries its own atomic bias).  The input must have
    absorbed packets, and escaping ones where ``escapes`` (the opaque
    starbench regime absorbs all).  Both timed, with K1's registers and
    blocks per SM and its bound from the plain march's steps."""
    zeros = torch.zeros_like(chi)
    tally_k, out_k = traversal.trace_packets(chi, packets, zeros.clone(), shape=shape)
    stats = {}
    tally_r, out_r = traversal.trace_packets_reference(
        chi, packets, zeros.clone(), shape=shape, stats=stats
    )
    tally_64 = traversal.trace_packets_reference(chi, packets, zeros.double(), shape=shape)[0]
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
    same_state = all(same_bits(getattr(out_k, f), getattr(out_r, f))
                     for f in ("px", "py", "pz", "tau_left"))
    tally_abs = (tally_k - tally_r).abs()
    tally_rel_l1 = float(tally_abs.sum() / tally_r.abs().sum())
    rel_64 = [float((t.double() - tally_64).abs().sum() / tally_64.abs().sum())
              for t in (tally_k, tally_r)]
    n_absorbed = int(out_r.absorbed.sum())
    log(
        f"K1 parity ({label}): {n} packets, {n_absorbed} absorbed / {n - n_absorbed} escaped "
        f"(plain); absorbed/active flag mismatches {flag_mismatch}, cell "
        f"mismatches {cell_mismatch}, max |position diff| {pos_diff:.3e} cells, positions "
        f"and tau_left identical: {same_state}; tally rel L1 {tally_rel_l1:.3e}, max |tally "
        f"diff| {float(tally_abs.max()):.3e}; against the plain march summed in f64: K1 "
        f"{rel_64[0]:.3e}, the plain version in f32 {rel_64[1]:.3e}"
    )
    check(0 < n_absorbed and (n_absorbed < n or not escapes),
          "parity input has both absorbed and escaping packets")
    check(flag_mismatch == 0 and cell_mismatch == 0,
          f"K1 flag mismatches {flag_mismatch}, cell mismatches {cell_mismatch}")
    check(same_state, "K1's positions and tau_left equal the plain version's")
    check(
        tally_rel_l1 <= MAX_TALLY_REL_L1,
        f"tally rel L1 {tally_rel_l1} > {MAX_TALLY_REL_L1}",
    )
    check(rel_64[0] <= MAX_TALLY_REL_L1, f"K1's tally rel L1 against f64 {rel_64[0]}")

    scratch = zeros.clone()
    ms = time_cuda(
        lambda: traversal.trace_packets(chi, packets, scratch, shape=shape), 20
    )
    plain_ms = time_cuda(
        lambda: traversal.trace_packets_reference(chi, packets, scratch, shape=shape), 3
    )
    lanes = trace_packets_ops.occupancy(chi.device)
    log(
        f"timing K1 ({label}, {shape}): K1 {ms:.4f} ms, plain {plain_ms:.4f} ms per march "
        f"(CUDA events, incl. the packet-state copy); K1 "
        f"{lanes['registers']} registers, {lanes['blocks_per_sm']} blocks of 256 per SM"
    )
    ncell = chi.numel()
    steps = int(stats["packet_steps"])
    # chi read, tally read and written; packets: 11 f32/i32 + 2 flags in,
    # 7 + 2 out
    bound = roofline(f"K1 ({label}; {steps} packet steps)", 12 * ncell + 76 * n,
                     OPS_PER_K1_STEP * steps, F32_OPS_PER_S)
    return {
        "max_abs_err": float(tally_abs.max()),
        "ms": ms,
        "plain_ms": plain_ms,
        **bound,
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
    return launches, int((xH_host < 0.5).sum())


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
    nx, ny, nz = geometry.shape
    n, n1 = nx * ny * nz, (nx + 2) * (ny + 2) * (nz + 2)
    padded = (nx + 4) * (ny + 4) * (nz + 4)
    bound = roofline("K3 (HLLC)", 4 * 5 * (padded + 2 * n),
                     OPS_PER_K3_PREDICT_CELL * n1 + OPS_PER_K3_CELL * n, F32_OPS_PER_S)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bound}


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
    regime = k1_parity(chi, packets, sim.geometry.shape,
                       f"the starbench regime: the final state, {cfg.n_photons} fresh packets",
                       escapes=False)
    del chi, packets
    profile_window(f"{PROFILED_STEPS} starbench steps at t = {sim.time / MYR:.4f} Myr",
                   lambda: sim.advance(PROFILED_STEPS, log_every=PROFILED_STEPS + 1),
                   {"K1": ("trace_packets_kernel",), "K3": ("muscl_",)})
    return launches, outputs, regime


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
    stats = {}
    tally_r, out_r = traversal.trace_packets_spectral_reference(
        chi_h, chi_he, packets, zeros.clone(), stats=stats, **march)
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
    steps = int(stats["packet_steps"])
    # chi_H, chi_He read; the binned tally read and written; packets: 14
    # f32/i32 + 2 flags in, 7 + 2 out
    bound = roofline(f"K2 ({steps} packet steps)", 8 * ncell + 8 * n_bins * ncell + 88 * n,
                     OPS_PER_K2_STEP * steps, F32_OPS_PER_S)
    return {"max_abs_err": float(tally_abs.max()), "ms": ms, "plain_ms": plain_ms, **bound}


def run_multifreq(sim: MultiFreqIonizationSimulation, label: str):
    """Run ``sim`` with the launch counts set to 0 just before; returns
    (xion, T, wall seconds, {kernel: launches}).  The temperature solves
    launch K4f under the f32 backend and K4 otherwise."""
    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xion, T = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name]
                for name in ("trace_packets_spectral", "temperature", "temperature_f32")}
    cfg = sim.config
    transport = sum(t for t, _ in sim.phase_seconds)
    solve = sum(s for _, s in sim.phase_seconds)
    log(
        f"{label}: {sim.geometry.shape}, {cfg.n_photons} packets x {cfg.n_iterations} "
        f"iterations, {cfg.n_bins} bins, {cfg.n_reemission_rounds if cfg.diffuse_field else 0} "
        f"re-emission generations, temperature backend {cfg.temperature_backend}, in "
        f"{wall:.4f} s wall ({transport:.4f} s transport, "
        f"{solve:.4f} s solve; {cfg.n_photons * cfg.n_iterations / wall:.6g} source "
        f"packets/s); launches {launches}"
    )
    marches = cfg.n_iterations * (1 + (cfg.n_reemission_rounds if cfg.diffuse_field else 0))
    solves = (max(cfg.n_iterations - cfg.minimum_iteration_number, 0)
              if cfg.do_temperature else 0)
    f32 = cfg.temperature_backend == "f32-device" and cfg.fixed_alpha is None
    check(launches["trace_packets_spectral"] == marches,
          f"{label}: K2 launches {launches} != {marches}")
    check(launches["temperature_f32" if f32 else "temperature"] == solves
          and launches["temperature" if f32 else "temperature_f32"] == 0,
          f"{label}: K4/K4f launches {launches}, {solves} solves")
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


def lexington_full(device, backend: str = "f64-host"):
    """lexingtonHII20 at full size with the given temperature backend, with
    the inputs of its fourth temperature solve kept for the parity phase;
    the physical bands of the benchmark.  Returns (launches, the fourth
    solve's inputs, the final state as numpy arrays)."""
    sim = lexington_simulation(device, temperature_backend=backend)
    solve = "solve_temperature_device" if backend == "f32-device" else "solve_temperature"
    label = f"lexingtonHII20 at full size ({backend})"
    with capturing(multifreq_simulation.temperature, solve, {3: "fourth"},
                   copy_solve) as captured:
        xion, T, wall, launches = run_multifreq(sim, label)
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
    check(INTERIOR_T_BAND[0] < T_shell < INTERIOR_T_BAND[1], f"{label}: interior T {T_shell}")
    check(xH_med < 3e-3, f"{label}: median xH in 1-2.5 pc {xH_med}")
    check(vol_He <= 1.05 * vol_H, f"{label}: He front outside the H front: {vol_He} > {vol_H}")
    check(o_p > 0.9 and o_pp < 0.1, f"{label}: O+ {o_p}, O++ {o_pp}")
    check(xH_far > 0.9, f"{label}: exterior median xH {xH_far}")
    check(STROMGREN_RATIO_BAND[0] < r_ion / r_st < STROMGREN_RATIO_BAND[1],
          f"{label}: r_ion / r_Stromgren {r_ion / r_st}")
    check(len(sim.sweeps) > 3 and "fourth" in captured,
          f"{label}: the run made {len(sim.sweeps)} temperature solves")
    profile_window(f"one more iteration of {label}", lambda: sim.run(sim.iteration + 1),
                   {"K2": ("trace_packets_spectral_kernel",),
                    "K4f" if backend == "f32-device" else "K4": ("temperature_kernel",)})
    return launches, captured["fourth"], {"T": T, **x}


def compare_backends(f64_state: dict, f32_state: dict) -> None:
    """The f32-device run's final state against the f64 run's, with the
    bands of tests/test_multifreq.py:151-162, over the cells the f64 run
    ionized (xH < 0.5)."""
    ion = f64_state["H_n"].ravel() < 0.5
    T64, T32 = f64_state["T"].ravel()[ion], f32_state["T"].ravel()[ion]
    rel = np.abs(T32 - T64) / T64
    v64, v32 = int(ion.sum()), int((f32_state["H_n"] < 0.5).sum())
    o64 = float(np.median(f64_state["O_n"].ravel()[ion]))
    o32 = float(np.median(f32_state["O_n"].ravel()[ion]))
    log(f"f32-device against f64 (lexingtonHII20 64^3, the final state): over the {v64} "
        f"ionized cells median |dT|/T {np.median(rel):.4e}, 95% quantile "
        f"{np.quantile(rel, 0.95):.4e}, max {rel.max():.4e}; ionized cells {v32} vs {v64}; "
        f"median O_n {o32:.6f} vs {o64:.6f}")
    check(np.median(rel) < F32_BACKEND_MEDIAN_T, f"f32 backend median |dT|/T {np.median(rel)}")
    check(np.quantile(rel, 0.95) < F32_BACKEND_Q95_T,
          f"f32 backend 95% |dT|/T {np.quantile(rel, 0.95)}")
    check(abs(v32 - v64) <= max(0.02 * v64, 5), f"f32 backend ionized cells {v32} vs {v64}")
    check(abs(o32 - o64) <= 1e-4 + 0.05 * abs(o64), f"f32 backend median O_n {o32} vs {o64}")


def k4_layout(label: str, kernel: str, n: int, sweeps, sweeps_of: str) -> None:
    """Log K4's or K4f's layout on the card: registers, stack and spills of
    both its instantiations (one and three lanes a cell; the build's ptxas
    report), their blocks per SM, the lanes a cell this solve of ``n`` cells
    takes, and the share of lanes a launch of one thread a cell in cell
    order would keep busy on ``sweeps`` (``kernels/temperature.py:
    lanes_busy``)."""
    dtype = torch.float64 if kernel == "K4" else torch.float32
    device = sweeps.device
    report = temperature_kernels.ptxas_report()
    for lanes, name in ((1, kernel), (3, f"{kernel} (3 lanes)")):
        found, r = temperature_kernels.occupancy(device, dtype, lanes), report[name]
        log(f"  {name}: {r['registers']} registers, {r['stack']} B of stack, "
            f"{r['spill_stores']} / {r['spill_loads']} B of spill stores / loads; "
            f"{found['blocks_per_sm']} blocks of {temperature_kernels.THREADS} threads a SM "
            f"on {found['sms']} SMs")
    s = sweeps.reshape(-1)
    log(f"  {label}: {n} cells, {temperature_kernels.lanes_per_cell(n, device, dtype)} lane(s) "
        f"a cell; lanes busy with one thread a cell in cell order "
        f"{temperature_kernels.lanes_busy(s):.4f} ({sweeps_of}'s sweeps: mean "
        f"{float(s.double().mean()):.4f}, max {int(s.max())}, "
        f"{int((s == int(s.max())).sum())} cells at the max)")


def temperature_parity(solve_inputs, label: str) -> dict:
    """K4 against solve_temperature_reference on the card, on every cell of
    the temperature solve whose inputs are ``solve_inputs``; both timed."""
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
        f"K4 parity ({label}): {T_prev.numel()} cells, "
        f"{int((nd <= 0).sum())} without gas: {match:.6f} of cells within {T_MATCH_REL} "
        f"relative in T, max |dT|/T {max_rel:.3e}, max |d| h0 {state['h0']:.3e}, he0 "
        f"{state['he0']:.3e}, metals {state['metals']:.3e}; same sweep count in "
        f"{same_sweeps:.6f} of cells (max {int(ref.sweeps.max())}, mean "
        f"{float(ref.sweeps.double().mean()):.2f})"
    )
    k4_layout(label, "K4", T_prev.numel(), ref.sweeps, "the plain version")
    check(match >= MIN_T_MATCH_FRACTION,
          f"K4 ({label}): {match} of cells match, < {MIN_T_MATCH_FRACTION}")
    check(max_rel <= MAX_T_REL_ERR, f"K4 ({label}): max |dT|/T {max_rel} > {MAX_T_REL_ERR}")

    ms = time_cuda(lambda: temperature.solve_temperature(T_prev, j, h, nd, abundances,
                                                         **kwargs), 3)
    plain_ms = time_cuda(lambda: temperature.solve_temperature_reference(
        T_prev, j, h, nd, abundances, **kwargs), 1)
    log(f"timing K4 ({label}) on {T_prev.numel()} cells: K4 {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms per solve (CUDA events)")
    sweeps = int(got.sweeps.sum())
    # f64 in: T, 14 rates, 2 heating integrals, density; out: T, h0, he0, 12
    # metal fractions, and the int32 sweep count
    bound = roofline(f"K4 ({label}; {sweeps} secant sweeps)", T_prev.numel() * (18 * 8 + 15 * 8 + 4),
                     OPS_PER_K4_SWEEP * sweeps, F64_OPS_PER_S)
    return {"max_abs_err": float(diff(got.T, ref.T).max()), "ms": ms, "plain_ms": plain_ms,
            **bound}


def temperature_f32_parity(solve_inputs, label: str) -> dict:
    """K4f against solve_temperature_device_reference on the card, on every
    cell of the f32 solve whose inputs are ``solve_inputs`` (rounded to f32,
    as the backend rounds them); both timed, and K4 timed on the same cells
    widened to f64."""
    T_prev, j, h, nd, abundances, kwargs = solve_inputs

    def f32(a):
        return a.to(torch.float32)

    T_prev, nd, h = f32(T_prev), f32(nd), (f32(h[0]), f32(h[1]))
    j = {k: f32(v) for k, v in j.items()}
    got = temperature.solve_temperature_device(T_prev, j, h, nd, abundances, **kwargs)
    ref = temperature.solve_temperature_device_reference(T_prev, j, h, nd, abundances, **kwargs)
    torch.cuda.synchronize()

    def diff(a, b, scale=1.0):  # |a - b| / scale: 0 where both are NaN, inf where one is
        a, b = a.double(), b.double()
        both = torch.isnan(a) & torch.isnan(b)
        d = torch.where(both, 0.0, (a - b).abs() / scale)
        return torch.nan_to_num(d, nan=float("inf"))

    rel = diff(got.T, ref.T, ref.T.double().abs())
    match = float((rel <= T32_MATCH_REL).double().mean())
    max_rel = float(rel.max())
    state = {"h0": float(diff(got.h0, ref.h0).max()), "he0": float(diff(got.he0, ref.he0).max())}
    state["metals"] = max(float(diff(got.metals[k], ref.metals[k]).max()) for k in ref.metals)
    same_sweeps = float((got.sweeps == ref.sweeps).double().mean())
    log(
        f"K4f parity ({label}): {T_prev.numel()} cells, {int((nd <= 0).sum())} without gas: "
        f"{match:.6f} of cells within {T32_MATCH_REL} relative in T, max |dT|/T "
        f"{max_rel:.3e}, max |d| h0 {state['h0']:.3e}, he0 {state['he0']:.3e}, metals "
        f"{state['metals']:.3e}; same sweep count in {same_sweeps:.6f} of cells (max "
        f"{int(ref.sweeps.max())}, mean {float(ref.sweeps.double().mean()):.2f})"
    )
    k4_layout(label, "K4f", T_prev.numel(), ref.sweeps, "the plain version")
    check(match >= MIN_T_MATCH_FRACTION,
          f"K4f ({label}): {match} of cells match, < {MIN_T_MATCH_FRACTION}")
    check(max_rel <= MAX_T_REL_ERR, f"K4f ({label}): max |dT|/T {max_rel} > {MAX_T_REL_ERR}")

    ms = time_cuda(lambda: temperature.solve_temperature_device(
        T_prev, j, h, nd, abundances, **kwargs), 3)
    plain_ms = time_cuda(lambda: temperature.solve_temperature_device_reference(
        T_prev, j, h, nd, abundances, **kwargs), 1)

    def f64(a):
        return a.to(torch.float64)

    j64, h64 = {k: f64(v) for k, v in j.items()}, (f64(h[0]), f64(h[1]))
    k4 = temperature.solve_temperature(f64(T_prev), j64, h64, f64(nd), abundances, **kwargs)
    k4_ms = time_cuda(lambda: temperature.solve_temperature(
        f64(T_prev), j64, h64, f64(nd), abundances, **kwargs), 3)
    log(f"timing K4f ({label}) on {T_prev.numel()} cells: K4f {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms per solve; K4 on the same cells widened to f64 {k4_ms:.4f} ms "
        f"({int(k4.sweeps.sum())} sweeps against K4f's {int(got.sweeps.sum())}) (CUDA events)")
    sweeps = int(got.sweeps.sum())
    # f32 in: T, 14 rates, 2 heating integrals, density; out: T, h0, he0, 12
    # metal fractions, and the int32 sweep count
    bound = roofline(f"K4f ({label}; {sweeps} secant sweeps)",
                     T_prev.numel() * (18 * 4 + 15 * 4 + 4),
                     OPS_PER_K4F_SWEEP * sweeps, F32_OPS_PER_S)
    return {"max_abs_err": float(diff(got.T, ref.T).max()), "ms": ms, "plain_ms": plain_ms,
            **bound}


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


# ------------------------------------------------------ Voronoi: K6, K6s, K7


def timed_voronoi_grid(box, n_generators: int, seed: int, num_lloyd: int):
    """Build a Voronoi grid from ``n_generators`` uniform generators drawn
    from ``seed`` (run in a worker process while the kernels build):
    (grid, seconds)."""
    t0 = time.perf_counter()
    generators = np.random.default_rng(seed).random((n_generators, 3))
    grid = voronoi.build_voronoi_grid(GridGeometry(*box), generators, num_lloyd=num_lloyd)
    return grid, time.perf_counter() - t0


def report_grid(label: str, future):
    t0 = time.perf_counter()
    grid, seconds = future.result()
    log(f"grid: {label}: {grid.n_cells} cells, K = {grid.max_faces} faces per row (mean "
        f"{float((grid.neighbors != -2).sum(1).mean()):.2f} real), built on the host in "
        f"{seconds:.2f} s (set-up); the main process waited {time.perf_counter() - t0:.2f} s "
        f"for it")
    return grid


def generators_si(grid) -> np.ndarray:
    return grid.generators * grid.scale + np.asarray(grid.geometry.anchor)


def compare_voronoi_marches(label, out_k, out_r, tally_k, tally_r):
    """Flag mismatches, the largest position difference (box units) over
    packets whose flags agree, and the tally's relative L1; checked."""
    n = out_r.cell.numel()
    agree = (out_k.absorbed == out_r.absorbed) & (out_k.active == out_r.active)
    flag_mismatch = int((~agree).sum())
    pos_diff = float((out_k.pos - out_r.pos)[agree].abs().max())
    tally_abs = (tally_k - tally_r).abs()
    tally_rel_l1 = float(tally_abs.sum() / tally_r.abs().sum())
    n_absorbed = int(out_r.absorbed.sum())
    log(f"{label}: {n} packets, {n_absorbed} absorbed / {int(out_r.active.sum())} still "
        f"active (plain); flag mismatches {flag_mismatch}, cell mismatches "
        f"{int((out_k.cell != out_r.cell).sum())}, max |position diff| {pos_diff:.3e} box "
        f"units, tally rel L1 {tally_rel_l1:.3e}, max |tally diff| {float(tally_abs.max()):.3e}")
    check(n_absorbed > 0, f"{label}: the input has absorbed packets")
    check(flag_mismatch <= MAX_FLAG_MISMATCH_FRACTION * n,
          f"{label}: flag mismatches {flag_mismatch} > {MAX_FLAG_MISMATCH_FRACTION} of {n}")
    check(pos_diff <= MAX_VORONOI_POSITION_DIFF, f"{label}: position diff {pos_diff}")
    check(tally_rel_l1 <= MAX_TALLY_REL_L1, f"{label}: tally rel L1 {tally_rel_l1}")
    return float(tally_abs.max())


def voronoi_march_parity(grid, device) -> dict:
    """K6 against trace_packets_voronoi_reference on the card, on the
    starbench_voronoi grid: an ionized sphere of 0.5 pc (x_H 1e-4..5e-4) in
    the 3.113e9 m^-3 gas with a fully ionized cone along +z, and the main
    path's 5e5 packets from the source, made with numpy; both timed."""
    rng = np.random.default_rng(PARITY_SEED)
    pos_si = generators_si(grid)
    r = np.sqrt((pos_si**2).sum(1))
    x = np.where(r < 0.5 * PC, rng.uniform(1e-4, 5e-4, r.shape), 1.0)
    x = np.where(pos_si[:, 2] > r * np.cos(np.radians(20.0)), 1e-6, x)
    chi_si = torch.tensor((SBV_DENSITY * x * SBV_SIGMA).astype(np.float32), device=device)
    n = SBV_PHOTONS
    cos_t = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    sin_t = np.sqrt(1.0 - cos_t**2)
    direction = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], 1)
    src_u = -np.asarray(grid.geometry.anchor) / grid.scale
    packets = voronoi.make_voronoi_packets(
        grid, np.tile(src_u, (n, 1)), direction, -np.log1p(-rng.uniform(0.0, 1.0, n)),
        np.ones(n), device=device)
    tables = voronoi.voronoi_tables(grid, device)
    return march_parity(grid, tables, chi_si, packets, "the parity input")


def march_parity(grid, tables, chi_si, packets, label: str) -> dict:
    """K6 against trace_packets_voronoi_reference on the card, on ``chi_si``
    and ``packets``: no flag or cell mismatch, identical positions and
    tau_left; the tally against the plain version's and, as octree_parity
    holds K5, K6's and the plain f32 tally against the plain march summed in
    f64 (K6's checked at MAX_TALLY_REL_L1).  Both timed, with K6's registers
    and blocks per SM and the bound of the packet steps and real faces the
    plain march took."""
    C = grid.n_cells
    march = dict(eps=voronoi.march_eps(C), max_steps=voronoi.default_max_steps(C))
    chi_u = chi_si * grid.scale
    tally_k, out_k = voronoi.trace_packets_voronoi(grid, chi_si, packets, tables=tables)
    stats = {}
    tally_r, out_r = voronoi.trace_packets_voronoi_reference(
        tables, chi_u, packets, torch.zeros(C, device=chi_si.device), stats=stats, **march)
    tally_64 = voronoi.trace_packets_voronoi_reference(
        tables, chi_u, packets, torch.zeros(C, dtype=torch.float64, device=chi_si.device),
        **march)[0] * grid.scale
    torch.cuda.synchronize()
    max_err = compare_voronoi_marches(
        f"K6 parity (starbench_voronoi grid, {label})", out_k, out_r, tally_k,
        tally_r * grid.scale)
    cell_mismatch = int((out_k.cell != out_r.cell).sum())
    same_state = all(same_bits(getattr(out_k, f), getattr(out_r, f))
                     for f in ("pos", "tau_left", "active", "absorbed"))
    rel_64 = [float((t.double() - tally_64).abs().sum() / tally_64.abs().sum())
              for t in (tally_k, tally_r * grid.scale)]
    # the cells this run's packets crossed: those the plain march deposited in
    visited = tally_64 != 0
    n_visited = int(visited.sum())
    visited_faces = int(tables.face_count[visited].sum())
    log(f"  K6 flags, positions and tau_left identical: {same_state}; tally rel L1 against "
        f"the plain march summed in f64: K6 {rel_64[0]:.3e}, the plain version in f32 "
        f"{rel_64[1]:.3e}")
    check(cell_mismatch == 0 and same_state,
          f"K6 ({label}): {cell_mismatch} cell mismatches, identical state {same_state}")
    check(rel_64[0] <= MAX_TALLY_REL_L1, f"K6's tally rel L1 against f64 {rel_64[0]}")
    del tally_64

    n = packets.cell.numel()
    ms = time_cuda(lambda: voronoi.trace_packets_voronoi(grid, chi_si, packets, tables=tables), 20)
    plain_ms = time_cuda(lambda: voronoi.trace_packets_voronoi_reference(
        tables, chi_u, packets, torch.zeros(C, device=chi_si.device), **march), 1)
    lanes = trace_voronoi_ops.occupancy(chi_si.device)
    log(f"timing K6 ({label}) on {C} cells / {n} packets: K6 {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms per march (CUDA events, incl. the packet-state copy and the "
        f"tally's scaling); K6 {lanes['registers']} registers, "
        f"{lanes['blocks_per_sm']} blocks of 256 per SM")
    steps, faces = int(stats["packet_steps"]), int(stats["face_tests"])
    # of each visited cell: its real faces' packed rows (16 B) and, since a
    # packet may leave by any of them, their neighbours and shifts (16 B), its
    # face count, chi and its tally read (padding is never read); the tally
    # written; packets in: pos, dirn, cell, tau, weight, 2 flags; out: pos,
    # cell, tau, 2 flags
    bound = roofline(f"K6 ({label}; {steps} packet steps, {faces} real faces tested; "
                     f"{n_visited} of {C} cells visited, {visited_faces} real faces)",
                     32 * visited_faces + 12 * n_visited + 4 * C + 60 * n,
                     OPS_PER_VORONOI_FACE * faces + OPS_PER_K6_STEP * steps, F32_OPS_PER_S)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, **bound}


def voronoi_honly(grid, device) -> int:
    """HOnlyVoronoiSimulation on the starbench_voronoi grid with its gas,
    source and microphysics: the ionized volume against the Strömgren
    volume."""
    sim = voronoi.HOnlyVoronoiSimulation(
        grid, lambda p: np.full(len(p), SBV_DENSITY), device=device,
        source_position=(0.0, 0.0, 0.0), luminosity=SBV_LUMINOSITY, cross_section=SBV_SIGMA,
        recombination_rate=SBV_ALPHA, n_photons=SBV_PHOTONS, seed=42)
    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(HONLY_ITERATIONS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.LAUNCHES["trace_voronoi"]
    r_s = (3.0 * SBV_LUMINOSITY / (4.0 * np.pi * SBV_ALPHA * SBV_DENSITY**2)) ** (1.0 / 3.0)
    v_exact = 4.0 / 3.0 * np.pi * r_s**3
    err = sim.ionized_volume() / v_exact - 1.0
    log(f"H-only on the cell graph: {grid.n_cells} cells, {SBV_PHOTONS} packets x "
        f"{HONLY_ITERATIONS} iterations in {wall:.4f} s wall; K6 launches {launches}; "
        f"ionized volume / Stromgren volume - 1 = {err:+.4f} (r_S {r_s / PC:.4f} pc)")
    check(launches == HONLY_ITERATIONS, f"H-only K6 launches {launches}")
    check(bool(torch.isfinite(sim.neutral_fraction).all()), "H-only xH is finite")
    check(abs(err) < MAX_STROMGREN_VOLUME_ERROR, f"H-only ionized volume error {err}")
    return launches


def voronoi_flux_parity(grid, device, dt) -> dict:
    """K7 against voronoi_flux_update_reference on the card, on the
    starbench_voronoi grid: a hot rarefied interior (1e4 K, 1% density) inside
    a dense shell (4x, 300 K) in the 100 K cloud, random velocities of
    ~1e4 m/s and an outward 12 km/s in the shell, made with numpy; second
    and first order; both timed."""
    rng = np.random.default_rng(PARITY_SEED)
    pos_si = generators_si(grid)
    r = np.sqrt((pos_si**2).sum(1))
    inside, shell = r < 0.25 * PC, (r >= 0.25 * PC) & (r < 0.45 * PC)
    nd = SBV_DENSITY * np.where(inside, 0.01, np.where(shell, 4.0, 1.0))
    nd = nd * rng.uniform(0.98, 1.02, r.shape)
    T = np.where(inside, 1e4, np.where(shell, 300.0, 100.0))
    v = rng.normal(size=(len(r), 3)) * 1e4
    v = v + np.where(shell, 1.2e4, 0.0)[:, None] * pos_si / np.maximum(r, 1.0)[:, None]

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    gamma = 1.0001
    state = voronoi_hydro.conserved_from_primitives(
        f32(nd * constants.PROTON_MASS), f32(v[:, 0]), f32(v[:, 1]), f32(v[:, 2]),
        f32(nd * constants.BOLTZMANN * T), None, gamma)
    gen_vel = torch.zeros((grid.n_cells, 3), dtype=torch.float32, device=device)
    tables = voronoi_hydro.hydro_tables(grid, device)
    worst = 0.0
    for second_order in (True, False):
        stats_k, stats_r = {}, {}
        out_k = voronoi_hydro.voronoi_flux_update(
            *tables, state, gen_vel, dt, gamma, second_order, stats=stats_k)
        out_r = voronoi_hydro.voronoi_flux_update_reference(
            *tables, state, gen_vel, dt, gamma, second_order, stats=stats_r)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(out_r._fields, out_r, out_k):
            check(bool(torch.isfinite(b).all()), f"K7: {name} finite")
            errs[name] = float((a - b).abs().max() / a.abs().max())
        identical = all(same_bits(a, b) for a, b in zip(out_r, out_k))
        moved = float((out_r.energy - state.energy).abs().max() / state.energy.abs().max())
        text = ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        text += f"; every field bit for bit: {identical}"
        if second_order:
            same = bool(torch.equal(stats_k["flag"], stats_r["flag"]))
            grads = stats_k["gradients"].abs().sum(-1) > 0  # [5, C]
            share = [float(g.double().mean()) for g in grads]
            nbr = tables.neighbors
            real = nbr != -2
            flag = stats_r["flag"]
            touching = (flag[:, None] | ((nbr >= 0) & flag[nbr.clamp_min(0).long()])) & real
            text += (f"; gradients bit for bit: "
                     f"{same_bits(stats_k['gradients'], stats_r['gradients'])}; trial flags "
                     f"identical: {same} ({int(flag.sum())} flagged, "
                     f"{int(touching.sum())} of {int(real.sum())} real faces touch one); "
                     f"cells with non-zero gradients: rho {share[0]:.4f}, vx {share[1]:.4f}, "
                     f"p {share[4]:.4f}")
            check(same, "K7 trial flags differ from the plain version's")
        log(f"K7 parity, {'second' if second_order else 'first'} order, {grid.n_cells} cells, "
            f"dt {dt:.4e} s: max |diff| / max |field| {text} (the step moved the energy by "
            f"{moved:.3e} of its max)")
        check(moved > 0.0, "the K7 parity step changed the state")
        for name, err in errs.items():
            check(err <= MAX_VORONOI_HYDRO_REL_ERR, f"K7 {name}: {err}")
        worst = max(worst, *errs.values())

    def kernel():
        return voronoi_hydro.voronoi_flux_update(*tables, state, gen_vel, dt, gamma, True)

    ms = time_cuda(kernel, 50)
    plain_ms = time_cuda(lambda: voronoi_hydro.voronoi_flux_update_reference(
        *tables, state, gen_vel, dt, gamma, True), 3)
    split = launch_cost.device_split(kernel, 20)
    log(f"timing K7 (second order) on {grid.n_cells} cells: K7 {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms per update (CUDA events); on the device by kernel (ms a call, "
        f"torch.profiler): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    report, layout = voronoi_flux_ops.ptxas_report(), voronoi_flux_ops.occupancy(device)
    log("  K7's layout: " + "; ".join(
        f"{name}_kernel {report.get(name, {}).get('registers')} registers, "
        f"{report.get(name, {}).get('stack')} B of stack, "
        f"{report.get(name, {}).get('spill_stores')} / {report.get(name, {}).get('spill_loads')}"
        f" B of spill stores / loads"
        + (f", {layout[name]['blocks_per_sm']} blocks of 256 a SM" if name in layout else "")
        for name in voronoi_flux_ops.KERNELS))
    C, K = grid.n_cells, grid.max_faces
    faces = int((grid.neighbors != -2).sum())
    # state in and out, the grid velocity; of the rows (nbr, normals, A/V,
    # two arms) only the real faces' bytes: the padding slots' reads are the
    # kernel's choice, not the function's work
    ops = OPS_PER_K7_FACE * faces + OPS_PER_K7_CELL * C
    old = roofline(f"K7 counting all {C} x {K} slots' rows",
                   40 * C + C * K * 44 + 12 * C, ops, F32_OPS_PER_S)
    bound = roofline(f"K7 (second order; {faces} real faces' rows)", 40 * C + faces * 44 + 12 * C,
                     ops, F32_OPS_PER_S)
    log(f"  K7's bound {bound['bound_ms']:.6f} ms counting the real faces' rows, "
        f"{old['bound_ms']:.6f} ms counting all K slots")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bound}


def starbench_voronoi(grid, device):
    """starbench_voronoi at full size through VoronoiRHDSimulation.run, in ten
    blocks (the front radius at ten outputs), timed with the host clock; then
    16 steps under the profiler, and K6 against its plain version on the last
    march of one more step.  Returns (launches, that parity record)."""
    total_time = 0.141 * MYR
    dt = total_time / SBV_STEPS
    sim = voronoi_hydro.VoronoiRHDSimulation(
        grid, device=device, gamma=1.0001, timestep=dt, luminosity=SBV_LUMINOSITY,
        source_position=(0.0, 0.0, 0.0), cross_section=SBV_SIGMA,
        recombination_rate=SBV_ALPHA, n_photons=SBV_PHOTONS, nloop=SBV_NLOOP,
        number_density=SBV_DENSITY, temperature=100.0, mesh_motion=False, seed=42)
    mass0 = voronoi_hydro.total_mass(sim.state, grid.volumes)
    ends = [round(SBV_STEPS * (i + 1) / 10) for i in range(10)]
    outputs = []
    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = 0
    for end in ends:
        sim.run(end - done)
        done = end
        outputs.append((sim.time, sim.ionization_front_radius()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in ("trace_voronoi", "voronoi_flux")}
    log(f"starbench_voronoi main path: {grid.n_cells} cells, {SBV_NLOOP} x {SBV_PHOTONS} "
        f"packets per step, {SBV_STEPS} steps to {sim.time / MYR:.4f} Myr, static mesh, "
        f"second order, in {wall:.4f} s wall ({wall / SBV_STEPS * 1e3:.4f} ms per step, "
        f"{SBV_STEPS * SBV_NLOOP * SBV_PHOTONS / wall:.6g} packets/s, including ten host "
        f"readbacks of the front radius); launches {launches}")
    r_st = (3.0 * SBV_LUMINOSITY / (4.0 * np.pi * SBV_DENSITY**2 * SBV_ALPHA)) ** (1.0 / 3.0)
    log("  t (Myr)   R (pc)  Spitzer   Hos-In  R/Rsp  R/R_HI")
    for t, r in outputs:
        r_sp, r_hi = spitzer_radius(t, r_st), hosokawa_inutsuka_radius(t, r_st)
        log(f"  {t / MYR:7.4f}  {r / PC:7.4f}  {r_sp / PC:7.4f}  {r_hi / PC:7.4f}  "
            f"{r / r_sp:5.3f}  {r / r_hi:5.3f}")
    check(launches["trace_voronoi"] == SBV_NLOOP * SBV_STEPS, f"K6 launches {launches}")
    check(launches["voronoi_flux"] == SBV_STEPS, f"K7 launches {launches}")
    for name, f in zip(sim.state._fields, sim.state):
        check(bool(torch.isfinite(f).all()), f"starbench_voronoi {name} is finite")
    check(bool(torch.isfinite(sim.neutral_fraction).all()), "starbench_voronoi xH finite")
    p = voronoi_hydro.primitives_from_conserved(sim.state, None, sim.gamma)[4]
    check(float(p.min()) > 0.0, "starbench_voronoi pressure > 0")
    drift = voronoi_hydro.total_mass(sim.state, sim.grid.volumes) / mass0 - 1.0
    log(f"  mass drift over the run: {drift:.3e} (reflective box)")
    check(abs(drift) <= MAX_MASS_DRIFT, f"starbench_voronoi mass drift {drift}")
    t_end, r_end = outputs[-1]
    r_sp, r_hi = spitzer_radius(t_end, r_st), hosokawa_inutsuka_radius(t_end, r_st)
    check(r_end > r_st, f"front {r_end / PC} pc never expanded beyond r_St {r_st / PC} pc")
    check(0.75 * r_sp < r_end < 1.35 * r_hi,
          f"R = {r_end / PC:.4f} pc outside ({0.75 * r_sp / PC:.4f}, {1.35 * r_hi / PC:.4f}) pc")
    profile_window(f"{PROFILED_STEPS} starbench_voronoi steps at t = {sim.time / MYR:.4f} Myr",
                   lambda: sim.run(PROFILED_STEPS),
                   {"K6": ("trace_voronoi_kernel",),
                    "K7": ("primitives_kernel", "gradients_kernel", "trial_kernel",
                           "update_kernel")})
    with capturing(voronoi, "trace_packets_voronoi", {SBV_NLOOP - 1: "last"},
                   lambda grid_, chi_si, packets, **kw: (chi_si.clone(), clone_batch(packets))
                   ) as captured:
        sim.run(1)
    chi_si, packets = captured["last"]
    final = march_parity(grid, sim._march_tables, chi_si, packets,
                         f"the main path's last march, t = {sim.time / MYR:.4f} Myr")
    return launches, final


def clone_batch(packets):
    return type(packets)(*(f.clone() for f in packets))


def profile_window(label: str, run, groups: dict) -> None:
    """Where the time of ``run()`` goes: device time by kernel
    (torch.profiler), summed over the kernel names of each of ``groups``,
    against the host clock of the window; with each group's launches and its
    mean time a launch over the window (total kernel time / launches)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's own events (kernels, copies, sets) only: a torch op's
    # CPU-side event carries its kernels' time too and would count it twice
    averages = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
    device_us = {e.key: e.self_device_time_total for e in averages}
    busy = sum(device_us.values()) * 1e-6
    if busy <= 0.0:
        log(f"profile of {label}: the profiler saw no device time (host clock {wall:.4f} s)")
        return {}
    shares = {name: sum(us for k, us in device_us.items() if any(n in k for n in names)) * 1e-6
              for name, names in groups.items()}
    counts = {name: sum(e.count for e in averages if any(n in e.key for n in names))
              for name, names in groups.items()}
    rest = busy - sum(shares.values())
    n_kernels = sum(e.count for e in averages)
    log(f"profile of {label} (torch.profiler, the same process): host clock {wall:.4f} s, "
        f"device busy {busy:.4f} s ({busy / wall:.4f} of the window; idle "
        f"{1 - busy / wall:.4f}); "
        + ", ".join(f"{name} {t:.4f} s ({t / busy:.4f} of busy; {counts[name]} launches in "
                    f"this window, {t / max(counts[name], 1) * 1e3:.4f} ms a launch in it)"
                    for name, t in shares.items())
        + f", the rest {rest:.4f} s ({rest / busy:.4f}) in {n_kernels} kernel launches in all")
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:8]
    log("  top device time: " + "; ".join(f"{k[:60]} {us * 1e-3:.3f} ms" for k, us in top))
    return {name: (shares[name], counts[name]) for name in groups}


def check_structure(r, xH, xHe, label):
    """tests/test_multifreq_grids.py:_check_structure, copied: ionized core,
    neutral exterior, He front inside (or at) the H front."""
    inner = r < 2.0 * PC
    outer = r > 4.6 * PC
    check(np.median(xH[inner]) < 0.05, f"{label}: core not ionized")
    check(np.median(xH[outer]) > 0.5, f"{label}: exterior not neutral")
    vol_h = (xH < 0.5).sum()
    vol_he = (xHe < 0.5).sum()
    check(0 < vol_he <= vol_h * 1.1, f"{label}: He front ({vol_he}) outside H front ({vol_h})")


def multifreq_voronoi(grid, device):
    """MultiFreqVoronoiSimulation with the diffuse field and the temperature
    balance; the source marches of the first and the last iteration are kept
    for K6s's parity phase."""
    per_iteration = 1 + MF_ROUNDS
    last = per_iteration * (MF_ITERATIONS - 1)
    # the last iteration's source march and its first re-emission generation
    keep = {0: "first", last: "last", last + 1: "generation"}
    sim = voronoi.MultiFreqVoronoiSimulation(
        grid, lambda p: np.full(len(np.atleast_2d(p)), MF_DENSITY), device=device,
        source_position=(0.0, 0.0, 0.0), luminosity=MF_LUMINOSITY, n_photons=MF_PHOTONS,
        abundances=ABUND, do_temperature=True, diffuse_field=True, n_bins=MF_BINS,
        n_reemission_rounds=MF_ROUNDS, seed=11)
    with capturing(voronoi, "trace_packets_voronoi_spectral", keep,
                   lambda grid_, chi_h, chi_he, packets, **kw: (
                       chi_h.clone(), chi_he.clone(), clone_batch(packets))) as captured, \
            capturing(multifreq_simulation.temperature, "solve_temperature",
                      {MF_ITERATIONS - 4: "last solve"}, copy_solve) as solves:
        kernels.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xion, T = sim.run(MF_ITERATIONS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in ("trace_voronoi_spectral", "temperature")}
    transport = sum(t for t, _ in sim.phase_seconds)
    solve = sum(s for _, s in sim.phase_seconds)
    log(f"multi-frequency on the cell graph: {grid.n_cells} cells (cut from the "
        f"64^3-equivalent 262144 generators: their host tessellation would take minutes), "
        f"{MF_PHOTONS} packets x {MF_ITERATIONS} iterations, {MF_BINS} bins, {MF_ROUNDS} "
        f"re-emission generations, temperature balance from iteration 4, in {wall:.4f} s "
        f"wall ({transport:.4f} s transport, {solve:.4f} s solve); launches {launches}")
    log(f"  re-emitted per generation in the last iteration {sim.reemitted[-1].tolist()}; "
        f"secant sweeps (max, mean) {[(int(s.max()), float(s.double().mean())) for s in sim.sweeps]}")
    check(launches["trace_voronoi_spectral"] == MF_ITERATIONS * per_iteration,
          f"K6s launches {launches}")
    check(launches["temperature"] == MF_ITERATIONS - 3, f"K4 launches {launches}")
    r = np.sqrt((generators_si(grid) ** 2).sum(-1))
    x = {name: v.cpu().numpy() for name, v in xion.items()}
    T = T.cpu().numpy()
    for name, value in {"T": T, **x}.items():
        check(value.shape == (grid.n_cells,) and bool(np.isfinite(value).all()),
              f"multi-frequency {name} finite, shape {value.shape}")
    xH, xHe = np.clip(x["H_n"], 0, 1), np.clip(x["He_n"], 0, 1)
    check_structure(r, xH, xHe, "multi-frequency Voronoi")
    T_core = float(np.median(T[r < 2.0 * PC]))
    log(f"  median xH inside 2 pc {float(np.median(xH[r < 2.0 * PC])):.3e}, beyond 4.6 pc "
        f"{float(np.median(xH[r > 4.6 * PC])):.4f}; cells xH<0.5 {int((xH < 0.5).sum())}, "
        f"xHe<0.5 {int((xHe < 0.5).sum())}; median T inside 2 pc {T_core:.1f} K")
    check(4000.0 < T_core < 25000.0, f"median T(r < 2 pc) {T_core}")
    check("last solve" in solves, "the multi-frequency Voronoi run's last temperature solve")
    return launches, sim, captured, solves["last solve"]


def voronoi_spectral_parity(sim, captured, device) -> dict:
    """K6s against trace_packets_voronoi_spectral_reference on the card, on
    the inputs of the multi-frequency run's first and last source marches:
    flags, positions, the binned tally and the ion integrals; both timed on
    the last."""
    grid = sim.grid
    C, K, n_bins = grid.n_cells, grid.max_faces, sim.n_bins
    tables = sim._tables
    march = dict(eps=voronoi.march_eps(C), max_steps=voronoi.default_max_steps(C))
    weights = (sim._sigma_table32, sim._heating32)
    worst = 0.0
    for label in ("first", "last"):
        chi_h, chi_he, packets = captured[label]
        tally_k, out_k = voronoi.trace_packets_voronoi_spectral(
            grid, chi_h, chi_he, packets, n_bins=n_bins, tables=tables)
        stats = {}
        tally_r, out_r = voronoi.trace_packets_voronoi_spectral_reference(
            tables, chi_h * grid.scale, chi_he * grid.scale, packets,
            torch.zeros(n_bins * C, device=device), stats=stats, **march)
        torch.cuda.synchronize()
        tally_k, tally_r = tally_k.reshape(-1), tally_r * grid.scale
        worst = max(worst, compare_voronoi_marches(
            f"K6s parity ({label} iteration's source march)", out_k, out_r, tally_k, tally_r))
        ions_k = traversal.spectral_tallies_to_ion_integrals(tally_k, *weights, C).double()
        ions_r = traversal.spectral_tallies_to_ion_integrals(tally_r, *weights, C).double()
        rel = float(((ions_k - ions_r).abs().sum(1) / ions_r.abs().sum(1).clamp_min(1e-300)).max())
        log(f"  ion integrals rel L1 (worst row) K6s vs plain {rel:.3e}")
        check(rel <= MAX_TALLY_REL_L1, f"K6s ion integrals vs plain {rel}")
    steps, faces = int(stats["packet_steps"]), int(stats["face_tests"])
    ms = time_cuda(lambda: voronoi.trace_packets_voronoi_spectral(
        grid, chi_h, chi_he, packets, n_bins=n_bins, tables=tables), 20)
    plain_ms = time_cuda(lambda: voronoi.trace_packets_voronoi_spectral_reference(
        tables, chi_h * grid.scale, chi_he * grid.scale, packets,
        torch.zeros(n_bins * C, device=device), **march), 1)
    n = packets.cell.numel()
    log(f"timing K6s on {C} cells / {n_bins} bins / {n} packets (the last source march): K6s "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms per march (CUDA events, incl. the packet-state "
        f"copy and the tally's scaling)")
    # tables, chi_H and chi_He read, the binned tally read and written;
    # packets in: K6's plus sigma_H, sigma_He, bin; out: K6's
    bound = roofline(f"K6s ({steps} packet steps, {faces} real faces tested)",
                     C * K * 32 + 8 * C + 8 * n_bins * C + 72 * n,
                     OPS_PER_VORONOI_FACE * faces + OPS_PER_K6S_STEP * steps, F32_OPS_PER_S)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bound}


# ------------------------------------------------------ AMR: K5, K5s, K5d


def uniform_density(value: float):
    return lambda p: np.full(len(np.atleast_2d(p)), value)


def stromgren_amr_setup():
    """stromgren.param through the port's ParameterFile, and the refinement
    of stromgren_amr: (config, geometry, scheme)."""
    config = HOnlyConfig.from_params(ParameterFile(STROMGREN_PARAM))
    scheme = amr.SpatialRefinement((-AMR_ZONE,) * 3, (2 * AMR_ZONE,) * 3, AMR_MAX_LEVEL)
    return config, config.geometry, scheme


def multifreq_amr_setup():
    geometry = GridGeometry(*MF_BOX)
    return geometry, amr.SpatialRefinement((-MFA_ZONE,) * 3, (2 * MFA_ZONE,) * 3, MFA_MAX_LEVEL)


def timed_amr_grid(geometry, scheme, density: float):
    """Build an AMR hierarchy and its octree tables on the host (run in a
    worker process while the kernels build): (grid, build s, octree s)."""
    t0 = time.perf_counter()
    grid = amr.build_amr_grid(geometry, scheme, uniform_density(density),
                              max_level=scheme.max_level)
    t1 = time.perf_counter()
    grid.octree()
    return grid, t1 - t0, time.perf_counter() - t1


def report_amr_grid(label: str, future, n_leaves: int):
    t0 = time.perf_counter()
    grid, t_build, t_octree = future.result()
    waited = time.perf_counter() - t0
    root, children = grid.octree()
    per_level = np.bincount(grid.levels, minlength=grid.max_level + 1).tolist()
    log(f"grid: {label}: {grid.n_cells} leaves, per level {per_level}; {children.shape[0]} "
        f"internal nodes ({children.nbytes / 1e6:.1f} MB of children rows); finest lattice "
        f"{grid.fine_shape}; owner is None: {grid.owner is None}; built on the host in "
        f"{t_build:.2f} s, octree tables {t_octree:.2f} s (set-up, in a worker process); "
        f"the main process waited {waited:.2f} s for it")
    check(grid.n_cells == n_leaves, f"{label}: {grid.n_cells} leaves != {n_leaves}")
    check(grid.owner is None, f"{label} has a dense owner map: not the octree path")
    return grid


def leaf_radius_ratio(r, xH, r_analytic) -> float:
    """50%-crossing radius of the radially binned xH profile over the leaf
    centers / the analytic radius (phase 4's estimator)."""
    rbins = np.linspace(0, r.max(), 80)
    idx = np.digitize(r, rbins)
    sums = np.bincount(idx, weights=xH, minlength=len(rbins) + 1)[1:len(rbins)]
    counts = np.bincount(idx, minlength=len(rbins) + 1)[1:len(rbins)]
    good = counts > 0
    prof = sums[good] / counts[good]
    rmid = (0.5 * (rbins[1:] + rbins[:-1]))[good]
    return float(np.interp(0.5, prof, rmid) / r_analytic)


def stromgren_amr(grid, device):
    """stromgren_amr through AMRIonizationSimulation(..., grid=the worker's
    hierarchy).run(20): the radius ratio and the ionized volume; then two
    profiled iterations.  Returns (sim, K5 launches)."""
    config, geometry, scheme = stromgren_amr_setup()
    sim = amr.AMRIonizationSimulation(
        geometry, scheme, uniform_density(config.number_density), device=device,
        source_position=config.source_position, luminosity=config.luminosity,
        cross_section=config.cross_section, recombination_rate=config.recombination_rate,
        n_photons=AMR_PHOTONS, max_level=AMR_MAX_LEVEL, seed=42, grid=grid)
    with counting_at_cap() as at_cap:
        kernels.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xn = sim.run(config.n_iterations)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernels.LAUNCHES["trace_octree"]
    xn_host = xn.cpu().numpy()
    r_s = (3.0 * config.luminosity / (4.0 * np.pi * config.number_density**2
                                      * config.recombination_rate)) ** (1.0 / 3.0)
    ratio = leaf_radius_ratio(np.sqrt((grid.centers**2).sum(-1)), xn_host.astype(np.float64),
                              r_s)
    volume = sim.ionized_volume() / (4.0 / 3.0 * np.pi * r_s**3)
    n_packets = AMR_PHOTONS * config.n_iterations
    log(f"stromgren_amr main path: {grid.n_cells} leaves (64^3 coarse, level {AMR_MAX_LEVEL} "
        f"in [-2.5 pc, 2.5 pc)^3), {AMR_PHOTONS} packets x {config.n_iterations} "
        f"iterations in {wall:.4f} s wall, cold: the process's first run of the path, with "
        f"the octree tables' copy to the card ({n_packets / wall:.6g} packets/s); K5 launches "
        f"{launches}")
    log(f"  escaped per iteration: {sim.n_escaped.tolist()}; of them still active at the step "
        f"cap: {[int(n) for n in at_cap]}")
    log(f"  50%-radius over leaf centers / analytic ({r_s / PC:.4f} pc): {ratio:.5f}; ionized "
        f"volume / Stromgren volume {volume:.5f}")
    check(launches == config.n_iterations, f"stromgren_amr K5 launches {launches}")
    check(xn_host.shape == (grid.n_cells,) and bool(np.isfinite(xn_host).all()),
          "stromgren_amr xH finite, one per leaf")
    check(bool(((xn_host > 0) & (xn_host <= 1)).all()), "stromgren_amr xH in (0, 1]")
    check(RADIUS_RATIO_RANGE[0] <= ratio <= RADIUS_RATIO_RANGE[1],
          f"stromgren_amr radius ratio {ratio} outside {RADIUS_RATIO_RANGE}")
    profile_window(f"{AMR_PROFILED_ITERATIONS} more stromgren_amr iterations",
                   lambda: sim.run(AMR_PROFILED_ITERATIONS), {"K5": ("trace_octree_kernel",)})
    return sim, launches


@contextlib.contextmanager
def counting_at_cap():
    """While active, each call of ``amr_traversal.trace_packets_octree``
    appends the count of packets its march left active at the step cap (a
    device scalar, read after the run) to the yielded list."""
    original, counts = amr_traversal.trace_packets_octree, []

    def wrapper(*args, **kwargs):
        tally, out = original(*args, **kwargs)
        counts.append(torch.sum(out.active))
        return tally, out

    amr_traversal.trace_packets_octree = wrapper
    try:
        yield counts
    finally:
        amr_traversal.trace_packets_octree = original


def compare_octree_marches(label, out_k, out_r, tally_k, tally_r):
    """Flag mismatches, the largest position difference (coarse units) over
    packets whose flags agree, and the tally's relative L1; checked."""
    n = out_r.px.numel()
    agree = (out_k.absorbed == out_r.absorbed) & (out_k.active == out_r.active)
    flag_mismatch = int((~agree).sum())
    pos_diff = max(float((getattr(out_k, f) - getattr(out_r, f))[agree].abs().max())
                   for f in ("px", "py", "pz"))
    tally_abs = (tally_k - tally_r).abs()
    tally_rel_l1 = float(tally_abs.sum() / tally_r.abs().sum())
    n_absorbed = int(out_r.absorbed.sum())
    log(f"{label}: {n} packets, {n_absorbed} absorbed / {int(out_r.active.sum())} still active "
        f"at the step cap (plain); flag mismatches {flag_mismatch}, max |position diff| "
        f"{pos_diff:.3e} coarse units, tally rel L1 {tally_rel_l1:.3e}, max |tally diff| "
        f"{float(tally_abs.max()):.3e}")
    check(n_absorbed > 0, f"{label}: the input has absorbed packets")
    check(flag_mismatch <= MAX_FLAG_MISMATCH_FRACTION * n,
          f"{label}: flag mismatches {flag_mismatch} > {MAX_FLAG_MISMATCH_FRACTION} of {n}")
    check(pos_diff <= MAX_AMR_POSITION_DIFF, f"{label}: position diff {pos_diff}")
    check(tally_rel_l1 <= MAX_TALLY_REL_L1, f"{label}: tally rel L1 {tally_rel_l1}")
    return float(tally_abs.max())


def octree_bytes(root, children) -> int:
    return 4 * root.numel() + 4 * children.numel()


def octree_parity(sim, device) -> dict:
    """K5 against trace_packets_octree_reference on the card, on the
    stromgren_amr run's final χ and a fresh batch of the run's size from
    the source; both timed."""
    grid = sim.grid
    root, children = grid.octree_tables(device)
    march = dict(coarse_shape=tuple(grid.geometry.shape), max_level=grid.max_level)
    chi = sim.number_density * sim.neutral_fraction * sim.cross_section * float(
        grid.geometry.cell_size[0])
    scale = 2.0 ** (-grid.max_level)  # finest-lattice units → coarse units

    def coarse(packets):
        return packets._replace(px=packets.px * scale, py=packets.py * scale,
                                pz=packets.pz * scale)

    pk = coarse(sim.emit())
    C, n = grid.n_cells, pk.px.numel()

    def zeros():
        return torch.zeros(C, dtype=torch.float32, device=device)

    tally_k, out_k = amr_traversal.trace_packets_octree(root, children, chi, pk, zeros(), **march)
    stats = {}
    (tally_r, out_r), plain_ms = timed_call(lambda: amr_traversal.trace_packets_octree_reference(
        root, children, chi, pk, zeros(), stats=stats, **march))
    max_err = compare_octree_marches("K5 parity (stromgren_amr's final chi, fresh packets)",
                                     out_k, out_r, tally_k, tally_r)
    at_cap = (int(out_k.active.sum()), int(out_r.active.sum()))
    log(f"  packets active at the step cap: K5 {at_cap[0]}, plain {at_cap[1]}")
    check(at_cap[0] == at_cap[1], f"K5 left {at_cap[0]} packets active at the step cap, the "
                                  f"plain version {at_cap[1]}")
    # the tally's summation order: K5's and the plain version's f32 tallies,
    # each against the plain march summed in f64
    tally_64 = amr_traversal.trace_packets_octree_reference(
        root, children, chi, pk, torch.zeros(C, dtype=torch.float64, device=device), **march)[0]
    rel_64 = [float((t.double() - tally_64).abs().sum() / tally_64.abs().sum())
              for t in (tally_k, tally_r)]
    log(f"  tally rel L1 against the plain march summed in f64: K5 {rel_64[0]:.3e}, the plain "
        f"version in f32 {rel_64[1]:.3e}")
    check(rel_64[0] <= MAX_TALLY_REL_L1, f"K5's tally rel L1 against f64 {rel_64[0]}")
    del tally_r, out_r, tally_64
    max_steps = amr_traversal.default_max_steps(march["coarse_shape"], march["max_level"])
    study = octree_study.march_study(stats, max_steps, "K5 parity input, the plain march")
    del stats["steps"], stats["fixed_point_step"]
    occupancy = trace_octree_ops.occupancy(device)
    scratch = zeros()
    ms = time_cuda(lambda: amr_traversal.trace_packets_octree(
        root, children, chi, pk, scratch, **march), 3)
    steps, levels = int(stats["packet_steps"]), int(stats["descent_levels"])
    noops, noop_levels = int(stats["noop_steps"]), int(stats["noop_descent_levels"])
    log(f"timing K5 on {C} leaves / {n} packets ({steps} packet steps, {levels} descent "
        f"levels, {steps / n:.1f} steps per packet; {noops} no-op steps with {noop_levels} "
        f"levels, after the fixed points of {study['fixed_points']} packets): K5 {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms per march (CUDA events, incl. the packet-state copy; the "
        f"plain version's one parity call, with its step counting); K5 {occupancy['registers']} "
        f"registers, {occupancy['blocks_per_sm']} blocks of 256 per SM x {occupancy['sms']} SMs")
    # root, children, chi read, the tally read and written; packets in: 8
    # f32 + 2 flags, out: position, tau, 2 flags
    n_bytes = octree_bytes(root, children) + 12 * C + 52 * n
    roofline(f"K5 with the no-op steps ({steps} packet steps, {levels} descent levels)",
             n_bytes, OPS_PER_K5_STEP * steps + OPS_PER_OCTREE_LEVEL * levels, F32_OPS_PER_S)
    # the bound of the record: the steps that some output needs
    bound = roofline(f"K5 ({steps - noops} packet steps, {levels - noop_levels} descent levels)",
                     n_bytes, OPS_PER_K5_STEP * (steps - noops)
                     + OPS_PER_OCTREE_LEVEL * (levels - noop_levels), F32_OPS_PER_S)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, **bound}


def multifreq_amr(grid, device):
    """MultiFreqAMRSimulation on the deep multi-frequency grid with the
    diffuse field and the temperature balance; the source marches of the
    first and the last iteration and the last generation's absorption sites
    are kept for the parity phase.  Returns (launches, sim, marches,
    sites)."""
    per_iteration = 1 + MF_ROUNDS
    last = per_iteration * (MF_ITERATIONS - 1)
    # the last iteration's source march and its first re-emission generation
    keep = {0: "first", last: "last", last + 1: "generation"}
    sim = amr.MultiFreqAMRSimulation(
        grid, uniform_density(MF_DENSITY), device=device, source_position=(0.0, 0.0, 0.0),
        luminosity=MF_LUMINOSITY, n_photons=MFA_PHOTONS, abundances=ABUND, do_temperature=True,
        diffuse_field=True, n_bins=MF_BINS, n_reemission_rounds=MF_ROUNDS, seed=11)
    with capturing(amr_traversal, "trace_packets_octree_spectral", keep,
                   lambda root, children, chi_h, chi_he, packets, tally2d, **kw: (
                       chi_h.clone(), chi_he.clone(), clone_batch(packets))) as marches, \
            capturing(amr_traversal, "leaf_of_positions", {MF_ROUNDS * MF_ITERATIONS - 1: "last"},
                      lambda root, children, px, py, pz, **kw: (
                          px.clone(), py.clone(), pz.clone())) as sites, \
            timing_call(multifreq_simulation.temperature, "solve_temperature",
                        MF_ITERATIONS - 4) as last_solve:  # the last of the run's K4 solves
        kernels.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xion, T = sim.run(MF_ITERATIONS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name]
                for name in ("trace_octree_spectral", "leaf_of_positions", "temperature")}
    transport = sum(t for t, _ in sim.phase_seconds)
    solve = sum(s for _, s in sim.phase_seconds)
    log(f"multi-frequency AMR: {grid.n_cells} leaves (16^3 coarse, level {MFA_MAX_LEVEL} in "
        f"[-1.5 pc, 1.5 pc)^3), {MFA_PHOTONS} packets x {MF_ITERATIONS} iterations, {MF_BINS} "
        f"bins, {MF_ROUNDS} re-emission generations, temperature balance from iteration 4, in "
        f"{wall:.4f} s wall ({transport:.4f} s transport, {solve:.4f} s solve); launches "
        f"{launches}")
    log("  per iteration: transport s, solve s, re-emitted packets per generation")
    for k, ((t_tr, t_sv), counts) in enumerate(zip(sim.phase_seconds, sim.reemitted)):
        log(f"  {k + 1:2d}  {t_tr:.4f}  {t_sv:.4f}  {counts.tolist()}")
    log(f"  secant sweeps (max, mean) "
        f"{[(int(s.max()), float(s.double().mean())) for s in sim.sweeps]}")
    check(launches["trace_octree_spectral"] == MF_ITERATIONS * per_iteration,
          f"K5s launches {launches}")
    check(launches["leaf_of_positions"] == MF_ITERATIONS * MF_ROUNDS, f"K5d launches {launches}")
    check(launches["temperature"] == MF_ITERATIONS - 3, f"K4 launches {launches}")
    check("result" in last_solve, "the multi-frequency AMR run's last K4 solve was timed")
    solve_ms = last_solve["start"].elapsed_time(last_solve["end"])
    sweeps, n_solve = int(last_solve["result"].sweeps.sum()), last_solve["first"].numel()
    log(f"the multi-frequency AMR's last temperature solve on {n_solve} leaves: {solve_ms:.4f} ms "
        f"(K4 and its wrapper: CUDA events around the run's own call of solve_temperature; "
        f"K4 alone in the profile below), {sweeps} secant sweeps "
        f"(max {int(last_solve['result'].sweeps.max())})")
    roofline(f"K4 (multi-frequency AMR, the last solve; {sweeps} secant sweeps)",
             n_solve * (18 * 8 + 15 * 8 + 4), OPS_PER_K4_SWEEP * sweeps, F64_OPS_PER_S)
    k4_layout("the multi-frequency AMR's last solve", "K4", n_solve,
              last_solve["result"].sweeps, "K4 (no plain run at this size)")
    r = np.sqrt((grid.centers**2).sum(-1))
    x = {name: v.cpu().numpy() for name, v in xion.items()}
    T = T.cpu().numpy()
    for name, value in {"T": T, **x}.items():
        check(value.shape == (grid.n_cells,) and bool(np.isfinite(value).all()),
              f"multi-frequency AMR {name} finite, shape {value.shape}")
    xH, xHe = np.clip(x["H_n"], 0, 1), np.clip(x["He_n"], 0, 1)
    check_structure(r, xH, xHe, "multi-frequency AMR")
    inner = r < 2.0 * PC
    T_core, o_core = float(np.median(T[inner])), float(np.median(x["O_n"][inner]))
    log(f"  median xH inside 2 pc {float(np.median(xH[inner])):.3e}, beyond 4.6 pc "
        f"{float(np.median(xH[r > 4.6 * PC])):.4f}; leaves xH<0.5 {int((xH < 0.5).sum())}, "
        f"xHe<0.5 {int((xHe < 0.5).sum())}; median T inside 2 pc {T_core:.1f} K, median O_n "
        f"{o_core:.3e}")
    check(4000.0 < T_core < 25000.0, f"multi-frequency AMR median T(r < 2 pc) {T_core}")
    check(o_core < 0.5, f"multi-frequency AMR median O_n(r < 2 pc) {o_core}")
    check(set(marches) == {"first", "last", "generation"} and "last" in sites,
          "the multi-frequency AMR run's marches and absorption sites were kept")
    profile_window("one more multi-frequency AMR iteration", lambda: sim.run(1),
                   {"K5s": ("trace_octree_spectral_kernel",),
                    "K5d": ("leaf_of_positions_kernel",), "K4": ("temperature_kernel",)})
    return launches, sim, marches, sites["last"]


def ptxas_layout(library: str, kernel: str) -> dict:
    """Registers, stack and spill bytes of ``kernel`` from the ptxas report in
    the build log of ``csrc/<library>.cu``."""
    found, current = {}, False
    text = build.library_path(library).with_suffix(".log").read_text()
    for line in text.splitlines():
        if "Function properties for" in line:
            current = kernel in line
        elif current and "bytes stack frame" in line:
            numbers = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            found.update(stack=numbers[0], spill_stores=numbers[1], spill_loads=numbers[2])
        elif current and "Used" in line and "registers" in line:
            found["registers"] = int(line.split("Used")[1].split()[0])
            current = False
    return found


def same_states(out_k, out_r) -> int:
    """Packets whose position, tau_left or flags differ in any bit."""
    differ = torch.zeros_like(out_r.active)
    for f in ("px", "py", "pz", "tau_left"):
        differ |= getattr(out_k, f).view(torch.int32) != getattr(out_r, f).view(torch.int32)
    for f in ("active", "absorbed"):
        differ |= getattr(out_k, f) != getattr(out_r, f)
    return int(differ.sum())


def amr_spectral_parity(sim, marches, device) -> dict:
    """K5s against trace_packets_octree_spectral_reference on the card, on
    the inputs of the multi-frequency AMR run's first and last source
    marches: every final state identical, the binned tally and the ion
    integrals within their bounds; both timed on the last; K5s's layout and
    its time on the last iteration's first re-emission generation."""
    grid = sim.grid
    root, children = grid.octree_tables(device)
    C, n_bins = grid.n_cells, sim.n_bins
    march = dict(coarse_shape=tuple(grid.geometry.shape), max_level=grid.max_level,
                 n_bins=n_bins)
    weights = (sim._sigma_table32, sim._heating32)

    def zeros():
        return torch.zeros(n_bins * C, dtype=torch.float32, device=device)

    worst = 0.0
    for label in ("first", "last"):
        chi_h, chi_he, packets = marches[label]
        tally_k, out_k = amr_traversal.trace_packets_octree_spectral(
            root, children, chi_h, chi_he, packets, zeros(), **march)
        stats = {}
        (tally_r, out_r), plain_ms = timed_call(
            lambda: amr_traversal.trace_packets_octree_spectral_reference(
                root, children, chi_h, chi_he, packets, zeros(), stats=stats, **march))
        worst = max(worst, compare_octree_marches(
            f"K5s parity ({label} iteration's source march)", out_k, out_r, tally_k, tally_r))
        differ = same_states(out_k, out_r)
        log(f"  packets whose final state differs from the plain version's in any bit: {differ}")
        check(differ == 0, f"K5s final states differ from the plain version's in {differ}")
        ions_k = traversal.spectral_tallies_to_ion_integrals(tally_k, *weights, C).double()
        ions_r = traversal.spectral_tallies_to_ion_integrals(tally_r, *weights, C).double()
        rel = float(((ions_k - ions_r).abs().sum(1) / ions_r.abs().sum(1).clamp_min(1e-300)).max())
        log(f"  ion integrals rel L1 (worst row) K5s vs plain {rel:.3e}")
        check(rel <= MAX_INTEGRAL_REL_L1, f"K5s ion integrals vs plain {rel}")
        del tally_k, tally_r, ions_k, ions_r, out_k, out_r
    max_steps = amr_traversal.default_max_steps(march["coarse_shape"], march["max_level"])
    study = octree_study.march_study(stats, max_steps, "K5s parity input, the last source march")
    del stats["steps"], stats["fixed_point_step"]
    steps, levels = int(stats["packet_steps"]), int(stats["descent_levels"])
    noops, noop_levels = int(stats["noop_steps"]), int(stats["noop_descent_levels"])
    scratch = zeros()
    ms = time_cuda(lambda: amr_traversal.trace_packets_octree_spectral(
        root, children, chi_h, chi_he, packets, scratch, **march), 5)
    n = packets.px.numel()
    occupancy = trace_octree_spectral_ops.occupancy(device)
    layout = ptxas_layout(trace_octree_spectral_ops.NAME, "trace_octree_spectral_kernel")
    log(f"timing K5s on {C} leaves / {n_bins} bins / {n} packets (the last source march, "
        f"{steps} packet steps, {levels} descent levels; {noops} no-op steps with {noop_levels} "
        f"levels, after the fixed points of {study['fixed_points']} packets): K5s {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms per march (CUDA events, incl. the packet-state copy and the "
        f"order; the plain version's one parity call, with its step counting); K5s "
        f"{layout.get('registers')} registers, {layout.get('stack')} B of stack, "
        f"{layout.get('spill_stores')} / {layout.get('spill_loads')} B of spill stores / loads, "
        f"{occupancy['blocks_per_sm']} blocks of 256 per SM x {occupancy['sms']} SMs")
    chi_h_g, chi_he_g, generation = marches["generation"]
    n_active = int(generation.active.sum())
    gen_ms = time_cuda(lambda: amr_traversal.trace_packets_octree_spectral(
        root, children, chi_h_g, chi_he_g, generation, scratch, **march), 5)
    log(f"timing K5s on the last iteration's first re-emission generation: {n_active} of "
        f"{generation.px.numel()} packets active ({n_active / generation.px.numel():.4f}): "
        f"{gen_ms:.4f} ms per march (CUDA events, incl. the packet-state copy and the order)")
    # root, children, chi_H and chi_He read, the binned tally read and
    # written; packets in: K5's plus sigma_H, sigma_He, bin; out: K5's
    n_bytes = octree_bytes(root, children) + 8 * C + 8 * n_bins * C + 64 * n
    roofline(f"K5s with the no-op steps ({steps} packet steps, {levels} descent levels)",
             n_bytes, OPS_PER_K5S_STEP * steps + OPS_PER_OCTREE_LEVEL * levels, F32_OPS_PER_S)
    # the bound of the record: the steps that some output needs
    bound = roofline(f"K5s ({steps - noops} packet steps, {levels - noop_levels} descent levels)",
                     n_bytes, OPS_PER_K5S_STEP * (steps - noops)
                     + OPS_PER_OCTREE_LEVEL * (levels - noop_levels), F32_OPS_PER_S)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bound}


def leaf_descent_parity(sim, sites, device) -> dict:
    """K5d against leaf_of_positions_reference on the card, on the last
    re-emission generation's absorption sites: identical leaf ids; both
    timed."""
    grid = sim.grid
    root, children = grid.octree_tables(device)
    march = dict(coarse_shape=tuple(grid.geometry.shape), max_level=grid.max_level)
    leaf_k = amr_traversal.leaf_of_positions(root, children, *sites, **march)
    stats = {}
    leaf_r = amr_traversal.leaf_of_positions_reference(root, children, *sites, stats=stats,
                                                       **march)
    torch.cuda.synchronize()
    mismatch = int((leaf_k != leaf_r).sum())
    n, levels = sites[0].numel(), int(stats["descent_levels"])
    ms = time_cuda(lambda: amr_traversal.leaf_of_positions(root, children, *sites, **march), 20)
    plain_ms = time_cuda(lambda: amr_traversal.leaf_of_positions_reference(
        root, children, *sites, **march), 3)
    log(f"K5d parity (the last generation's absorption sites): {n} points, {levels} descent "
        f"levels, leaf id mismatches {mismatch}; K5d {ms:.4f} ms, plain {plain_ms:.4f} ms per "
        f"descent (CUDA events)")
    check(mismatch == 0 and leaf_k.dtype == torch.int32, f"K5d leaf ids differ in {mismatch}")
    # root and children read; 3 f32 in, one int32 out per point
    bound = roofline(f"K5d ({levels} descent levels)", octree_bytes(root, children) + 16 * n,
                     OPS_PER_K5D_POINT * n + OPS_PER_OCTREE_LEVEL * levels, F32_OPS_PER_S)
    return {"max_abs_err": float(mismatch), "ms": ms, "plain_ms": plain_ms, **bound}


# ------------------------------------------------------ dust: K8 and K8p


def load_dust_reference() -> dict:
    """tests/torch_dust_reference.npz (the JAX package's images of
    DUSTY_GALAXY_PARAMS), checked to be of this configuration."""
    with np.load(DUST_REFERENCE) as f:
        ref = {k: f[k] for k in f.files}
    check(json.loads(str(ref["params"])) == json.loads(json.dumps(DUSTY_GALAXY_PARAMS)),
          f"{DUST_REFERENCE} was made for other parameters; run tests/torch_dust_reference.py")
    return ref


def dust_bars(pairs: np.ndarray) -> dict:
    """The image thresholds: twice the envelope of the JAX package's seed
    pairs, never looser than the bars of benchmarks/RESULTS.md:191-195
    (correlation >= 0.98, centroid within 0.5 px, profile <= 0.06); the total
    flux has no bar there."""
    worst = dict(zip(DUST_MEASURES, pairs.min(0)))
    worst.update({k: float(np.abs(pairs[:, i]).max()) for i, k in enumerate(DUST_MEASURES)
                  if k != "correlation"})
    return {"correlation": max(DUST_BARS["correlation"], 1.0 - 2.0 * (1.0 - worst["correlation"])),
            "centroid_px": min(DUST_BARS["centroid_px"], 2.0 * worst["centroid_px"]),
            "profile": min(DUST_BARS["profile"], 2.0 * worst["profile"]),
            "flux": 2.0 * worst["flux"]}


def check_image(label: str, image: np.ndarray, reference: np.ndarray, pairs: np.ndarray):
    m = image_measures(reference, image)
    bars = dust_bars(pairs)
    log(f"  {label} against the JAX image (seed 1): correlation {m['correlation']:.5f} "
        f"(>= {bars['correlation']:.5f}), centroid {m['centroid_px']:.4f} px (<= "
        f"{bars['centroid_px']:.4f}), profile {m['profile']:.4f} (<= {bars['profile']:.4f}), "
        f"flux {m['flux']:+.5f} (|.| <= {bars['flux']:.5f}); the JAX seeds' pairs: "
        f"correlation {pairs[:, 0].min():.5f}-{pairs[:, 0].max():.5f}, centroid <= "
        f"{pairs[:, 1].max():.4f} px, profile <= {pairs[:, 2].max():.4f}, |flux| <= "
        f"{np.abs(pairs[:, 3]).max():.5f}")
    check(image.shape == reference.shape and bool(np.isfinite(image).all()) and image.sum() > 0,
          f"{label}: finite, positive, of shape {reference.shape}")
    check(m["correlation"] >= bars["correlation"], f"{label} correlation {m['correlation']}")
    check(m["centroid_px"] <= bars["centroid_px"], f"{label} centroid {m['centroid_px']} px")
    check(m["profile"] <= bars["profile"], f"{label} profile {m['profile']}")
    check(abs(m["flux"]) <= bars["flux"], f"{label} flux {m['flux']}")


def copy_peel_off(chi, position, weight, active, ccd, *, view, direction=None, **kw):
    return (position.clone(), weight.clone(), active.clone(),
            None if direction is None else direction.clone(), kw)


def copy_peel_off_polarized(chi, position, direction, nref, stokes, active, planes, **kw):
    return (position.clone(), direction.clone(), nref.clone(),
            tuple(s.clone() for s in stokes), active.clone(), kw)


def timed_run(run):
    """(run(), host seconds), synchronised, with the launches of the run."""
    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(kernels.LAUNCHES)


def dusty_galaxy(device, ref):
    """Phase 26: DUSTY_GALAXY_PARAMS through ParameterFile ->
    dust_config_from_params -> DustSimulation(config, device="cuda").run(),
    cold and warm, against the JAX image; then one profiled run and one run
    whose peel-off inputs are kept for phase 28.  Returns (sim, launches,
    captured inputs by call number)."""
    config = dust_simulation.dust_config_from_params(ParameterFile(DUSTY_GALAXY_PARAMS))
    t0 = time.perf_counter()
    sim = dust_simulation.DustSimulation(config, device=device, seed=DUST_SEED)
    log(f"dusty_galaxy: {config.geometry.shape} cells, {config.n_photons} photons, "
        f"{config.n_scatterings} orders, {config.ccd_pixels} CCD, theta "
        f"{np.degrees(config.view_theta):.4f} deg; chi built on the host in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    image, cold, launches = timed_run(sim.run)
    orders = list(sim.scattered_per_order)
    _, warm, _ = timed_run(sim.run)
    log(f"dusty_galaxy main path (intensity): {cold:.4f} s wall cold (the process's first run "
        f"of the path), {warm:.4f} s warm; launches {launches}; scattering events per order "
        f"{orders}")
    scattering = sum(c > 0 for c in orders)
    check(launches.get("trace_packets") == len(orders), f"K1 launches {launches}")
    check(launches.get("peel_off") == 1 + scattering, f"K8 launches {launches}")
    check(orders[-1] == 0 or len(orders) == config.n_scatterings, f"orders {orders}")
    check(all(a >= b for a, b in zip(orders, orders[1:])), f"events per order: {orders}")
    check_image("intensity image", image.cpu().numpy(), ref["image_a"], ref["pairs_intensity"])
    profile_window("one more dusty_galaxy intensity run", sim.run,
                   {"K1": ("trace_packets_kernel",), "K8": ("peel_off_kernel",)})
    keep = {i: i for i in range(1 + config.n_scatterings)}
    with capturing(peel_off, "peel_off_deposit", keep, copy_peel_off) as captured:
        sim.run()
    return sim, {k: launches.get(k, 0) for k in ("trace_packets", "peel_off")}, captured


def dusty_galaxy_polarized(sim, ref):
    """Phase 27: the same configuration through run_polarized(): I against
    the JAX I plane, the image-integrated Q/I and U/I against the JAX seeds,
    |V|; then one profiled run and one whose K8p inputs are kept."""
    planes, wall, launches = timed_run(sim.run_polarized)
    orders = list(sim.scattered_per_order)
    log(f"dusty_galaxy main path (polarized): {wall:.4f} s wall, the process's first polarized "
        f"run; launches {launches}; scattering events per order {orders}")
    check(launches.get("peel_off") == 1, f"K8 launches {launches}")
    check(launches.get("peel_off_polarized") == sum(c > 0 for c in orders),
          f"K8p launches {launches}")
    host = {k: v.cpu().numpy().astype(np.float64) for k, v in planes.items()}
    check_image("polarized I", host["I"], ref["pol_I_a"], ref["pairs_polarized_I"])
    for k in "QU":
        ours = host[k].sum() / host["I"].sum()
        theirs = ref[f"pol_{k}I"].astype(np.float64)
        bar = 2.0 * float(theirs.max() - theirs.min())
        log(f"  {k}/I {ours:+.6f}; the JAX seeds {np.round(theirs, 6).tolist()}, seed 1 "
            f"{theirs[0]:+.6f}: |diff| {abs(ours - theirs[0]):.6f} (<= {bar:.6f}, twice the "
            f"seeds' range)")
        check(abs(ours - theirs[0]) <= bar, f"{k}/I {ours} vs JAX {theirs[0]}")
    v_ratio = float(np.abs(host["V"]).max() / host["I"].max())
    log(f"  max |V| / max I {v_ratio:.3e} (p_c = 0)")
    check(v_ratio <= 1e-8, f"|V| / max I {v_ratio}")
    profile_window("one more dusty_galaxy polarized run", sim.run_polarized,
                   {"K1": ("trace_packets_kernel",), "K8": ("peel_off_kernel",),
                    "K8p": ("peel_off_polarized_kernel",)})
    keep = {i: i for i in range(sim.config.n_scatterings)}
    with capturing(peel_off, "peel_off_deposit_polarized", keep,
                   copy_peel_off_polarized) as captured:
        sim.run_polarized()
    return {k: launches.get(k, 0) for k in ("trace_packets", "peel_off",
                                             "peel_off_polarized")}, captured


def compare_peel_off(label, n_active, tau_k, pix_k, tau_r, pix_r, active, planes_k, planes_r):
    """Identical τ and pixels over the active events, each image's relative
    L1; checked.  Returns the largest |image difference|."""
    tau_same = bool(torch.equal(tau_k[active], tau_r[active]))
    pix_same = bool(torch.equal(pix_k[active], pix_r[active]))
    rel = [float((a - b).abs().sum() / b.abs().sum().clamp_min(1e-30))
           for a, b in zip(planes_k, planes_r)]
    worst = max(float((a - b).abs().max()) for a, b in zip(planes_k, planes_r))
    log(f"{label}: {n_active} active events of {active.numel()}; tau identical {tau_same}, "
        f"pixels identical {pix_same}, image rel. L1 "
        + ", ".join(f"{r:.3e}" for r in rel) + f", max |diff| {worst:.3e}")
    check(tau_same and pix_same, f"{label}: tau or pixels differ")
    check(max(rel) <= MAX_PEEL_OFF_REL_L1, f"{label}: image rel. L1 {rel}")
    return worst


def active_steps(chi, position, active, view) -> int:
    """The march steps the active events need (the kernels march only
    those; the plain version marches every event, as the JAX driver does)."""
    stats = {}
    peel_off.peel_off_tau_reference(chi, position[active], view=view, stats=stats)
    return int(stats["packet_steps"])


def peel_off_parity(sim, captured) -> dict:
    """Phase 28, K8: against peel_off_deposit_reference on the inputs of the
    intensity run's emission peel-off and of its last scattering order's;
    both timed (the plain version from its parity call).  The record's times
    and bound are the emission peel-off's, the main path's largest K8
    launch."""
    view, chi = sim.view, sim.chi
    npix = view.pixels[0] * view.pixels[1]
    last = max(captured)
    worst, record = 0.0, None
    for label, key in (("emission", 0), (f"order {last}", last)):
        position, weight, active, direction, kw = captured[key]
        n, n_active = position.shape[0], int(active.sum())
        tau_k = torch.empty(n, device=chi.device)
        pix_k = torch.empty(n, dtype=torch.int32, device=chi.device)
        ccd_k, ccd_r = (torch.zeros(npix, device=chi.device) for _ in range(2))
        peel_off_cuda(chi, position, direction, weight, active, ccd_k, view=view,
                      tau_out=tau_k, pix_out=pix_k, **kw)
        factor = peel_off.peel_off_factor(weight, direction, view=view, **kw)
        (tau_r, pix_r), plain_ms = timed_call(lambda: peel_off.peel_off_deposit_reference(
            chi, position, factor, active, ccd_r, view=view))
        worst = max(worst, compare_peel_off(f"K8 parity ({label})", n_active, tau_k, pix_k,
                                            tau_r, pix_r, active, (ccd_k,), (ccd_r,)))
        scratch = torch.zeros(npix, device=chi.device)
        ms = time_cuda(lambda: peel_off.peel_off_deposit(
            chi, position, weight, active, scratch, view=view, direction=direction, **kw), 20)
        steps = active_steps(chi, position, active, view)
        log(f"timing K8 ({label}, {n} events, {n_active} active, {steps} march steps): K8 "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms per peel-off (CUDA events; the plain one's "
            f"parity call)")
        if record is None:
            # chi, every event's flag, the position and weight (and direction)
            # of the active events only (an inactive one reads its flag and
            # returns), the image read and written
            per_active = 16 + (0 if direction is None else 12)
            ops = OPS_PER_K8_STEP * steps + OPS_PER_K8_EVENT * n_active
            if direction is not None:
                ops += OPS_PER_K8_PHASE * n_active
            bound = roofline(f"K8 ({label}: {steps} steps, {n_active} active events)",
                             4 * chi.numel() + n + per_active * n_active + 8 * npix, ops,
                             F32_OPS_PER_S)
            record = {"ms": ms, "plain_ms": plain_ms, **bound}
    return {"max_abs_err": worst, **record}


def peel_off_polarized_parity(sim, captured) -> dict:
    """Phase 28, K8p: against peel_off_polarized_reference on the inputs of
    the polarized run's first and last scattering orders; both timed (the
    plain version from its parity call).  The record's times and bound are
    the first order's, the main path's largest K8p launch."""
    view, chi = sim.view, sim.chi
    npix = view.pixels[0] * view.pixels[1]
    last = max(captured)
    worst, record = 0.0, None
    for label, key in (("order 1", 0), (f"order {last + 1}", last)):
        position, direction, nref, stokes, active, kw = captured[key]
        band = kw["band"]
        n, n_active = position.shape[0], int(active.sum())
        tau_k = torch.empty(n, device=chi.device)
        pix_k = torch.empty(n, dtype=torch.int32, device=chi.device)
        planes_k, planes_r = ([torch.zeros(npix, device=chi.device) for _ in range(4)]
                              for _ in range(2))
        peel_off_polarized_cuda(chi, position, direction, nref, stokes, active, planes_k,
                                view=view, band=band, tau_out=tau_k, pix_out=pix_k)
        (tau_r, pix_r), plain_ms = timed_call(lambda: peel_off.peel_off_polarized_reference(
            chi, position, direction, nref, stokes, active, planes_r, view=view, band=band))
        worst = max(worst, compare_peel_off(f"K8p parity ({label})", n_active, tau_k, pix_k,
                                            tau_r, pix_r, active, planes_k, planes_r))
        scratch = [torch.zeros(npix, device=chi.device) for _ in range(4)]
        ms = time_cuda(lambda: peel_off.peel_off_deposit_polarized(
            chi, position, direction, nref, stokes, active, scratch, view=view, band=band), 20)
        steps = active_steps(chi, position, active, view)
        log(f"timing K8p ({label}, {n} events, {n_active} active, {steps} march steps): K8p "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms per peel-off (CUDA events; the plain one's "
            f"parity call)")
        if record is None:
            # chi, every event's flag, the position, direction, normal and
            # Stokes vector of the active events only; four planes read and
            # written
            bound = roofline(f"K8p ({label}: {steps} steps, {n_active} active events)",
                             4 * chi.numel() + n + 52 * n_active + 32 * npix,
                             OPS_PER_K8_STEP * steps + OPS_PER_K8P_EVENT * n_active,
                             F32_OPS_PER_S)
            record = {"ms": ms, "plain_ms": plain_ms, **bound}
    return {"max_abs_err": worst, **record}


# ------------------------------------------------ K9c, K9p: the sharded drivers


def copy_args(*args, **kwargs):
    """Positional tensors (and tuples of them) cloned, the rest as they are."""
    def clone(a):
        if torch.is_tensor(a):
            return a.clone()
        if isinstance(a, (tuple, list)) and a and torch.is_tensor(a[0]):
            return type(a)(t.clone() for t in a)
        return a
    return tuple(clone(a) for a in args), dict(kwargs)


def copy_exchange(mesh, fields, mask, target, axis, capacity):
    return (mesh, [tuple(f.clone() for f in fs) for fs in fields],
            [m.clone() for m in mask], [t.clone() for t in target], axis, capacity)


def copy_segments(segments, capacity):
    """A K9c call's segments (fields, mask) cloned, the fields as the call
    gave them (a 2-D tensor or a tuple), and its capacity."""
    def clone(fields):
        return fields.clone() if torch.is_tensor(fields) else tuple(f.clone() for f in fields)
    return tuple((clone(f), m.clone()) for f, m in segments), capacity


def compact_concatenation(segments, capacity):
    """compact_reference of the concatenation of ``segments``, the fields
    stacked as K9c gives them: the plain version of a K9c call."""
    fields = [torch.cat(rows) for rows in zip(*(f for f, _ in segments))]
    out, in_range, overflow = parallel_domain.compact_reference(
        fields, torch.cat([m for _, m in segments]), capacity)
    return torch.stack(out), in_range, overflow


def partition_stacked(fields, bucket, capacities, shifts=(None, None)):
    """partition_reference with each bucket's fields stacked as K9p gives them."""
    return [(torch.stack(f), r, o) for f, r, o in
            parallel_domain.partition_reference(fields, bucket, capacities, shifts)]


def sharded_stromgren(config: HOnlyConfig, single_volume: int):
    """Phase 29: stromgren.param through ShardedHOnlyIonizationSimulation on
    (2, 2, 2) tiles, all eight shards on the card."""
    sim = ShardedHOnlyIonizationSimulation(config, tiling=SHARDED_STROMGREN_TILING, seed=42)
    with capturing(domain3d, "_exchange_axis", {0: "first"}, copy_exchange) as kept:
        kernels.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xH = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: kernels.LAUNCHES[k] for k in ("trace_packets", "compact", "partition")}
    xH_host = xH.cpu().numpy()
    ratio = stromgren_radius_ratio(sim, xH_host)
    volume = int((xH_host < 0.5).sum())
    totals = sim.total_diagnostics
    log(f"sharded stromgren: {config.geometry.shape} on {SHARDED_STROMGREN_TILING} tiles "
        f"({sim.n_devices} shards on {torch.cuda.device_count()} card), {config.n_photons} "
        f"packets x {config.n_iterations} iterations in {wall:.4f} s wall, cold; launches "
        f"{launches}; supersteps {totals['supersteps']} "
        f"({totals['supersteps'] / config.n_iterations:.2f} per iteration); escaped "
        f"{totals['n_escaped']}, overflow {totals['buffer_overflow']}, truncated "
        f"{totals['truncated_live']}; last iteration's packets traced per shard "
        f"{sim.last_diagnostics['packets_traced'].reshape(-1).tolist()}")
    log(f"sharded stromgren: 50%-radius / analytic {ratio:.5f}; ionized cells {volume} "
        f"against the single-device run's {single_volume} "
        f"({volume / single_volume - 1:+.5f})")
    check(RADIUS_RATIO_RANGE[0] <= ratio <= RADIUS_RATIO_RANGE[1],
          f"sharded radius ratio {ratio} outside {RADIUS_RATIO_RANGE}")
    check(abs(volume / single_volume - 1.0) <= MAX_SHARDED_DEVIATION,
          f"sharded ionized volume {volume} vs {single_volume}")
    check(totals["buffer_overflow"] == 0 and totals["truncated_live"] == 0,
          f"sharded stromgren: overflow / truncation {totals}")
    check(bool(np.isfinite(xH_host).all()) and xH_host.shape == tuple(config.geometry.shape),
          "sharded xH finite, of the grid's shape")
    check(launches["compact"] > 0 and launches["partition"] > 0,
          f"K9c / K9p launched on the sharded stromgren path: {launches}")
    check("first" in kept, "an exchange of the sharded stromgren run was kept")
    return launches, kept["first"]


def sharded_starbench(device, single_outputs):
    """Phase 30: starbench.param through ShardedRHDSimulation.from_params on
    (4, 1, 1) slabs, all four shards on the card; the snapshot callback ends
    the run at the output SHARDED_STARBENCH_FRACTION of the way."""
    prev = os.getcwd()
    os.chdir(BENCHMARKS)
    try:
        params = ParameterFile(STARBENCH_PARAM)
        # warm-up: a throwaway driver takes two steps
        ShardedRHDSimulation.from_params(params, tiling=SHARDED_STARBENCH_TILING,
                                         seed=7).advance(2)
        sim = ShardedRHDSimulation.from_params(params, tiling=SHARDED_STARBENCH_TILING, seed=42)
    finally:
        os.chdir(prev)
    cfg = sim.config
    n_outputs = round(10 * SHARDED_STARBENCH_FRACTION)
    n_cells = sim.geometry.n_cells
    mass0 = float(sim.state.rho.double().sum())
    outputs = []

    class Cut(Exception):
        """Raised by the snapshot callback to end the run at the cut."""

    def snapshot(s, index):
        outputs.append((index, s.time, s.ionization_front_radius(), time.perf_counter() - t0))
        if index == n_outputs:
            raise Cut

    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        sim.run(snapshot_callback=snapshot)
    except Cut:
        pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    state, xH = sim.state, sim.neutral_fraction
    n_steps = len(sim.supersteps)
    launches = {k: kernels.LAUNCHES[k]
                for k in ("trace_packets", "hydro_step", "compact", "partition")}
    supersteps = np.asarray(sim.supersteps)
    totals = sim.total_diagnostics
    shards = sim.n_devices
    log(f"sharded starbench: {cfg.geometry.shape} on {SHARDED_STARBENCH_TILING} slabs "
        f"({shards} shards on {torch.cuda.device_count()} card), {cfg.nloop} x {cfg.n_photons} "
        f"packets per step, {n_steps} steps to {sim.time / MYR:.4f} Myr (cut at output "
        f"{n_outputs} of the file's {cfg.total_time / MYR:.4f} Myr) in {wall:.4f} s "
        f"wall, warm ({wall / n_steps * 1e3:.4f} ms per step, {n_steps * n_cells / wall:.6g} "
        f"cell-updates/s); launches {launches}")
    log(f"sharded starbench: supersteps per step mean {supersteps.mean():.4f}, max "
        f"{supersteps.max()}, total {supersteps.sum()} (each one host read of the live "
        f"count); steps with supersteps {int((supersteps > 0).sum())}, from step "
        f"{int(np.argmax(supersteps > 0)) + 1}; escaped {totals['n_escaped']}, overflow "
        f"{totals['buffer_overflow']}, truncated {totals['truncated_live']}")
    check(launches["hydro_step"] == shards * n_steps, f"K3 launches {launches}")
    check(launches["trace_packets"] == shards * (cfg.nloop * n_steps + supersteps.sum()),
          f"K1 launches {launches}: {shards} x ({cfg.nloop} x {n_steps} + {supersteps.sum()})")
    check(launches["partition"] == shards * supersteps.sum(), f"K9p launches {launches}")
    check(launches["compact"] == shards * (cfg.nloop * n_steps + supersteps.sum()),
          f"K9c launches {launches}")
    check(launches["partition"] > 0, "K9p launched on the sharded starbench path")
    check(totals["buffer_overflow"] == 0 and totals["truncated_live"] == 0,
          f"sharded starbench: overflow / truncation {totals}")
    for name, f in zip(state._fields, state):
        check(bool(torch.isfinite(f).all()), f"sharded {name} is finite")
    drift = float(state.rho.double().sum()) / mass0 - 1.0
    log(f"sharded starbench: mass drift {drift:.3e}")
    check(abs(drift) <= MAX_MASS_DRIFT, f"sharded mass drift {drift}")
    n_h = mass0 / n_cells / constants.PROTON_MASS
    r_st = (3 * cfg.luminosity / (4 * np.pi * n_h**2 * cfg.recombination_rate)) ** (1 / 3)
    log("  t (Myr)   R (pc)  R single  R/R_single  R/Rsp  wall (s)")
    for (index, t, r, at), (_, _, r1) in zip(outputs, single_outputs):
        log(f"  {t / MYR:7.4f}  {r / PC:7.3f}  {r1 / PC:8.3f}  {r / r1:10.4f}  "
            f"{r / spitzer_radius(t, r_st):5.3f}  {at:8.3f}")
    check([o[0] for o in outputs] == list(range(1, n_outputs + 1)), f"outputs {outputs}")
    for (_, t, r, _), (_, t1, r1) in zip(outputs, single_outputs):
        check(abs(t / t1 - 1.0) < 1e-9, f"output times {t} vs {t1}")
        check(abs(r / r1 - 1.0) <= MAX_SHARDED_DEVIATION,
              f"sharded R({t / MYR:.4f} Myr) = {r / PC:.4f} pc vs single {r1 / PC:.4f} pc")
    t_end, r_end = outputs[-1][1], outputs[-1][2]
    lo, hi = 0.85 * spitzer_radius(t_end, r_st), 1.1 * hosokawa_inutsuka_radius(t_end, r_st)
    check(lo < r_end < hi, f"sharded R({t_end / MYR:.4f} Myr) = {r_end / PC:.3f} pc outside "
                           f"({lo / PC:.3f}, {hi / PC:.3f}) pc")

    kernels.LAUNCHES.clear()
    profiled = profile_window(
        f"one sharded starbench step at t = {sim.time / MYR:.4f} Myr",
        lambda: sim.advance(1, log_every=10**9),
        {"K1": ("trace_packets_kernel",), "K3": ("muscl_",),
         "K9c": ("exchange_kernel<1",), "K9p": ("exchange_kernel<2",)})
    log(f"  the profiled step: {sim.supersteps[-1]} supersteps, launches {dict(kernels.LAUNCHES)}")
    # one more step, whose copy phase and first superstep (the four slabs'
    # K9c copy-phase calls first, then their K9p sends and their K9c merges
    # of the two received buffers) are kept for phase 31, and the shape of
    # its every K9p call
    keep = {i: i for i in range(shards)}
    compactions = {**{i: ("copy", i) for i in range(shards)},
                   **{shards + i: ("merge", i) for i in range(shards)}}
    with capturing(parallel_domain, "partition", keep, copy_args) as sends, \
            capturing(parallel_domain, "compact_segments", compactions,
                      copy_segments) as kept, recording_partitions() as shapes:
        sim.advance(1, log_every=10**9)
    check(len(sends) == shards and len(kept) == 2 * shards,
          f"kept {len(sends)} sends and {len(kept)} compactions of the first superstep")
    capacity = parallel_domain.default_capacity(cfg.n_photons)
    lanes = {label: [m.numel() for _, m in segments] for label, (segments, _) in kept.items()}
    check(all(args[1].numel() == 2 * cfg.n_photons for args, _ in sends.values())
          and all(lanes[("merge", i)] == [capacity, capacity] for i in range(shards))
          and all(len(lanes[("copy", i)]) == 1 for i in range(shards)),
          f"the kept calls are the copy phase's, the first superstep's sends (2W lanes) and "
          f"merges (two received buffers): {lanes}")
    return launches, sends, kept, {"shapes": shapes, "profiled": profiled.get("K9p")}


@contextlib.contextmanager
def recording_partitions():
    """While active, each call of ``parallel_domain.partition`` appends its
    shape to the yielded list: (lanes, members of each bucket, capacities,
    the bytes :func:`exchange_bytes` charges it)."""
    original, shapes = parallel_domain.partition, []

    def wrapper(fields, bucket, capacities, shifts=(None, None)):
        members = [bucket == 0, bucket == 1]
        shapes.append((bucket.numel(), [int(m.sum()) for m in members], tuple(capacities),
                       exchange_bytes(len(fields), members, capacities)))
        return original(fields, bucket, capacities, shifts)

    parallel_domain.partition = wrapper
    try:
        yield shapes
    finally:
        parallel_domain.partition = original


def exchange_bytes(n_fields: int, members, capacities) -> int:
    """Each input byte that reaches an output read once: every lane's code
    (one byte), and the fields of the lanes that land in some bucket (a
    bucket's first ``capacity`` members, then its first capacity - members
    non-members, as compact.cu reads them). Each output byte written once
    (the fields, in_range, the two counts). ``members`` holds one bool
    tensor per bucket."""
    n = members[0].numel()
    landed = torch.zeros(n, dtype=torch.bool, device=members[0].device)
    lane = torch.arange(n, device=members[0].device)
    for m, capacity in zip(members, capacities):
        before = torch.cumsum(m, 0) - m.long()
        landed |= torch.where(m, before < capacity, int(m.sum()) + lane - before < capacity)
    return (n_fields * 4 * int(landed.sum()) + n
            + sum(n_fields * 4 * c + c + 16 for c in capacities))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def compare_compactions(label, kernel_out, plain_out) -> None:
    """Every lane, every bit, every count of a K9c or K9p result (a list of
    (fields, in_range, overflow)) against its plain version's."""
    for b, ((f, r, o), (fr, rr, orr)) in enumerate(zip(kernel_out, plain_out)):
        lanes = [same_bits(x, y) for x, y in zip(f, fr)]
        check(all(lanes), f"{label} bucket {b}: fields {lanes}")
        check(torch.equal(r, rr), f"{label} bucket {b}: in_range")
        check(int(o) == int(orr), f"{label} bucket {b}: overflow {int(o)} vs {int(orr)}")


def argsort_gather(fields, mask, capacity):
    """The same compaction as one composition of PyTorch calls (a stable
    argsort and a gather), timed beside K9c as its library yardstick."""
    idx = torch.argsort((~mask).to(torch.uint8), stable=True)[:min(capacity, mask.numel())]
    return [f[idx] for f in fields]


def exchange_parity(starbench_sends, starbench_compactions, stromgren_exchange, step) -> tuple:
    """Phase 31: K9p and K9c against their plain versions on the sharded
    runs' own inputs, every lane and bit and count, and timed at the
    starbench shapes (the slab that sent, and the one that received, the
    most packets); K9p also on every slab's send, its host µs per call, and
    the shapes and bound of every K9p call of one step (``step``, from
    phase 30)."""
    members = {}
    for slab, ((fields, bucket, capacities, shifts), _) in sorted(starbench_sends.items()):
        out = parallel_domain.partition(fields, bucket, capacities, shifts)
        ref = parallel_domain.partition_reference(fields, bucket, capacities, shifts)
        compare_compactions(f"K9p (sharded starbench, slab {slab})", out, ref)
        members[slab] = [int((bucket == b).sum()) for b in (0, 1)]
    log(f"K9p parity on the last sharded starbench step's first superstep, every slab: "
        f"{bucket.numel()} lanes (exits and pending), buckets of {capacities}, members "
        f"(left, right) per slab {members}: identical in every lane, bit and count")
    slab_ms = {}
    for slab, ((fields, bucket, capacities, shifts), _) in sorted(starbench_sends.items()):
        slab_ms[slab] = time_cuda(
            lambda: parallel_domain.partition(fields, bucket, capacities, shifts), 50)
    log("timing K9p on each slab's send (CUDA events, ms per call): "
        + ", ".join(f"slab {k} {v:.4f}" for k, v in slab_ms.items()))
    slab = max(members, key=lambda k: sum(members[k]))
    (fields, bucket, capacities, shifts), _ = starbench_sends[slab]
    ms = slab_ms[slab]
    plain_ms = time_cuda(
        lambda: parallel_domain.partition_reference(fields, bucket, capacities, shifts), 10)
    host = launch_cost.host_us(
        {"K9p": lambda: parallel_domain.partition(fields, bucket, capacities, shifts)}, 2000)
    device_ms = launch_cost.graph_ms(
        lambda: parallel_domain.partition(fields, bucket, capacities, shifts))
    layout = compact_ops.occupancy(bucket.device)
    p_bytes = exchange_bytes(len(fields), [bucket == 0, bucket == 1], capacities)
    log(f"timing K9p on slab {slab}'s {bucket.numel()} lanes ({members[slab]} sent), buckets "
        f"of {capacities}: K9p {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events); on the "
        f"device alone {device_ms:.4f} ms (a CUDA graph of 50 calls, launch_cost.graph_ms); host "
        f"{host['K9p']:.3f} us per call (launch_cost.host_us); {layout['registers']} registers, "
        f"{layout['blocks_per_sm']} blocks of {compact_ops.TILE} a SM x "
        f"{layout['sms']} SMs, one launch a call")
    p_record = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                **roofline("K9p", p_bytes, 0.0, F32_OPS_PER_S)}
    shapes = step["shapes"]
    sent = np.array([sum(m) for _, m, _, _ in shapes])
    mean_bytes = float(np.mean([b for *_, b in shapes]))
    profiled = step["profiled"]
    log(f"K9p's real calls in one sharded starbench step: {len(shapes)} calls, lanes "
        f"{sorted({n for n, *_ in shapes})}, capacities {sorted({c for _, _, c, _ in shapes})}, "
        f"packets sent min / median / max {int(sent.min())} / {float(np.median(sent)):.1f} / "
        f"{int(sent.max())}; mean bound {mean_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms (bytes, "
        f"{mean_bytes:.6g} B a call); the profiled step's K9p "
        + (f"{profiled[0] / max(profiled[1], 1) * 1e3:.4f} ms a launch over {profiled[1]} "
           f"launches" if profiled else "not seen by the profiler"))

    for label in ("copy", "merge"):
        counts = {}
        for (kind, slab), (segments, cap) in sorted(starbench_compactions.items()):
            if kind != label:
                continue
            compare_compactions(f"K9c (sharded starbench, slab {slab}, the {label})",
                                [parallel_domain.compact_segments(segments, cap)],
                                [compact_concatenation(segments, cap)])
            counts[slab] = ([m.numel() for _, m in segments], [int(m.sum()) for _, m in segments])
        log(f"K9c parity on the {label} calls of that step, every slab ((lanes, members) of each "
            f"segment per slab {counts}, capacity {cap}): identical in every lane, bit and count "
            f"to compact_reference of the concatenation")
    merges = {slab: v for (kind, slab), v in starbench_compactions.items() if kind == "merge"}
    received = {slab: sum(int(m.sum()) for _, m in segments)
                for slab, (segments, _) in merges.items()}
    slab = max(received, key=received.get)
    segments, mcap = merges[slab]
    whole = ([torch.cat(rows) for rows in zip(*(f for f, _ in segments))],
             torch.cat([m for _, m in segments]))

    def merge():
        return parallel_domain.compact_segments(segments, mcap)

    ms = time_cuda(merge, 50)
    device_ms = launch_cost.graph_ms(merge)
    host = launch_cost.host_us({"K9c": merge}, 2000)["K9c"]
    plain_ms = time_cuda(lambda: parallel_domain.compact_reference(*whole, mcap), 10)
    library_ms = time_cuda(lambda: argsort_gather(*whole, mcap), 10)
    layout = compact_ops.occupancy(whole[1].device, compact_ops.COMPACT)
    log(f"timing K9c on slab {slab}'s merge (received buffers of "
        f"{[m.numel() for _, m in segments]} lanes read in place, {received[slab]} packets "
        f"received, capacity {mcap}): (a) K9c "
        f"{ms:.4f} ms a call back to back (CUDA events), (b) {device_ms:.4f} ms on the device "
        f"alone (a CUDA graph of 50 calls, launch_cost.graph_ms), (c) host {host:.3f} us a call "
        f"(launch_cost.host_us); plain {plain_ms:.4f} ms (on the concatenation), stable "
        f"argsort + gather {library_ms:.4f} ms; {layout['registers']} registers, "
        f"{layout['blocks_per_sm']} blocks of {compact_ops.TILE} a SM x {layout['sms']} SMs, "
        f"one launch a call")
    c_record = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                **roofline("K9c", exchange_bytes(len(whole[0]), [whole[1]], (mcap,)),
                           0.0, F32_OPS_PER_S), "library_ms": library_ms}

    # one x exchange of the sharded stromgren run, every shard
    mesh, sfields, smask, starget, axis, capacity = stromgren_exchange
    my = mesh.axis_index(axis)
    lanes = 0
    for i in range(mesh.size):
        go_minus = smask[i] & (starget[i] < my[i])
        go_plus = smask[i] & (starget[i] > my[i])
        codes = parallel_domain.bucket_codes(go_minus, go_plus)
        compare_compactions(f"K9p (sharded stromgren, shard {i})",
                            parallel_domain.partition(sfields[i], codes, (capacity,) * 2),
                            parallel_domain.partition_reference(sfields[i], codes,
                                                                (capacity,) * 2))
        lanes += int(go_minus.sum() + go_plus.sum())
    kernel_result = domain3d._exchange_axis(mesh, sfields, smask, starget, axis, capacity)
    with contextlib.ExitStack() as stack:
        stack.enter_context(swapped(domain3d, "partition", partition_stacked))
        stack.enter_context(swapped(domain3d, "compact_segments", compact_concatenation))
        plain_result = domain3d._exchange_axis(mesh, sfields, smask, starget, axis, capacity)
    for i in range(mesh.size):
        compare_compactions(f"K9c (sharded stromgren exchange, shard {i})",
                            [(kernel_result[0][i], kernel_result[1][i], kernel_result[2][i])],
                            [(plain_result[0][i], plain_result[1][i], plain_result[2][i])])
    log(f"K9p and K9c parity on the sharded stromgren run's first {axis} exchange: "
        f"{mesh.size} shards of {smask[0].numel()} lanes, {lanes} packets sent, capacity "
        f"{capacity}: identical in every lane, bit and count")
    return c_record, p_record


# ------------------------------------------- K10, K11, K11r (phases 32-34)


def finish_with_k1(chi, tally, pf, pi, shape):
    """K1 on the lanes a cone march left at state 0, from their position,
    direction, τ_left and weight, into ``tally`` (in place): (flat tally,
    absorbed packets, stragglers), the counts on the device."""
    left = pi[:, 3] == 0
    stragglers = traversal.make_packets(
        pf[:, :3], pf[:, 3:6], pf[:, 6].contiguous(), pf[:, 7].contiguous(),
        shape)._replace(active=left)
    tally, finished = traversal.trace_packets(chi.reshape(-1), stragglers, tally.reshape(-1),
                                              shape=shape)
    return tally, (pi[:, 3] == 1).sum() + (finished.absorbed & left).sum(), left.sum()


def cone_iteration(sim: HOnlyIonizationSimulation, generator, x):
    """One iteration of the cone Strömgren path from neutral fraction ``x``:
    stratified emission → pack → K10 → the lanes still at state 0 through
    K1 from their position, direction, τ_left and weight → the tally scaled
    as ``_h_only_iteration_body`` scales it (n_photons = CONE_PHOTONS) → the
    H balance.  Returns (new x, stragglers, escaped), the counts on the
    device."""
    cfg, shape = sim.config, sim.geometry.shape
    chi = sim.number_density * x * (cfg.cross_section * sim.dx)
    pf, pi = cone.pack_packets(*octa.emit_point_source_stratified(
        generator, CONE_PHOTONS, sim._source_gpos, sim.device), shape)
    tally, pf, pi = cone.trace_packets_cone(chi, pf, pi, shape=shape)
    tally, absorbed, left = finish_with_k1(chi, tally, pf, pi, shape)
    jfac_scale = (cfg.luminosity * cfg.cross_section * sim.dx
                  / (CONE_PHOTONS * sim.geometry.cell_volume))
    jH = tally.reshape(shape) * jfac_scale
    new_x = ionization.hydrogen_neutral_fraction(jH, sim.number_density, cfg.recombination_rate)
    return new_x, left, CONE_PHOTONS - absorbed


def cone_stromgren(config: HOnlyConfig, device, single_volume: int):
    """Phase 32: stromgren.param's geometry, gas, source, σ and α with
    CONE_PHOTONS stratified packets per iteration through K10 and the K1
    finish, 20 iterations, warm."""
    sim = HOnlyIonizationSimulation(config, device=device)
    initial = sim.neutral_fraction.clone()
    generator = torch.Generator(device=device)
    generator.manual_seed(42)

    def run(x, n):
        counts = []
        for _ in range(n):
            x, left, escaped = cone_iteration(sim, generator, x)
            counts.append((left, escaped))
        return x, counts

    run(initial, 2)  # warm-up
    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, counts = run(initial, config.n_iterations)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in ("trace_packets_cone", "trace_packets")}
    stragglers = [int(c[0]) for c in counts]
    escaped = [int(c[1]) for c in counts]
    xH = x.cpu().numpy()
    ratio = stromgren_radius_ratio(sim, xH)
    volume = int((xH < 0.5).sum())
    n_packets = CONE_PHOTONS * config.n_iterations
    log(f"cone stromgren: {config.geometry.shape}, {CONE_PHOTONS} stratified packets x "
        f"{config.n_iterations} iterations in {wall:.4f} s wall, warm "
        f"({n_packets / wall:.6g} packets/s); launches {launches}")
    log(f"cone stromgren: stragglers finished by K1 per iteration {stragglers}; escaped per "
        f"iteration {escaped}")
    log(f"cone stromgren: 50%-radius / analytic {ratio:.5f}; ionized cells {volume} against "
        f"phase 4's {single_volume} ({volume / single_volume - 1:+.5f})")
    check(launches["trace_packets_cone"] == config.n_iterations
          and launches["trace_packets"] == config.n_iterations,
          f"K10 and K1 launched once per iteration: {launches}")
    check(bool(np.isfinite(xH).all()) and xH.shape == tuple(config.geometry.shape),
          "cone xH finite, of the grid's shape")
    check(bool(((xH > 0) & (xH <= 1)).all()), "cone xH in (0, 1]")
    check(RADIUS_RATIO_RANGE[0] <= ratio <= RADIUS_RATIO_RANGE[1],
          f"cone radius ratio {ratio} outside {RADIUS_RATIO_RANGE}")
    check(abs(volume / single_volume - 1.0) <= MAX_CONE_VOLUME_DEVIATION,
          f"cone ionized cells {volume} vs {single_volume}")
    # the main path's driver (phase 4 ran it cold), warm against the cone wall
    driver = HOnlyIonizationSimulation(config, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    driver.run()
    torch.cuda.synchronize()
    driver_wall = time.perf_counter() - t0
    driver_packets = config.n_photons * config.n_iterations
    log(f"cone stromgren: the main path's driver (K1, {config.n_photons} packets x "
        f"{config.n_iterations} iterations) in {driver_wall:.4f} s wall, warm "
        f"({driver_packets / driver_wall:.6g} packets/s); cone / driver per packet "
        f"{(wall / n_packets) / (driver_wall / driver_packets):.4f}")
    profile_window(f"{CONE_PROFILED_ITERATIONS} more cone stromgren iterations",
                   lambda: run(x, CONE_PROFILED_ITERATIONS),
                   {"K10": ("trace_packets_cone_kernel",), "K1": ("trace_packets_kernel",)})
    return sim, x, launches


def cone_parity(sim: HOnlyIonizationSimulation, final_x, device) -> dict:
    """Phase 33: K10 against its plain version, and K10 + the K1 finish
    against K1 alone, on a fully neutral χ and phase 32's final χ, on every
    lane of a 2^20 stratified batch; K10 timed beside the plain version, K1
    on the same packets and K1 on them in a random order."""
    cfg, shape = sim.config, sim.geometry.shape
    ncell = int(np.prod(shape))
    generator = torch.Generator(device=device)
    generator.manual_seed(PARITY_SEED)
    packets = octa.emit_point_source_stratified(generator, CONE_PHOTONS, sim._source_gpos,
                                                device)
    pf, pi = cone.pack_packets(*packets, shape)
    n = pf.shape[0]
    k1_packets = traversal.make_packets(*packets, shape)
    # the same packets in a random order: each warp's lanes point anywhere
    order = torch.randperm(n, generator=generator, device=device)
    k1_shuffled = traversal.make_packets(*(p[order] for p in packets), shape)
    sigma_dx = cfg.cross_section * sim.dx
    fields = {"fully neutral (x = 1)": sim.number_density * sigma_dx,
              "phase 32's final": sim.number_density * final_x * sigma_dx}
    record = {"max_abs_err": 0.0}
    for label, chi in fields.items():
        chi = chi.contiguous()
        tally_k, pf_k, pi_k = cone.trace_packets_cone(chi, pf, pi, shape=shape)
        stats = {}
        (tally_r, pf_r, pi_r), plain_ms = timed_call(
            lambda: cone.trace_packets_cone_reference(chi, pf, pi, shape=shape, stats=stats))
        unplaced = stats["unplaced"]
        state_mismatch = int((pi_k[:, 3] != pi_r[:, 3]).sum())
        same = (pi_k[:, 3] == pi_r[:, 3]) & ~unplaced
        pos_diff = float((pf_k[same, :3] - pf_r[same, :3]).abs().max())
        cell_mismatch = int((pi_k[same, :3] != pi_r[same, :3]).any(dim=1).sum())
        # the plain version leaves a lane whose tau_left lies between its slab
        # sum and its prefix scans where it entered the slab; K10 must absorb
        # it further along its ray, within the slab's diagonal
        ahead = unplaced & (pi_k[:, 3] == 1)
        step = pf_k[ahead, :3] - pf_r[ahead, :3]
        along = (step * pf_r[ahead, 3:6]).sum(dim=1)
        off_ray = float((step - along[:, None] * pf_r[ahead, 3:6]).abs().max()) if len(along) else 0.0
        n_unplaced = int(unplaced.sum())
        tally_abs = (tally_k - tally_r).abs()
        rel_l1 = float(tally_abs.sum() / tally_r.abs().sum())
        states = torch.bincount(pi_r[:, 3], minlength=3).tolist()
        log(f"K10 parity ({label} chi, every one of {n} lanes): plain states (active, absorbed, escaped) {states}; state "
            f"mismatches {state_mismatch}, lanes the plain version absorbed where they entered "
            f"the slab {n_unplaced} (K10 absorbed {len(along)} of them further along, "
            f"{[round(float(a), 4) for a in along[:8]]} cells), cell mismatches where the states "
            f"agree {cell_mismatch}, max |position diff| {pos_diff:.3e} cells, tally rel L1 "
            f"{rel_l1:.3e}; plain {plain_ms:.4f} ms (one call, CUDA events)")
        check(state_mismatch + n_unplaced <= MAX_FLAG_MISMATCH_FRACTION * n,
              f"K10 state mismatches {state_mismatch} and unplaced lanes {n_unplaced} of {n}")
        check(pos_diff <= MAX_CONE_POSITION_DIFF, f"K10 position diff {pos_diff}")
        check(bool(((along >= -MAX_CONE_POSITION_DIFF)
                    & (along <= SLAB_DIAGONAL + MAX_CONE_POSITION_DIFF)).all())
              and off_ray <= MAX_CONE_POSITION_DIFF,
              f"K10 on the unplaced lanes: along {along.tolist()}, off the ray {off_ray}")
        check(rel_l1 <= MAX_CONE_TALLY_REL_L1, f"K10 tally rel L1 {rel_l1}")
        record["max_abs_err"] = max(record["max_abs_err"], float(tally_abs.max()))

        # the estimator: K10 + the K1 finish against K1 alone
        tally_c, absorbed_c, _ = finish_with_k1(chi, tally_k.clone(), pf_k, pi_k, shape)
        absorbed_c = int(absorbed_c)
        tally_1, out_1 = traversal.trace_packets(chi.reshape(-1), k1_packets,
                                                 torch.zeros(ncell, device=device), shape=shape)
        absorbed_1 = int(out_1.absorbed.sum())
        est_l1 = float((tally_c - tally_1).abs().sum() / tally_1.abs().sum())
        log(f"K10 + K1 finish against K1 alone ({label} chi, {n} packets): tally rel L1 "
            f"{est_l1:.3e}, absorbed {absorbed_c} against {absorbed_1}")
        check(est_l1 <= MAX_CONE_TALLY_REL_L1, f"cone estimator rel L1 {est_l1}")
        check(abs(absorbed_c - absorbed_1) <= MAX_CONE_ABSORBED_FRACTION * n,
              f"cone absorbed {absorbed_c} vs K1 {absorbed_1}")

        # times on the same 2^20 lanes
        ms = time_cuda(lambda: cone.trace_packets_cone(chi, pf, pi, shape=shape), 20)
        scratch = torch.zeros(ncell, device=device)
        k1_ms = time_cuda(lambda: traversal.trace_packets(chi.reshape(-1), k1_packets, scratch,
                                                          shape=shape), 20)
        k1_shuffled_ms = time_cuda(lambda: traversal.trace_packets(
            chi.reshape(-1), k1_shuffled, scratch, shape=shape), 20)
        stats = {}
        traversal.trace_packets_reference(chi.reshape(-1), k1_packets, scratch.clone(),
                                          shape=shape, stats=stats)
        steps = int(stats["packet_steps"])
        log(f"timing at {shape[0]}^3 / {n} stratified packets ({label} chi): K10 "
            f"{ms:.4f} ms, K1 on the same packets {k1_ms:.4f} ms (K10 / K1 = "
            f"{ms / k1_ms:.4f}), K1 on them in a random order {k1_shuffled_ms:.4f} ms "
            f"(shuffled / stratified = {k1_shuffled_ms / k1_ms:.4f}); plain cone march "
            f"{plain_ms:.4f} ms (CUDA events, incl. the packet-state copies)")
        # chi read, tally read and written; 64 B in and 64 B out per lane;
        # K1's operations per packet-cell crossing of these packets
        bound = roofline(f"K10 ({label} chi; {steps} packet-cell crossings)",
                         12 * ncell + 128 * CONE_PHOTONS, OPS_PER_K1_STEP * steps,
                         F32_OPS_PER_S)
        record.update({"ms": ms, "plain_ms": plain_ms, **bound})  # the final chi's stay
    return record


def gather_phase(device) -> tuple:
    """Phase 34: the microbenchmark on the card at the tool's sizes, then
    K11 and K11r against their plain versions and timed beside their
    one-call PyTorch counterparts."""
    t_phase = time.perf_counter()
    kernels.LAUNCHES.clear()
    microbench_scatter.main(device=device)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in ("gather", "gather2d")}
    log(f"microbenchmark: launches {launches}")
    check(launches["gather"] > 0 and launches["gather2d"] > 0,
          f"K11 and K11r launched by the microbenchmark: {launches}")

    rng = np.random.default_rng(PARITY_SEED)
    n, n_cell, width = 1 << 20, 64**3, microbench_scatter.LANES
    idx_np = rng.integers(0, n_cell, n).astype(np.int32)
    idx_np[:2] = (0, n_cell - 1)  # the table's first and last entries
    idx = torch.tensor(idx_np, device=device)
    tbl = torch.tensor(rng.normal(size=n_cell).astype(np.float32), device=device)
    tbl2 = tbl.reshape(-1, width)
    rows, lanes = idx // width, idx % width
    records = []
    for label, fn, plain, library, args, index_bytes in (
        ("K11", gather_ops.gather, gather_ops.gather_reference, lambda t, i: t[i],
         (tbl, idx), 4),
        ("K11r", gather_ops.gather2d, gather_ops.gather2d_reference,
         lambda t, r, l: t[r, l], (tbl2, rows, lanes), 8),
    ):
        out, ref = fn(*args), plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"{label} differs from its plain version")
        summary = "identical"
        if label == "K11":
            def refill():
                tbl.copy_(torch.tensor(rng.normal(size=n_cell).astype(np.float32)))
                idx.copy_(torch.tensor(rng.integers(0, n_cell, n).astype(np.int32)))

            summary += "; " + launch_path_parity(
                "gather", fn, args, refill, lambda out, a: torch.equal(out, a[0][a[1].long()]))
        ms = time_cuda(lambda: fn(*args), 50)
        plain_ms = time_cuda(lambda: plain(*args), 50)
        library_ms = time_cuda(lambda: library(*args), 50)
        log(f"{label} parity on {n} random indices (the table's first and last entries "
            f"among them): {summary}; timing {label} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"the one PyTorch call {library_ms:.4f} ms (CUDA events)")
        if label == "K11":  # where a call's time goes, at the microbenchmark's inputs
            launch_cost.measure(label, "the microbenchmark's",
                                launch_cost.microbench_inputs(device))
        bound = roofline(label, (index_bytes + 4) * n + 4 * n_cell, 0.0, F32_OPS_PER_S)
        records.append({"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **bound,
                        "library_ms": library_ms})
    log(f"phase 34 took {time.perf_counter() - t_phase:.2f} s")
    return launches, records


def sector_bytes(offsets: torch.Tensor) -> int:
    """Bytes of the distinct 32-byte sectors that hold the f32 elements at the
    flat ``offsets`` of one table."""
    return 32 * int(torch.unique(offsets.reshape(-1).long() // 8).numel())


def unaligned_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` on its device that starts 4 bytes past a
    16-byte boundary (a view with a storage offset)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


def host_bits(out) -> tuple:
    """A call's output tensors as int32 views on the host, to compare bit for
    bit; read on the current stream."""
    return tuple(o.view(torch.int32).cpu() for o in (out if isinstance(out, tuple) else (out,)))


def launch_path_parity(name: str, fn, args: tuple, refill, agree) -> str:
    """The checks of a kernel on ``kernels/launch.py`` beyond its parity: one
    launch a call (``kernels.LAUNCHES[name]``); the same bits on a side stream
    while the default stream is busy; captured into a CUDA graph and replayed
    twice, each time after ``refill()`` has written new inputs into ``args``,
    with ``agree(out, args)`` holding the graph's output to the plain
    version.  Returns a summary."""
    kernels.LAUNCHES.clear()
    expected = host_bits(fn(*args))
    check(kernels.LAUNCHES[name] == 1, f"{name}: {kernels.LAUNCHES[name]} launches in one call")
    busy = torch.randn((4096, 4096), device=args[0].device)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    for _ in range(8):
        busy = busy @ busy / 64.0
    with torch.cuda.stream(side):
        got = host_bits(fn(*args))  # the side stream's only synchronise
    check(all(torch.equal(a, b) for a, b in zip(got, expected)),
          f"{name} on a side stream differs from its call on the default stream")
    del busy
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    for replay in range(2):
        refill()
        graph.replay()
        torch.cuda.synchronize()
        check(agree(out, args), f"{name} differs from its plain version after graph replay "
                                f"{replay + 1}")
    del graph, out
    return "one launch a call, the same bits on a side stream, two graph replays agree"


# The probes of phase 35 (tools/probe_pallas_gather.py): the record's name,
# its ``b_*`` function and the def line of the Pallas kernel each replaces
PROBE_KERNELS = (
    ("K12t", "take_along_lanes", probe_pallas_gather.b_taa_lanes, 59),
    ("K12r", "row_gather", probe_pallas_gather.b_row_gather, 81),
    ("K11r", "flat_gather_2d", probe_pallas_gather.b_flat_gather_2d, 104),
    ("K12s", "sublane_gather", probe_pallas_gather.b_sublane_gather, 128),
    ("K12a", "scatter_add", probe_pallas_gather.b_scatter_add, 155),
)
PROBE_LOOKUPS = 1 << 20  # the larger parity size: many waves of blocks
MAX_SCATTER_ADD_REL_L1 = 1e-6  # K12a with duplicates and random f32 weights


def probe_plain(label: str):
    """The plain version of a probe kernel, on its ``b_*`` function's arguments."""
    return {
        "K12t": probe_gather.take_along_lanes_reference,
        "K12r": probe_gather.row_gather_reference,
        "K11r": gather_ops.gather2d_reference,
        "K12s": probe_gather.sublane_gather_reference,
        "K12a": lambda idx, val: probe_gather.scatter_add_reference(
            idx, val, (probe_pallas_gather.SCATTER_N // 128, 128)),
    }[label]


def probe_inputs(label: str, rng, n: int, device, weights: str = "integer") -> tuple:
    """Seeded arguments of a probe kernel with ``n`` lookups into the
    probe's table (K12t: ``n`` rows of 128), the table's first and last
    entries among them; K12a's indices have duplicates, its weights are
    small integers (sums exact in any order) or uniform in [0, 1)."""
    def table(rows, width):
        return torch.tensor(rng.standard_normal((rows, width), dtype=np.float32), device=device)

    def lookups(hi, shape):
        idx = rng.integers(0, hi, n)
        idx[0], idx[-1] = 0, hi - 1
        return torch.tensor(idx.astype(np.int32).reshape(shape), device=device)

    if label == "K12t":
        return table(n, 128), lookups(128, (n, 1))
    if label == "K12r":
        return table(4096, 64), lookups(4096, (n,))
    if label == "K11r":
        flat = lookups(2048 * 128, (n // 128, 128))
        return table(2048, 128), flat // 128, flat % 128
    if label == "K12s":
        return table(2048, 128), lookups(2048, (n // 128, 128))
    idx = lookups(probe_pallas_gather.SCATTER_N, (n // 128, 128))
    if weights == "integer":
        val = rng.integers(-3, 4, idx.shape).astype(np.float32)
    else:
        val = rng.uniform(0.0, 1.0, idx.shape).astype(np.float32)
    return idx, torch.tensor(val, device=device)


def probe_library(label: str, args: tuple):
    """The one PyTorch call of a probe kernel's function, with its int64
    index copies made here, outside the timed window."""
    if label == "K12t":
        blk, idx = args
        idx64 = idx.long()
        return lambda: torch.take_along_dim(blk, idx64, 1)
    if label == "K12r":
        tab, idx = args
        return lambda: tab[idx]
    if label == "K11r":
        tab, hi, lo = args
        return lambda: tab[hi, lo]
    if label == "K12s":
        tab, idx = args
        idx64 = idx.long()
        return lambda: torch.gather(tab, 0, idx64)
    idx, val = args
    idx64, flat_val = idx.reshape(-1).long(), val.reshape(-1)
    return lambda: torch.zeros(probe_pallas_gather.SCATTER_N, device=val.device).index_put_(
        (idx64,), flat_val, accumulate=True)


def probe_bytes(label: str, args: tuple) -> int:
    """The bytes a probe kernel must move on ``args`` (see :func:`roofline`)."""
    if label == "K12t":
        blk, idx = args
        rows = torch.arange(idx.shape[0], device=idx.device)
        return 4 * idx.numel() * 2 + sector_bytes(rows * blk.shape[1] + idx[:, 0])
    if label == "K12r":
        tab, idx = args
        width = tab.shape[1]
        offsets = idx[:, None].long() * width + torch.arange(width, device=idx.device)
        return 4 * idx.numel() + 4 * idx.numel() * width + sector_bytes(offsets)
    if label == "K11r":
        tab, hi, lo = args
        return 8 * hi.numel() + 4 * hi.numel() + sector_bytes(hi.long() * tab.shape[1] + lo)
    if label == "K12s":
        tab, idx = args
        lanes = torch.arange(tab.shape[1], device=idx.device)
        return 4 * idx.numel() * 2 + sector_bytes(idx.long() * tab.shape[1] + lanes)
    idx, val = args
    return 4 * idx.numel() + 4 * val.numel() + 4 * probe_pallas_gather.SCATTER_N


def probe_phase(device) -> tuple:
    """Phase 35: the dynamic-indexing probes (``probe_pallas_gather.main()``)
    on the card at the tool's sizes, their launch counts of K12t, K12r, K11r,
    K12s and K12a; then each kernel against its plain version on the
    probe's inputs, on seeded inputs at the probe's shapes and at 2^20
    lookups (gathers and integer-weight K12a identical, random-weight K12a
    within rel L1 1e-6), and timed at the probe's shapes beside its plain
    version and its one PyTorch call."""
    t_phase = time.perf_counter()
    kernels.LAUNCHES.clear()
    probe_pallas_gather.main(device=device)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in (
        "take_along_lanes", "row_gather", "gather2d", "sublane_gather", "scatter_add")}
    log(f"probe_pallas_gather: launches {launches}")
    check(all(n > 0 for n in launches.values()),
          f"K12t, K12r, K11r, K12s and K12a launched by the probes: {launches}")
    keys = probe_pallas_gather.sort_keys(probe_pallas_gather.P, device)
    check(torch.equal(keys.cpu(), probe_pallas_gather.sort_keys(probe_pallas_gather.P, "cpu")),
          "the sort keys wrap in int32 on the card as on the host")

    rng = np.random.default_rng(PARITY_SEED)
    records = {}
    for label, name, make, _ in PROBE_KERNELS:
        fn, args = make(device)
        plain = probe_plain(label)
        n_probe = args[-1].numel() if label != "K12a" else args[0].numel()
        cases = {"the probe's": args,
                 f"seeded, {n_probe} lookups": probe_inputs(label, rng, n_probe, device),
                 f"seeded, {PROBE_LOOKUPS} lookups": probe_inputs(
                     label, rng, PROBE_LOOKUPS, device)}
        if label == "K12r":  # its scalar path: width 63, a table 4 bytes past alignment
            tab, idx = cases[f"seeded, {n_probe} lookups"]
            flat = torch.empty(tab.numel() + 1, device=device)
            flat[1:] = tab.reshape(-1)
            cases["seeded, width 63 (scalar path)"] = (tab[:, :63].contiguous(), idx)
            cases["seeded, unaligned table (scalar path)"] = (flat[1:].view(tab.shape), idx)
        if label == "K11r":  # a last block part full, 3D blocks, views off 16-byte alignment
            tab, hi, lo = cases[f"seeded, {PROBE_LOOKUPS} lookups"]
            n_tail = PROBE_LOOKUPS - 3
            cases[f"seeded, {n_tail} lookups"] = (
                tab, hi.reshape(-1)[:n_tail], lo.reshape(-1)[:n_tail])
            tab, hi, lo = cases[f"seeded, {n_probe} lookups"]
            cases["seeded, 3D blocks"] = (tab, hi.reshape(4, -1, 128), lo.reshape(4, -1, 128))
            cases["seeded, unaligned rows and lanes"] = (
                tab, unaligned_copy(hi), unaligned_copy(lo))
            cases["seeded, unaligned table"] = (unaligned_copy(tab), hi, lo)
        for case, case_args in cases.items():
            out, ref = fn(*case_args), plain(*case_args)
            torch.cuda.synchronize()
            check(torch.equal(out, ref), f"{label} differs from its plain version ({case} inputs)")
        summary = f"identical on the probe's and seeded inputs at {n_probe} and {PROBE_LOOKUPS}"
        if label == "K12r":
            summary += " and on the scalar path; " + launch_path_parity(
                name, fn, cases[f"seeded, {n_probe} lookups"],
                lambda: [a.copy_(b) for a, b in zip(cases[f"seeded, {n_probe} lookups"],
                                                    probe_inputs(label, rng, n_probe, device))],
                lambda out, a: torch.equal(out, a[0][a[1].long()]))
        if label == "K11r":
            summary += (f", {n_tail} lookups, 3D blocks and unaligned views; " + launch_path_parity(
                "gather2d", fn, cases[f"seeded, {n_probe} lookups"],
                lambda: [a.copy_(b) for a, b in zip(cases[f"seeded, {n_probe} lookups"],
                                                    probe_inputs(label, rng, n_probe, device))],
                lambda out, a: torch.equal(out, a[0][a[1].long(), a[2].long()])))
        if label == "K12a":
            for n in (n_probe, PROBE_LOOKUPS):
                case_args = probe_inputs(label, rng, n, device, weights="random")
                out, ref = fn(*case_args), plain(*case_args)
                rel_l1 = float((out - ref).abs().sum() / ref.abs().sum())
                check(rel_l1 <= MAX_SCATTER_ADD_REL_L1,
                      f"K12a rel L1 {rel_l1} with random weights at {n} lookups")
                summary += f"; random weights at {n}: rel L1 {rel_l1:.3e}"
        ms = time_cuda(lambda: fn(*args), 50)
        plain_ms = time_cuda(lambda: plain(*args), 50)
        library_ms = time_cuda(probe_library(label, args), 50)
        log(f"{label} ({name}) parity: {summary}; timing {label} {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, the one PyTorch call {library_ms:.4f} ms (CUDA events)")
        if label in launch_cost.KERNELS:  # where a call's time goes, old path and new
            launch_cost.measure(label, "the probe's", args)
            if label != "K11r":  # K11r's 2^20 lookups: tools/launch_cost.py alone
                launch_cost.measure(label, f"{PROBE_LOOKUPS}",
                                    cases[f"seeded, {PROBE_LOOKUPS} lookups"], host_calls=1000)
        bound = roofline(f"{label} at the probe's shapes", probe_bytes(label, args), 0.0,
                         F32_OPS_PER_S)
        records[name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **bound,
                         "library_ms": library_ms}
    log(f"phase 35 took {time.perf_counter() - t_phase:.2f} s")
    return launches, records


# The deposit and DDA-step probes of phase 36 (tools/probe_deposit.py,
# probe_deposit2.py) and the cohort mechanics probes of phase 37
# (tools/probe_cohort_kernel.py): the larger seeded cases, and the operations
# per unit of work, counted from csrc/probe_deposit.cu and probe_cohort.cu
DEPOSIT_PACKETS = 1 << 16  # K13h's larger case, at the tools' 7808 steps
DDA_LANES = 1 << 20  # K13e's and K13w's larger case
GATHER_ROWS = 4096  # K14b's larger case
MAX_HISTOGRAM_REL_ERR = 1e-5  # K13h with random f32 weights, per cell
MAX_STREAM_SUM_REL_ERR = 1e-6  # K14c's scalar, of sum |x y|
OPS_PER_DEPOSIT = 3  # the cell (an addition and a mask) and the f32 addition
# K13e per lane step: 3 x (floor, 2 additions, a division, abs), 2 minima, the
# chi product and max, tau_cell, the test, tau / chi, the select, 3 FMAs (6),
# the tau select and subtraction
OPS_PER_K13E_STEP = 31
# K13w per lane step: 2 minima, the chi product and max, the length and
# tau_cell, the test, 2 equalities and the branch, one addition, the tau
# select and subtraction
OPS_PER_K13W_STEP = 13
OPS_PER_GATHER_STEP = 3  # K14b: the lane (an addition and a mask), the f32 addition
# The dependent chain of one step, in cycles, from the source: ~4 cycles for
# each dependent FP32 instruction, ~30 for an IEEE division (a reciprocal
# estimate and its Newton and correction steps).  K13e: floor, +1, -p, the
# division, 2 minima (abs as operand modifiers), tau_cell, the test, the
# select, the FMA; K13w: 2 minima, the equality, the addition and the
# select of tmx; K14b: the f32 addition (the lane's shared-memory load does
# not wait on the sum)
CHAIN_CYCLES = {"K13e": 8 * 4 + 30, "K13w": 5 * 4, "K14b": 4}


def sm_clock_hz() -> float:
    """The card's maximum SM clock (``nvidia-smi``), in Hz."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def latency_floor(label: str, steps: int, ms: float) -> str:
    """The least time of ``steps`` dependent steps of ``label``'s chain at the
    card's maximum clock, and the cycles per step that ``ms`` implies."""
    clock = sm_clock_hz()
    floor_ms = steps * CHAIN_CYCLES[label] / clock * 1e3
    return (f"latency floor {floor_ms:.6f} ms ({steps} steps x {CHAIN_CYCLES[label]} cycles at "
            f"{clock / 1e6:.0f} MHz); measured {ms * 1e-3 * clock / steps:.1f} cycles per step")


def seeded_lanes(rng, n: int, device):
    """K13e's and K13w's directions: a in [0.05, 0.95], b in [-0.6, 0.6], a
    few b = 0 (K13e's 1e-12 branch), some lanes past the unit circle (its
    dz = 0 branch)."""
    a = rng.uniform(0.05, 0.95, n).astype(np.float32)
    b = rng.uniform(-0.6, 0.6, n).astype(np.float32)
    b[:4] = 0.0
    return torch.tensor(a, device=device), torch.tensor(b, device=device)


def histogram_inputs(rng, n: int, device, weights: str):
    """K13h's packets: random lanes in [0, 127] (both ends among them),
    integer weights in [-3, 3] or uniform [0, 1) ones."""
    lidx = rng.integers(0, 128, n)
    lidx[:2] = (0, 127)
    dep = rng.integers(-3, 4, n) if weights == "integer" else rng.uniform(0.0, 1.0, n)
    return (torch.tensor(dep.astype(np.float32), device=device),
            torch.tensor(lidx.astype(np.int32), device=device))


def deposit_phase(device) -> tuple:
    """Phase 36: ``probe_deposit.main()`` and ``probe_deposit2.main()`` on the
    card at the tools' sizes, their launch counts of K13h, K13e, K13w and
    K13f; then each kernel against its plain version on the tools' inputs,
    seeded ones at the tools' shapes and a larger seeded case (K13h: 2^16
    packets x 7808 steps; K13e, K13w: 2^20 lanes): K13h identical with
    integer weights and within rel 1e-5 per cell with random ones (also at
    300 steps), the others identical; each timed at the tools' shapes beside
    its plain version (K13e and K13w from their parity calls) and, for K13h,
    ``torch.bincount`` on the expanded cells."""
    t_phase = time.perf_counter()
    kernels.LAUNCHES.clear()
    probe_deposit.main(device=device)
    probe_deposit2.main(device=device)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in (
        "shifted_histogram", "dda_math", "dda_incremental", "fill_first")}
    log(f"probe_deposit, probe_deposit2: launches {launches}")
    check(all(n > 0 for n in launches.values()),
          f"K13h, K13e, K13w and K13f launched by the tools: {launches}")
    rng = np.random.default_rng(PARITY_SEED)
    nstep = probe_deposit.NSTEP
    records = {}

    # K13h
    dep, lidx = probe_deposit.sublane_inputs(device)
    dep_m, lidx_m = probe_deposit.march_inputs(device)
    cases = {"the tools' [1024, 1]": (dep, lidx, nstep, "integer"),
             "the tools' [8, 128]": (dep_m, lidx_m, nstep, "integer"),
             "seeded, 1024 packets": (*histogram_inputs(rng, 1024, device, "integer"), nstep,
                                      "integer"),
             "seeded, 1024 packets, 300 steps": (
                 *histogram_inputs(rng, 1024, device, "random"), 300, "random"),
             "seeded, 1024 packets, 300 steps, integer": (
                 *histogram_inputs(rng, 1024, device, "integer"), 300, "integer"),
             f"seeded, {DEPOSIT_PACKETS} packets": (
                 *histogram_inputs(rng, DEPOSIT_PACKETS, device, "random"), nstep, "random")}
    worst = worst_abs = 0.0
    for case, (d, l, steps, weights) in cases.items():
        out = probe_deposit_ops.shifted_histogram(d, l, steps)
        ref = probe_deposit_ops.shifted_histogram_reference(d, l, steps)
        torch.cuda.synchronize()
        worst_abs = max(worst_abs, float((out - ref).abs().max()))
        if weights == "integer":
            check(torch.equal(out, ref), f"K13h differs from its plain version ({case})")
        else:
            err = float(((out.double() - ref.double()).abs() / ref.double().abs()).max())
            check(err <= MAX_HISTOGRAM_REL_ERR, f"K13h rel err {err} ({case})")
            worst = max(worst, err)
            log(f"K13h {case}: per-cell rel err {err:.3e}")
    ms = time_cuda(lambda: probe_deposit_ops.shifted_histogram(dep, lidx, nstep), 50)
    plain_ms = time_cuda(lambda: probe_deposit_ops.shifted_histogram_reference(dep, lidx, nstep),
                         5)
    cells = ((lidx.reshape(1, -1).long() + torch.arange(nstep, device=device)[:, None])
             % 128).reshape(-1)
    weights = dep.reshape(1, -1).expand(nstep, -1).reshape(-1).contiguous()
    library_ms = time_cuda(lambda: torch.bincount(cells, weights, minlength=128), 20)
    del cells, weights
    log(f"K13h (shifted_histogram) parity: identical with integer weights, worst rel err "
        f"{worst:.3e} with random ones; timing K13h {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.bincount on the {nstep * dep.numel()} expanded cells {library_ms:.4f} ms "
        f"(CUDA events, 1024 packets x {nstep} steps)")
    bound = roofline("K13h at the tools' shapes", 8 * dep.numel() + 4 * 128,
                     OPS_PER_DEPOSIT * dep.numel() * nstep, F32_OPS_PER_S)
    records["shifted_histogram"] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
                                    **bound, "library_ms": library_ms}

    # K13e and K13w: one thread per lane, identical
    for label, name, fn, plain, tool_inputs, ops in (
        ("K13e", "dda_math", probe_deposit_ops.dda_math, probe_deposit_ops.dda_math_reference,
         probe_deposit.e_inputs(device), OPS_PER_K13E_STEP),
        ("K13w", "dda_incremental", probe_deposit_ops.dda_incremental,
         probe_deposit_ops.dda_incremental_reference, probe_deposit2.w2_inputs(device),
         OPS_PER_K13W_STEP),
    ):
        a, b = tool_inputs
        ref, plain_ms = timed_call(lambda: plain(a, b, nstep))
        check(torch.equal(fn(a, b, nstep), ref),
              f"{label} differs from its plain version (the tools' inputs)")
        # the seeded lanes at the tools' shape and the larger case: the plain
        # version steps both in one call (lanes do not interact)
        seeded, large = seeded_lanes(rng, 1024, device), seeded_lanes(rng, DDA_LANES, device)
        ref = plain(*(torch.cat(pair) for pair in zip(seeded, large)), nstep)
        out_seeded = fn(*(t.reshape(8, 128) for t in seeded), nstep)
        check(torch.equal(out_seeded.reshape(-1), ref[:1024]),
              f"{label} differs from its plain version (seeded, 1024 lanes)")
        check(torch.equal(fn(*large, nstep), ref[1024:]),
              f"{label} differs from its plain version (seeded, {DDA_LANES} lanes)")
        del ref, seeded, large
        ms = time_cuda(lambda: fn(a, b, nstep), 20)
        log(f"{label} ({name}) parity: identical on the tools', seeded and {DDA_LANES}-lane "
            f"inputs; timing {label} {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, "
            f"1024 lanes x {nstep} steps); {latency_floor(label, nstep, ms)}")
        bound = roofline(f"{label} at the tools' shapes", 12 * a.numel(),
                         ops * a.numel() * nstep, F32_OPS_PER_S)
        records[name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **bound,
                         "library_ms": None}

    # K13f: the first value's bits in every cell
    seeded = torch.tensor(rng.standard_normal((8, 128), dtype=np.float32), device=device)
    negative = seeded.clone()
    negative[0, 0] = -0.0
    for case, d in {"the tools'": dep_m, "seeded": seeded, "seeded, -0.0 first": negative,
                    "seeded, 2^20": torch.tensor(rng.standard_normal(1 << 20, dtype=np.float32),
                                                 device=device)}.items():
        out, ref = probe_deposit_ops.fill_first(d), probe_deposit_ops.fill_first_reference(d)
        torch.cuda.synchronize()
        check(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
              f"K13f differs from its plain version ({case})")
    summary = launch_path_parity(
        "fill_first", probe_deposit_ops.fill_first, (seeded,),
        lambda: seeded.copy_(torch.tensor(rng.standard_normal((8, 128), dtype=np.float32))),
        lambda out, a: torch.equal(out.view(torch.int32), probe_deposit_ops.fill_first_reference(
            a[0]).view(torch.int32)))
    launch_cost.measure("K13f", "the tools' [8, 128]", (dep_m,))
    ms = time_cuda(lambda: probe_deposit_ops.fill_first(dep_m), 50)
    plain_ms = time_cuda(lambda: probe_deposit_ops.fill_first_reference(dep_m), 50)
    # the one PyTorch call of K13f's function, which is also its plain version
    library_ms = time_cuda(lambda: dep_m.reshape(-1)[:1].expand(1, 128).clone(), 50)
    log(f"K13f (fill_first) parity: identical bits (-0.0 included); {summary}; timing K13f "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, the one PyTorch call {library_ms:.4f} ms "
        f"(CUDA events)")
    records["fill_first"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                             **roofline("K13f", 4 + 4 * 128, 0.0, F32_OPS_PER_S),
                             "library_ms": library_ms}
    log(f"phase 36 took {time.perf_counter() - t_phase:.2f} s")
    return launches, records


def cohort_phase(device) -> tuple:
    """Phase 37: ``probe_cohort_kernel.main()`` on the card at the tool's
    sizes, its launch counts of K14a, K14b, K14c and K13h (run_d); then K14a,
    K14b and K14c against their plain versions on the tool's inputs, seeded
    ones at the tool's shapes and a larger seeded case (K14a: 2^20 counts;
    K14b: 4096 rows; K14c: twice the tool's 7808 items, and 1, 2, 3 and 7):
    K14a and K14b identical, K14c's array identical and its scalar within
    1e-6 of Σ|x·y|, and the same bits on a second run; K14c's launch-path
    checks (:func:`launch_path_parity`); each timed beside its plain version
    and, for K14c, ``pk.clone()``, with K14c's (a), (b) and (c) on the tool's
    input."""
    t_phase = time.perf_counter()
    kernels.LAUNCHES.clear()
    probe_cohort_kernel.main(device=device)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in (
        "count_positive", "lane_gather_loop", "stream_rows", "shifted_histogram")}
    log(f"probe_cohort_kernel: launches {launches}")
    check(all(n > 0 for n in launches.values()),
          f"K14a, K14b, K14c and K13h launched by the tool: {launches}")
    rng = np.random.default_rng(PARITY_SEED + 1)
    records = {}

    def counts(n):
        return torch.tensor(rng.integers(-3, 4, n).astype(np.int32), device=device)

    (skip,), (run,) = probe_cohort_kernel.skip_inputs(device), probe_cohort_kernel.run_inputs(
        device)
    for case, cnt in {"all-skip": skip, "all-run": run, "seeded, 2048": counts(2048),
                      "seeded, 2^20": counts(1 << 20)}.items():
        out = probe_cohort_ops.count_positive(cnt)
        ref = probe_cohort_ops.count_positive_reference(cnt)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"K14a differs from its plain version ({case})")
    ms = time_cuda(lambda: probe_cohort_ops.count_positive(run), 50)
    plain_ms = time_cuda(lambda: probe_cohort_ops.count_positive_reference(run), 50)
    log(f"K14a (count_positive) parity: identical; timing K14a {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms (CUDA events, 2048 counts)")
    records["count_positive"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **roofline(
        "K14a", 4 * run.numel() + 4 * 1024, run.numel(), F32_OPS_PER_S)}

    def gather_inputs(rows):
        return (torch.tensor(rng.standard_normal((rows, 128), dtype=np.float32), device=device),
                torch.tensor(rng.integers(-200, 300, (rows, 128)).astype(np.int32),
                             device=device))

    tab, idx = probe_cohort_kernel.b_inputs(device)
    steps = probe_cohort_kernel.GATHER_STEPS
    for case, args in {"the tool's": (tab, idx), "seeded, 8 rows": gather_inputs(8),
                       f"seeded, {GATHER_ROWS} rows": gather_inputs(GATHER_ROWS)}.items():
        out = probe_cohort_ops.lane_gather_loop(*args, steps)
        ref = probe_cohort_ops.lane_gather_loop_reference(*args, steps)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"K14b differs from its plain version ({case})")
    ms = time_cuda(lambda: probe_cohort_ops.lane_gather_loop(tab, idx, steps), 50)
    plain_ms = time_cuda(lambda: probe_cohort_ops.lane_gather_loop_reference(tab, idx, steps), 3)
    log(f"K14b (lane_gather_loop) parity: identical on the tool's and seeded inputs at 8 and "
        f"{GATHER_ROWS} rows; timing K14b {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, "
        f"8 rows x {steps} steps); {latency_floor('K14b', steps, ms)}")
    records["lane_gather_loop"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                   **roofline("K14b at the tool's shapes", 12 * tab.numel(),
                                              OPS_PER_GATHER_STEP * tab.numel() * steps,
                                              F32_OPS_PER_S)}

    (pk,) = probe_cohort_kernel.c_inputs(device)
    items = pk.shape[0]

    def seeded_items(n):
        return torch.tensor(rng.standard_normal((n, 16, 128), np.float32), device=device)

    def stream_rows_agree(result, p) -> tuple:
        """K14c's ``result`` on ``p`` against the plain version: (the array
        identical and the scalar within MAX_STREAM_SUM_REL_ERR of Σ|x·y|, the
        scalar's error, the plain scalar, Σ|x·y|)."""
        out, s = result
        out_r, s_r = probe_cohort_ops.stream_rows_reference(p)
        magnitude = float((p[:, 0].double() * p[:, 1].double()).abs().sum())
        err = abs(float(s) - float(s_r))
        return torch.equal(out, out_r) and err <= MAX_STREAM_SUM_REL_ERR * magnitude, err, \
            float(s_r), magnitude

    worst = 0.0
    for case, p in {"the tool's": pk, "seeded": seeded_items(items),
                    f"seeded, {2 * items} items": seeded_items(2 * items),
                    **{f"seeded, {n} items": seeded_items(n) for n in (1, 2, 3, 7)}}.items():
        out, s = probe_cohort_ops.stream_rows(p)
        out2, s2 = probe_cohort_ops.stream_rows(p)
        torch.cuda.synchronize()
        ok, err, s_r, magnitude = stream_rows_agree((out, s), p)
        check(ok, f"K14c differs from its plain version ({case}): sum {float(s)} against {s_r}")
        check(torch.equal(out2, out) and torch.equal(s2.view(torch.int32), s.view(torch.int32)),
              f"K14c repeats itself bit for bit ({case})")
        worst = max(worst, err)
        log(f"K14c {case}: array identical, sum {float(s)!r} against {s_r!r} "
            f"({err / magnitude:.3e} of sum |x y|), a second run identical")
        del p, out, out2
    seeded = seeded_items(items)

    def stream_rows_graph_agrees(result, args):
        ok = stream_rows_agree(result, args[0])[0]
        _, s_eager = probe_cohort_ops.stream_rows(args[0])
        return ok and torch.equal(result[1].view(torch.int32), s_eager.view(torch.int32))

    log("K14c: " + launch_path_parity("stream_rows", probe_cohort_ops.stream_rows, (seeded,),
                                      lambda: seeded.copy_(seeded_items(items)),
                                      stream_rows_graph_agrees))
    del seeded
    ms = time_cuda(lambda: probe_cohort_ops.stream_rows(pk), 20)
    plain_ms = time_cuda(lambda: probe_cohort_ops.stream_rows_reference(pk), 20)
    library_ms = time_cuda(lambda: pk.clone(), 20)
    log(f"K14c (stream_rows) timing: K14c {ms:.4f} ms, plain {plain_ms:.4f} ms, pk.clone() "
        f"{library_ms:.4f} ms (CUDA events, {pk.numel() * 4} bytes in and out)")
    # (a), (b), (c) beside pk.clone() on the tool's input (2 x 7808 items:
    # tools/launch_cost.py)
    launch_cost.measure("K14c", f"the tool's {items} items", (pk,), host_calls=1000)
    records["stream_rows"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                              **roofline("K14c at the tool's shapes (15 rows in, 16 out)",
                                         launch_cost.STREAM_ROWS_BYTES_PER_ELEMENT * pk.numel(),
                                         3 * items * 128, F32_OPS_PER_S),
                              "library_ms": library_ms}
    log(f"phase 37 took {time.perf_counter() - t_phase:.2f} s")
    return launches, records


@contextlib.contextmanager
def swapped(owner, name: str, replacement):
    original = getattr(owner, name)
    setattr(owner, name, replacement)
    try:
        yield
    finally:
        setattr(owner, name, original)


def main() -> None:
    device = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    log(f"card: {smi.stdout.strip()}")
    log(f"device: {describe(device)}, python {sys.version.split()[0]}")

    # the two Voronoi grids are built on the host in worker processes while
    # the kernels compile and the Cartesian phases run
    grid_pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    try:
        grids = {
            "starbench_voronoi": grid_pool.submit(
                timed_voronoi_grid, SBV_BOX, SBV_GENERATORS, SBV_SEED, SBV_LLOYD),
            "multi-frequency": grid_pool.submit(
                timed_voronoi_grid, MF_BOX, MF_GENERATORS, MF_SEED, MF_LLOYD),
        }
        amr_config, amr_geometry, amr_scheme = stromgren_amr_setup()
        grids["stromgren_amr"] = grid_pool.submit(
            timed_amr_grid, amr_geometry, amr_scheme, amr_config.number_density)
        grids["multi-frequency AMR"] = grid_pool.submit(
            timed_amr_grid, *multifreq_amr_setup(), MF_DENSITY)
        with concurrent.futures.ThreadPoolExecutor(max_workers=len(KERNEL_SOURCES)) as pool:
            builds = {label: pool.submit(timed_build, name)
                      for label, name in KERNEL_SOURCES.items()}
            report_build("K1", builds["K1"])

            config = HOnlyConfig.from_params(ParameterFile(STROMGREN_PARAM))
            shape = config.geometry.shape
            small = k1_parity(*parity_inputs(config, 2**17, device), shape,
                              f"{shape[0]}^3 / {2**17} packets")
            # the shapes the main path gives K1: 64^3 cells, 1e6 packets
            parity = k1_parity(*parity_inputs(config, config.n_photons, device), shape,
                               f"{shape[0]}^3 / {config.n_photons} packets")
            launches, stromgren_volume = main_path(config)

            report_build("K3", builds["K3"])
            star = starbench_simulation(device)
            hydro_record = hydro_parity(
                device, star.geometry, star.config.gamma,
                star.timeline().current_timestep,  # the main path's dt
            )
            del star
            star_launches, star_outputs, star_regime = starbench_main_path(device)

            for label in ("K2", "K4", "K6", "K6s", "K7", "K5", "K5s", "K8", "K8p", "K9",
                          "K10", "K11", "K12", "K13", "K14"):
                report_build(label, builds[label])
        # the AMR grids (~1 GB) are unpickled in this process when they
        # arrive: let them land before the timed phases that follow, which
        # the faster phases 1-8 would otherwise meet
        t_wait = time.perf_counter()
        concurrent.futures.wait([grids["stromgren_amr"], grids["multi-frequency AMR"]])
        log(f"waited {time.perf_counter() - t_wait:.2f} s for the AMR grids before phase 9")
        spectral_record = spectral_parity(device)
        multifreq_launches = [lexington_archived(device)]
        full_launches, solve_inputs, f64_state = lexington_full(device)
        multifreq_launches.append(full_launches)
        temperature_record = temperature_parity(
            solve_inputs, "lexingtonHII20 64^3, the fourth solve")
        del solve_inputs
        f32_launches, f32_inputs, f32_state = lexington_full(device, "f32-device")
        multifreq_launches.append(f32_launches)
        compare_backends(f64_state, f32_state)
        temperature_f32_record = temperature_f32_parity(
            f32_inputs, "lexingtonHII20 64^3 f32-device, the fourth solve")
        del f32_inputs, f64_state, f32_state
        multifreq_launches.append(stromgren_diffuse(device))

        sbv_grid = report_grid("starbench_voronoi (40000 generators, 2 Lloyd iterations)",
                               grids["starbench_voronoi"])
        march_record = voronoi_march_parity(sbv_grid, device)
        honly_launches = voronoi_honly(sbv_grid, device)
        flux_record = voronoi_flux_parity(sbv_grid, device, 0.141 * MYR / SBV_STEPS)
        sbv_launches, final_march_record = starbench_voronoi(sbv_grid, device)
        del sbv_grid
        mf_grid = report_grid("multi-frequency (12000 generators, 1 Lloyd iteration)",
                              grids["multi-frequency"])
        mf_launches, mf_sim, captured, mf_solve_inputs = multifreq_voronoi(mf_grid, device)
        multifreq_launches.append(mf_launches)
        spectral_voronoi_record = voronoi_spectral_parity(mf_sim, captured, device)
        mf_temperature_record = temperature_parity(
            mf_solve_inputs, "multi-frequency Voronoi, the last solve")
        del mf_sim, mf_grid, captured, mf_solve_inputs

        amr_grid = report_amr_grid("stromgren_amr (64^3 coarse, level 3)",
                                   grids["stromgren_amr"], AMR_LEAVES)
        amr_sim, amr_launches = stromgren_amr(amr_grid, device)
        octree_record = octree_parity(amr_sim, device)
        del amr_sim, amr_grid
        mfa_grid = report_amr_grid("multi-frequency AMR (16^3 coarse, level 5)",
                                   grids["multi-frequency AMR"], MFA_LEAVES)
        mfa_launches, mfa_sim, mfa_marches, mfa_sites = multifreq_amr(mfa_grid, device)
        multifreq_launches.append(mfa_launches)
        octree_spectral_record = amr_spectral_parity(mfa_sim, mfa_marches, device)
        leaf_record = leaf_descent_parity(mfa_sim, mfa_sites, device)
        del mfa_sim, mfa_grid, mfa_marches, mfa_sites
    finally:
        grid_pool.shutdown(wait=True, cancel_futures=True)

    dust_reference = load_dust_reference()
    dust_sim, dust_launches, dust_captured = dusty_galaxy(device, dust_reference)
    pol_launches, pol_captured = dusty_galaxy_polarized(dust_sim, dust_reference)
    peel_record = peel_off_parity(dust_sim, dust_captured)
    peel_pol_record = peel_off_polarized_parity(dust_sim, pol_captured)
    del dust_sim, dust_captured, pol_captured

    sharded_launches, stromgren_exchange = sharded_stromgren(config, stromgren_volume)
    sbs_launches, starbench_sends, starbench_compactions, sbs_step = sharded_starbench(
        device, star_outputs)
    compact_record, partition_record = exchange_parity(
        starbench_sends, starbench_compactions, stromgren_exchange, sbs_step)
    del stromgren_exchange, starbench_sends, starbench_compactions

    cone_sim, cone_x, cone_launches = cone_stromgren(config, device, stromgren_volume)
    cone_record = cone_parity(cone_sim, cone_x, device)
    del cone_sim, cone_x
    gather_launches, (gather_record, gather2d_record) = gather_phase(device)
    probe_launches, probe_records = probe_phase(device)
    deposit_launches, deposit_records = deposit_phase(device)
    cohort_launches, cohort_records = cohort_phase(device)

    def kernel(name, source, replaces, n_launches, record):
        return {"name": name, "route": "cuda", "source": f"cmacionize_torch/csrc/{source}",
                "replaces": replaces, "launches": n_launches, **record}

    kernel_records = [
        kernel("trace_packets", "trace_packets.cu", "cmacionize_tpu/ops/traversal.py:115",
               launches + star_launches["trace_packets"] + dust_launches["trace_packets"]
               + pol_launches["trace_packets"] + sharded_launches["trace_packets"]
               + sbs_launches["trace_packets"] + cone_launches["trace_packets"],
               {**parity, "max_abs_err": max(small["max_abs_err"], parity["max_abs_err"],
                                             star_regime["max_abs_err"])}),
        kernel("trace_packets_spectral", "trace_packets_spectral.cu",
               "cmacionize_tpu/ops/traversal.py:503",
               sum(run.get("trace_packets_spectral", 0) for run in multifreq_launches),
               spectral_record),
        kernel("hydro_step", "hydro_step.cu", "cmacionize_tpu/ops/hydro.py:353",
               star_launches["hydro_step"] + sbs_launches["hydro_step"], hydro_record),
        kernel("temperature", "temperature.cu", "cmacionize_tpu/ops/temperature.py:283",
               sum(run["temperature"] for run in multifreq_launches),
               {**temperature_record, "max_abs_err": max(
                   temperature_record["max_abs_err"], mf_temperature_record["max_abs_err"])}),
        kernel("temperature_f32", "temperature.cu", "cmacionize_tpu/ops/temperature.py:338",
               sum(run.get("temperature_f32", 0) for run in multifreq_launches),
               temperature_f32_record),
        kernel("trace_voronoi", "trace_voronoi.cu", "cmacionize_tpu/models/voronoi.py:472",
               honly_launches + sbv_launches["trace_voronoi"],
               {**march_record, "max_abs_err": max(
                   march_record["max_abs_err"], final_march_record["max_abs_err"])}),
        kernel("trace_voronoi_spectral", "trace_voronoi_spectral.cu",
               "cmacionize_tpu/models/voronoi.py:669", mf_launches["trace_voronoi_spectral"],
               spectral_voronoi_record),
        kernel("voronoi_flux", "voronoi_flux.cu", "cmacionize_tpu/models/voronoi_hydro.py:137",
               sbv_launches["voronoi_flux"], flux_record),
        kernel("trace_octree", "trace_octree.cu", "cmacionize_tpu/ops/amr_traversal.py:48",
               amr_launches, octree_record),
        kernel("trace_octree_spectral", "trace_octree_spectral.cu",
               "cmacionize_tpu/ops/amr_traversal.py:231", mfa_launches["trace_octree_spectral"],
               octree_spectral_record),
        kernel("leaf_of_positions", "trace_octree.cu", "cmacionize_tpu/ops/amr_traversal.py:182",
               mfa_launches["leaf_of_positions"], leaf_record),
        kernel("peel_off", "peel_off.cu", "cmacionize_tpu/models/dust_simulation.py:243",
               dust_launches["peel_off"] + pol_launches["peel_off"], peel_record),
        kernel("peel_off_polarized", "peel_off_polarized.cu",
               "cmacionize_tpu/ops/polarization.py:156", pol_launches["peel_off_polarized"],
               peel_pol_record),
        kernel("compact", "compact.cu", "cmacionize_tpu/parallel/domain.py:37",
               sharded_launches["compact"] + sbs_launches["compact"], compact_record),
        kernel("partition", "compact.cu", "cmacionize_tpu/parallel/domain3d.py:62",
               sharded_launches["partition"] + sbs_launches["partition"], partition_record),
        kernel("trace_packets_cone", "trace_packets_cone.cu",
               "tools/experimental_cone_kernel.py:305", cone_launches["trace_packets_cone"],
               cone_record),
        kernel("gather", "gather.cu", "tools/microbench_scatter.py:99",
               gather_launches["gather"], gather_record),
        kernel("gather2d", "gather.cu", "tools/microbench_scatter.py:138",
               gather_launches["gather2d"], gather2d_record),
        *(kernel(name, "gather.cu" if label == "K11r" else "probe_gather.cu",
                 f"tools/probe_pallas_gather.py:{line}",
                 probe_launches["gather2d" if label == "K11r" else name], probe_records[name])
          for label, name, _, line in PROBE_KERNELS),
        kernel("shifted_histogram", "probe_deposit.cu", "tools/probe_deposit.py:34",
               deposit_launches["shifted_histogram"] + cohort_launches["shifted_histogram"],
               deposit_records["shifted_histogram"]),
        kernel("dda_math", "probe_deposit.cu", "tools/probe_deposit.py:173",
               deposit_launches["dda_math"], deposit_records["dda_math"]),
        kernel("dda_incremental", "probe_deposit.cu", "tools/probe_deposit2.py:30",
               deposit_launches["dda_incremental"], deposit_records["dda_incremental"]),
        kernel("fill_first", "probe_deposit.cu", "tools/probe_deposit2.py:30",
               deposit_launches["fill_first"], deposit_records["fill_first"]),
        kernel("count_positive", "probe_cohort.cu", "tools/probe_cohort_kernel.py:50",
               cohort_launches["count_positive"], cohort_records["count_positive"]),
        kernel("lane_gather_loop", "probe_cohort.cu", "tools/probe_cohort_kernel.py:80",
               cohort_launches["lane_gather_loop"], cohort_records["lane_gather_loop"]),
        kernel("stream_rows", "probe_cohort.cu", "tools/probe_cohort_kernel.py:120",
               cohort_launches["stream_rows"], cohort_records["stream_rows"]),
    ]
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
