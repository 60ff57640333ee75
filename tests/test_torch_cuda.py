"""The CUDA kernels (K1-K7, K4f, K5, K5s, K5d, K8, K8p, K9c, K9p, K10, K11,
K11r, K12t, K12r, K12s, K12a, K13h, K13e, K13w, K13f, K14a, K14b, K14c) and
the port's drivers on the card (marked ``cuda``).

The kernels are CUDA C++ with no CPU mode, so these tests skip where CUDA is
missing; the plain versions they compare against are tested against the JAX
package in test_torch_traversal.py, test_torch_hydro.py,
test_torch_spectral.py, test_torch_temperature.py, test_torch_temperature_f32.py,
test_torch_voronoi*.py, test_torch_amr.py, test_torch_dust.py,
test_torch_polarization.py, test_torch_domain.py, test_torch_cone.py,
test_torch_microbench_scatter.py, test_torch_probe_pallas_gather.py,
test_torch_probe_deposit.py and test_torch_probe_cohort_kernel.py (against
the JAX tools).  The file imports
no JAX, so that it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from cmacionize_torch import kernels
from cmacionize_torch.kernels.hydro_step import hydro_step_cuda
from cmacionize_torch.kernels.temperature import (
    solve_temperature_cuda,
    solve_temperature_device_cuda,
)
from cmacionize_torch.kernels.trace_packets import trace_packets_cuda
from cmacionize_torch.kernels.trace_packets_spectral import trace_packets_spectral_cuda
from cmacionize_torch.models.density_functions import density_function_from_params
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.models.ionization_simulation import (
    HOnlyConfig,
    HOnlyIonizationSimulation,
)
from cmacionize_torch.models.ions import ION_NAMES
from cmacionize_torch.models.multifreq_simulation import (
    MultiFreqConfig,
    MultiFreqIonizationSimulation,
)
from cmacionize_torch.models.rhd_simulation import RHDSimulation
from cmacionize_torch.ops import hydro, riemann, temperature, traversal
from cmacionize_torch.utils.params import ParameterFile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _inputs(seed, shape, n, chi_neutral, device):
    """Strömgren-like opacity with an ionized cone and isotropic packets from
    the grid centre, made with numpy."""
    rng = np.random.default_rng(seed)
    centre = np.asarray(shape, np.float64) / 2.0
    offset = np.indices(shape) + 0.5 - centre[:, None, None, None]
    r = np.sqrt((offset**2).sum(0))
    x = np.where(r < 0.7 * centre.min(), rng.uniform(1.5e-3, 4.5e-3, shape), 1.0)
    x = np.where(offset[2] > r * np.cos(np.radians(25.0)), 1e-5, x)
    cos_t = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    sin_t = np.sqrt(1.0 - cos_t**2)
    direction = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], 1)
    position = centre[None, :] + 1e-4 * direction
    tau = -np.log1p(-rng.uniform(0.0, 1.0, n))
    weight = rng.uniform(0.5, 1.5, n)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    chi = t((chi_neutral * x).reshape(-1))
    return chi, traversal.make_packets(t(position), t(direction), t(tau), t(weight), shape)


@pytest.mark.parametrize(
    "shape, periodic, chi_neutral, max_steps",
    [
        ((64, 64, 64), (False, False, False), 300.0, 0),
        ((24, 24, 24), (False, False, False), 30.0, 0),
        ((16, 16, 16), (True, True, True), 0.3, 0),
        ((24, 16, 20), (True, False, True), 0.3, 0),
        ((16, 16, 16), (False, False, False), 0.3, 5),
    ],
)
def test_kernel_matches_plain_version(cuda, shape, periodic, chi_neutral, max_steps):
    chi, packets = _inputs(0, shape, 20_000, chi_neutral, cuda)
    before = kernels.LAUNCHES["trace_packets"]
    tally_k, out_k = traversal.trace_packets(
        chi, packets, torch.zeros_like(chi), shape=shape, periodic=periodic,
        max_steps=max_steps,
    )
    assert kernels.LAUNCHES["trace_packets"] == before + 1
    tally_r, out_r = traversal.trace_packets_reference(
        chi, packets, torch.zeros_like(chi), shape=shape, periodic=periodic,
        max_steps=max_steps,
    )
    torch.cuda.synchronize()
    # same f32 operations per packet: flags, cells and positions match
    for f in ("absorbed", "active", "cx", "cy", "cz"):
        assert torch.equal(getattr(out_k, f), getattr(out_r, f)), f
    for f in ("px", "py", "pz", "tau_left"):
        diff = float((getattr(out_k, f) - getattr(out_r, f)).abs().max())
        assert diff <= 5e-4, (f, diff)
    # atomics add in another order: f32 round-off only
    rel_l1 = float((tally_k - tally_r).abs().sum() / tally_r.abs().sum())
    assert rel_l1 <= 1e-4
    # the input batch is left as it was
    assert bool(packets.active.all()) and not bool(packets.absorbed.any())


def test_inactive_and_outside_packets_are_frozen(cuda):
    shape = (4, 4, 4)
    packets = traversal.make_packets(
        torch.tensor([[1.5, 1.5, 1.5], [2.5, 2.5, 2.5]], device=cuda),
        torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=cuda),
        torch.tensor([0.5, 0.5], device=cuda), torch.ones(2, device=cuda), shape,
    )
    packets = packets._replace(
        active=torch.tensor([False, True], device=cuda),
        cx=torch.tensor([1, 7], dtype=torch.int32, device=cuda),
    )
    tally, out = traversal.trace_packets(
        torch.ones(64, device=cuda), packets, torch.zeros(64, device=cuda), shape=shape
    )
    assert float(tally.sum()) == 0.0
    assert not bool(out.active.any()) and not bool(out.absorbed.any())
    assert torch.equal(out.px, packets.px) and torch.equal(out.cx, packets.cx)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    shape = (8, 8, 8)
    chi, packets = _inputs(1, shape, 64, 1.0, cuda)
    fields = packets._asdict()
    with pytest.raises(ValueError, match="opacity"):
        trace_packets_cuda(
            chi.double(), torch.zeros_like(chi), fields,
            shape=shape, periodic=(False,) * 3, max_steps=96,
        )
    with pytest.raises(ValueError, match="contiguous"):
        bad = dict(fields, px=torch.stack([packets.px, packets.py], 1)[:, 0])
        trace_packets_cuda(
            chi, torch.zeros_like(chi), bad,
            shape=shape, periodic=(False,) * 3, max_steps=96,
        )


def test_mini_stromgren_on_card(cuda):
    pc = 3.086e16
    config = HOnlyConfig(
        geometry=GridGeometry(anchor=(-5 * pc,) * 3, sides=(10 * pc,) * 3, shape=(24, 24, 24)),
        number_density=1e8, temperature=8000.0, source_position=(0.0, 0.0, 0.0),
        luminosity=4.26e49, cross_section=6.3e-22, recombination_rate=4e-19,
        n_photons=20000, n_iterations=8,
    )
    kernels.LAUNCHES.clear()
    sim = HOnlyIonizationSimulation(config, device=cuda, seed=7)
    xH = sim.run().cpu().numpy()
    assert kernels.LAUNCHES["trace_packets"] == 8
    assert sim.n_escaped.device.type == "cuda" and sim.n_escaped.shape == (8,)
    v_ion = (xH < 0.5).sum() * config.geometry.cell_volume
    r = (3 * v_ion / (4 * np.pi)) ** (1 / 3)
    assert r == pytest.approx(sim.stromgren_radius_analytic(), rel=0.1)
    assert xH[12, 12, 12] < 1e-4 and xH[0, 0, 0] > 0.99


# ------------------------------------------------------------- K3 (hydro)


def _hydro_inputs(seed, shape, device, si=False):
    """A starbench-like state made with numpy: a hot bubble with an outward
    shell in cold gas, plus a Sod-like jump along x; in SI units (ρ ~ 5e-18
    kg m^-3) when ``si``, else of order one."""
    rng = np.random.default_rng(seed)
    centre = np.asarray(shape, float) / 2.0
    offset = np.indices(shape) + 0.5 - centre[:, None, None, None]
    r = np.sqrt((offset**2).sum(0)) / shape[0]
    inside, shell = r < 0.25, (r >= 0.25) & (r < 0.35)
    rho = rng.uniform(0.9, 1.1, shape) * np.where(offset[0] < 0, 1.0, 0.3)
    rho = rho * np.where(inside, 0.05, np.where(shell, 3.0, 1.0))
    p = rng.uniform(0.9, 1.1, shape) * np.where(offset[0] < 0, 1.0, 0.2)
    p = p * np.where(inside, 50.0, 1.0)
    radial = offset / np.maximum(np.sqrt((offset**2).sum(0)), 1e-9)
    vel = rng.uniform(-0.05, 0.05, (3,) + shape) + np.where(shell, 0.8, 0.0) * radial
    if si:
        rho, vel, p = rho * 5.2e-18, vel * 1.2e4, p * 4.3e-12
    w = hydro.Primitives(*(
        torch.tensor(np.asarray(a, np.float32), device=device) for a in (rho, *vel, p)
    ))
    return w


BOUNDARIES = {
    "reflective": ((hydro.BC_REFLECTIVE,) * 2,) * 3,
    "periodic": ((hydro.BC_PERIODIC,) * 2,) * 3,
    "outflow_mixed": (
        (hydro.BC_OUTFLOW, hydro.BC_REFLECTIVE),
        (hydro.BC_PERIODIC, hydro.BC_PERIODIC),
        (hydro.BC_REFLECTIVE, hydro.BC_OUTFLOW),
    ),
}


@pytest.mark.parametrize(
    "shape, bc, solver, gamma, si",
    [
        ((16, 16, 16), "reflective", "HLLC", 5.0 / 3.0, False),
        ((32, 32, 32), "reflective", "HLLC", 1.0001, True),
        ((24, 16, 20), "periodic", "HLLC", 5.0 / 3.0, False),
        ((16, 24, 32), "outflow_mixed", "HLLC", 1.4, False),
        ((16, 16, 16), "reflective", "Exact", 5.0 / 3.0, False),
        ((24, 16, 20), "periodic", "Exact", 1.4, False),
        ((16, 24, 32), "outflow_mixed", "Exact", 5.0 / 3.0, False),
    ],
)
def test_hydro_kernel_matches_plain_version(cuda, shape, bc, solver, gamma, si):
    w = _hydro_inputs(3, shape, cuda, si=si)
    u = hydro.conserved_from_primitives(w, gamma)
    wp = hydro.pad_primitives(w, BOUNDARIES[bc])
    cell = (5e15,) * 3 if si else (0.1, 0.1, 0.1)
    dt = 2e10 if si else 2e-3
    kwargs = dict(cell_size=cell, gamma=gamma, riemann_solver=solver)
    before = kernels.LAUNCHES["hydro_step"]
    out_k = hydro.hydro_step_padded(u, wp, dt, **kwargs)
    assert kernels.LAUNCHES["hydro_step"] == before + 1
    out_r = hydro.hydro_step_padded_reference(u, wp, dt, **kwargs)
    torch.cuda.synchronize()
    # the same f32 operations in the same order (--fmad=false): HLLC to
    # round-off, the exact solver up to torch's pow shortcuts
    rel = 1e-6 if solver == "HLLC" else 1e-5
    for name, a, b in zip(out_r._fields, out_r, out_k):
        assert torch.isfinite(b).all(), name
        err = float((a - b).abs().max() / a.abs().max())
        assert err <= rel, (name, err)
    assert float((out_k.energy - u.energy).abs().max()) > 0.0


def test_hydro_step_through_kernel_gravity_kick(cuda):
    shape = (16, 16, 16)
    w = _hydro_inputs(4, shape, cuda)
    u = hydro.conserved_from_primitives(w, 5.0 / 3.0)
    wp = hydro.pad_primitives(w, BOUNDARIES["periodic"])
    gravity = tuple(torch.full(shape, g, device=cuda) for g in (0.3, -0.2, 0.1))
    kwargs = dict(cell_size=(0.1,) * 3, gamma=5.0 / 3.0, gravity=gravity)
    out_k = hydro.hydro_step_padded(u, wp, 1e-3, **kwargs)
    out_r = hydro.hydro_step_padded_reference(u, wp, 1e-3, **kwargs)
    for a, b in zip(out_r, out_k):
        assert float((a - b).abs().max() / a.abs().max()) <= 1e-6


def test_sod_tube_through_kernel(cuda):
    n, gamma, t_end = 128, 5.0 / 3.0, 0.2
    shape = (n, 4, 4)
    dx = 1.0 / n
    x = (np.arange(n) + 0.5) * dx
    rho = np.broadcast_to(np.where(x < 0.5, 1.0, 0.125)[:, None, None], shape)
    p = np.broadcast_to(np.where(x < 0.5, 1.0, 0.1)[:, None, None], shape)
    zeros = torch.zeros(shape, device=cuda)
    w = hydro.Primitives(
        torch.tensor(np.asarray(rho, np.float32), device=cuda), zeros, zeros, zeros,
        torch.tensor(np.asarray(p, np.float32), device=cuda),
    )
    u = hydro.conserved_from_primitives(w, gamma)
    boundaries = (
        (hydro.BC_OUTFLOW, hydro.BC_OUTFLOW),
        (hydro.BC_PERIODIC, hydro.BC_PERIODIC),
        (hydro.BC_PERIODIC, hydro.BC_PERIODIC),
    )
    kernels.LAUNCHES.clear()
    t, steps = 0.0, 0
    while t < t_end:
        dt = min(float(hydro.cfl_timestep(u, (dx,) * 3, cfl=0.4, gamma=gamma)), t_end - t)
        u = hydro.hydro_step(u, dt, boundaries=boundaries, cell_size=(dx,) * 3, gamma=gamma)
        t += dt
        steps += 1
    assert kernels.LAUNCHES["hydro_step"] == steps
    w = hydro.primitives_from_conserved(u, gamma)
    one = [torch.tensor(v) for v in (1.0, 0.0, 1.0, 0.125, 0.0, 0.1)]
    rho_ex = riemann.exact_sample(*one, torch.tensor(np.float32((x - 0.5) / 0.2)), gamma=gamma)[0]
    l1 = float((w.rho[:, 2, 2].cpu() - rho_ex).abs().mean())
    assert l1 < 0.012, l1
    assert float(u.rho.double().sum()) * dx / 16 == pytest.approx((1.0 + 0.125) / 2, rel=1e-4)


def test_hydro_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    shape = (8, 8, 8)
    w = _hydro_inputs(5, shape, cuda)
    u = tuple(hydro.conserved_from_primitives(w, 5.0 / 3.0))
    wp = tuple(hydro.pad_primitives(w, BOUNDARIES["periodic"]))
    kwargs = dict(cell_size=(0.1,) * 3, gamma=5.0 / 3.0)
    with pytest.raises(ValueError, match="float32"):
        hydro_step_cuda((u[0].double(),) + u[1:], wp, 1e-3, **kwargs)
    with pytest.raises(ValueError, match="CUDA"):
        hydro_step_cuda(tuple(f.cpu() for f in u), wp, 1e-3, **kwargs)
    with pytest.raises(ValueError, match="float32"):
        hydro_step_cuda(u, wp[:4] + (wp[4].cpu(),), 1e-3, **kwargs)
    with pytest.raises(ValueError, match="shape"):
        hydro_step_cuda(u, tuple(f[1:-1, 1:-1, 1:-1] for f in wp), 1e-3, **kwargs)
    with pytest.raises(ValueError, match="contiguous"):
        bad = torch.empty(8, 8, 16, device=cuda)[:, :, ::2]
        hydro_step_cuda((bad,) + u[1:], wp, 1e-3, **kwargs)
    with pytest.raises(ValueError, match="Riemann"):
        hydro_step_cuda(u, wp, 1e-3, riemann_solver="HLL", **kwargs)


def test_short_starbench_on_card(cuda):
    params = ParameterFile(os.path.join(ROOT, "benchmarks", "starbench.param"))
    params._tree["DensityGrid"]["number of cells"] = [32, 32, 32]
    params._tree["RadiationHydrodynamicsSimulation"]["number of photons"] = 100000
    prev = os.getcwd()
    os.chdir(os.path.join(ROOT, "benchmarks"))
    try:
        sim = RHDSimulation.from_params(params, device=cuda, seed=42)
    finally:
        os.chdir(prev)
    kernels.LAUNCHES.clear()
    state, xH = sim.advance(12)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["trace_packets"] == 12 * sim.config.nloop
    assert kernels.LAUNCHES["hydro_step"] == 12
    for f in state:
        assert f.device.type == "cuda" and torch.isfinite(f).all()
    w = hydro.primitives_from_conserved(state, sim.config.gamma)
    assert float(w.p.min()) > 0.0
    xH = xH.cpu().numpy()
    assert xH[16, 16, 16] < 1e-3 and xH[0, 0, 0] > 0.99
    mass = float(state.rho.double().sum())
    expected = 3113e6 * 1.672621898e-27 * 32**3
    assert abs(mass / expected - 1.0) < 1e-4


# K3 in one launch: (U) forms the primitives and the ghosts from the conserved
# state and the walls' ghost maps, (P) reads padded primitives; the two give
# the same bits, on shapes that fill whole bricks of 4 x 8 x 8 cells and on
# shapes that do not.
K3_SHAPES = [(64, 64, 64), (5, 7, 9), (33, 64, 17)]


@pytest.mark.parametrize("shape", K3_SHAPES)
@pytest.mark.parametrize("solver", ["HLLC", "Exact"])
@pytest.mark.parametrize("bc", ["reflective", "outflow_mixed"])
def test_hydro_conserved_path_is_the_padded_path_bit_for_bit(cuda, shape, solver, bc):
    gamma = 5.0 / 3.0
    u = hydro.conserved_from_primitives(_hydro_inputs(11, shape, cuda), gamma)
    kwargs = dict(cell_size=(0.1, 0.12, 0.09), gamma=gamma, riemann_solver=solver)
    before = kernels.LAUNCHES["hydro_step"]
    out_u = hydro.hydro_step(u, 2e-3, boundaries=BOUNDARIES[bc], **kwargs)
    assert kernels.LAUNCHES["hydro_step"] == before + 1
    wp = hydro.pad_primitives(hydro.primitives_from_conserved(u, gamma), BOUNDARIES[bc])
    out_p = hydro.hydro_step_padded(u, wp, 2e-3, **kwargs)
    torch.cuda.synchronize()
    for name, a, b in zip(out_u._fields, out_u, out_p):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    assert float((out_u.energy - u.energy).abs().max()) > 0.0


@pytest.mark.parametrize("shape", K3_SHAPES[1:])
@pytest.mark.parametrize("solver", ["HLLC", "Exact"])
def test_hydro_kernel_matches_plain_version_on_ragged_bricks(cuda, shape, solver):
    gamma = 1.4
    w = _hydro_inputs(12, shape, cuda)
    u = hydro.conserved_from_primitives(w, gamma)
    wp = hydro.pad_primitives(w, BOUNDARIES["periodic"])
    kwargs = dict(cell_size=(0.1,) * 3, gamma=gamma, riemann_solver=solver)
    out_k = hydro.hydro_step_padded(u, wp, 2e-3, **kwargs)
    out_r = hydro.hydro_step_padded_reference(u, wp, 2e-3, **kwargs)
    torch.cuda.synchronize()
    rel = 1e-6 if solver == "HLLC" else 1e-5
    for name, a, b in zip(out_r._fields, out_r, out_k):
        assert torch.isfinite(b).all(), name
        assert float((a - b).abs().max() / a.abs().max()) <= rel, name


def test_hydro_step_with_inflow_ghosts_takes_the_padded_path(cuda):
    shape, gamma = (12, 8, 8), 5.0 / 3.0
    u = hydro.conserved_from_primitives(_hydro_inputs(13, shape, cuda), gamma)
    boundaries = ((hydro.BC_INFLOW, hydro.BC_OUTFLOW), (hydro.BC_PERIODIC,) * 2,
                  (hydro.BC_REFLECTIVE,) * 2)
    inflow = {(0, "lo"): (2.0, 0.5, 0.0, 0.0, 3.0)}
    kwargs = dict(cell_size=(0.1,) * 3, gamma=gamma)
    before = kernels.LAUNCHES["hydro_step"]
    out = hydro.hydro_step(u, 1e-3, boundaries=boundaries, inflow_states=inflow, **kwargs)
    assert kernels.LAUNCHES["hydro_step"] == before + 1
    wp = hydro.pad_primitives(hydro.primitives_from_conserved(u, gamma), boundaries,
                              inflow_states=inflow)
    ref = hydro.hydro_step_padded_reference(u, wp, 1e-3, **kwargs)
    for a, b in zip(ref, out):
        assert float((a - b).abs().max() / a.abs().max()) <= 1e-6


def test_hydro_kernel_occupancy(cuda):
    from cmacionize_torch.kernels import hydro_step as hydro_step_ops

    for form, lanes in hydro_step_ops.occupancy(cuda).items():
        assert 0 < lanes["registers"] <= 255 and lanes["blocks_per_sm"] >= 1, (form, lanes)


# ------------------------------------------------- K2 (spectral march)


def _spectral_inputs(seed, shape, n, n_bins, device):
    """A lexington-like state made with numpy: gas with a central cavity,
    ionized H inside 0.4 of the box and He inside 0.25, neutral beyond;
    packets from the centre in random bins with random cross sections."""
    rng = np.random.default_rng(seed)
    centre = np.asarray(shape, np.float64) / 2.0
    offset = np.indices(shape) + 0.5 - centre[:, None, None, None]
    r = np.sqrt((offset**2).sum(0)).reshape(-1) / min(shape)
    nd_dx = np.where(r < 0.1, 0.0, 3e23)
    xH = np.where(r < 0.4, rng.uniform(1e-4, 1e-3, r.shape), 1.0)
    xHe = np.where(r < 0.25, rng.uniform(1e-3, 1e-2, r.shape), 1.0)
    cos_t = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    sin_t = np.sqrt(1.0 - cos_t**2)
    direction = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], 1)
    position = centre[None, :] + 1e-4 * direction

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    packets = traversal.make_spectral_packets(
        t(position), t(direction), t(-np.log1p(-rng.uniform(0.0, 1.0, n))),
        t(rng.uniform(0.5, 1.5, n)), t(rng.uniform(0.5e-22, 6.3e-22, n)),
        t(rng.uniform(0.0, 7e-22, n)),
        torch.tensor(rng.integers(0, n_bins, n), dtype=torch.int32, device=device), shape,
    )
    return t(nd_dx * xH), t(0.1 * nd_dx * xHe), packets


@pytest.mark.parametrize(
    "shape, periodic, max_steps",
    [
        ((32, 32, 32), (False, False, False), 0),
        ((32, 32, 32), (True, True, True), 0),
        ((24, 16, 20), (True, False, True), 0),
        ((32, 32, 32), (False, False, False), 7),
    ],
)
def test_spectral_kernel_matches_plain_version(cuda, shape, periodic, max_steps):
    n_bins = 16
    chi_h, chi_he, packets = _spectral_inputs(0, shape, 50_000, n_bins, cuda)
    ncell = chi_h.numel()
    # re-emission hands the whole batch with a mask: a fifth is inactive
    packets = packets._replace(active=torch.arange(packets.size, device=cuda) % 5 != 0)
    kwargs = dict(shape=shape, n_bins=n_bins, periodic=periodic, max_steps=max_steps)
    before = kernels.LAUNCHES["trace_packets_spectral"]
    tally_k, out_k = traversal.trace_packets_spectral(
        chi_h, chi_he, packets, torch.zeros(n_bins * ncell, device=cuda), **kwargs)
    assert kernels.LAUNCHES["trace_packets_spectral"] == before + 1
    tally_r, out_r = traversal.trace_packets_spectral_reference(
        chi_h, chi_he, packets, torch.zeros(n_bins * ncell, device=cuda), **kwargs)
    torch.cuda.synchronize()
    for f in ("absorbed", "active", "cx", "cy", "cz"):
        assert torch.equal(getattr(out_k, f), getattr(out_r, f)), f
    for f in ("px", "py", "pz", "tau_left"):
        diff = float((getattr(out_k, f) - getattr(out_r, f)).abs().max())
        assert diff <= 5e-4, (f, diff)
    assert 0 < int(out_k.absorbed.sum()) < packets.size
    rel_l1 = float((tally_k - tally_r).abs().sum() / tally_r.abs().sum())
    assert rel_l1 <= 1e-4
    frozen = ~packets.active
    assert torch.equal(out_k.px[frozen], packets.px[frozen])
    assert not bool(out_k.absorbed[frozen].any())


def test_spectral_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    shape = (8, 8, 8)
    chi_h, chi_he, packets = _spectral_inputs(1, shape, 64, 4, cuda)
    fields = packets._asdict()
    kwargs = dict(shape=shape, n_bins=4, periodic=(False,) * 3, max_steps=96)
    with pytest.raises(ValueError, match="tally"):
        trace_packets_spectral_cuda(chi_h, chi_he, torch.zeros(512, device=cuda), fields, **kwargs)
    with pytest.raises(ValueError, match="fbin"):
        bad = dict(fields, fbin=fields["fbin"].long())
        trace_packets_spectral_cuda(chi_h, chi_he, torch.zeros(2048, device=cuda), bad, **kwargs)
    with pytest.raises(ValueError, match="CUDA"):
        trace_packets_spectral_cuda(chi_h.cpu(), chi_he, torch.zeros(2048), fields, **kwargs)


@pytest.mark.parametrize("active_share", [1.0, 0.3])
def test_spectral_kernel_state_bit_for_bit(cuda, active_share):
    """K2's flags, cells, positions and tau_left equal the plain version's bit
    for bit, on a source batch and on a re-emission generation's mask, in a
    gas thin enough that some packets escape; the tally within the plain
    version's round-off."""
    shape, n_bins = (32, 32, 32), 16
    chi_h, chi_he, packets = _spectral_inputs(4, shape, 100_000, n_bins, cuda)
    chi_h, chi_he = 1e-2 * chi_h, 1e-2 * chi_he
    ncell = chi_h.numel()
    rng = np.random.default_rng(5)
    mask = torch.tensor(rng.uniform(size=packets.size) < active_share, device=cuda)
    packets = packets._replace(active=mask)
    kwargs = dict(shape=shape, n_bins=n_bins, periodic=(False,) * 3)
    tally_k, out_k = traversal.trace_packets_spectral(
        chi_h, chi_he, packets, torch.zeros(n_bins * ncell, device=cuda), **kwargs)
    tally_r, out_r = traversal.trace_packets_spectral_reference(
        chi_h, chi_he, packets, torch.zeros(n_bins * ncell, device=cuda), **kwargs)
    torch.cuda.synchronize()
    for f in out_k._fields:
        a, b = getattr(out_k, f), getattr(out_r, f)
        same = torch.equal(a.view(torch.int32), b.view(torch.int32)) if a.is_floating_point() \
            else torch.equal(a, b)
        assert same, f
    assert 0 < int(out_k.absorbed.sum()) < int(mask.sum())
    rel_l1 = float((tally_k - tally_r).abs().sum() / tally_r.abs().sum())
    assert rel_l1 <= 1e-4, rel_l1


@pytest.mark.parametrize("n_active", [0, 1, 33])
def test_spectral_kernel_on_few_active_packets(cuda, n_active):
    shape, n_bins = (16, 16, 16), 8
    chi_h, chi_he, packets = _spectral_inputs(6, shape, 4096, n_bins, cuda)
    mask = torch.zeros(packets.size, dtype=torch.bool, device=cuda)
    mask[torch.randperm(packets.size, generator=torch.Generator().manual_seed(n_active))
         [:n_active].to(cuda)] = True
    packets = packets._replace(active=mask)
    kwargs = dict(shape=shape, n_bins=n_bins, periodic=(False,) * 3)
    tally_k, out_k = traversal.trace_packets_spectral(
        chi_h, chi_he, packets, torch.zeros(n_bins * chi_h.numel(), device=cuda), **kwargs)
    tally_r, out_r = traversal.trace_packets_spectral_reference(
        chi_h, chi_he, packets, torch.zeros(n_bins * chi_h.numel(), device=cuda), **kwargs)
    torch.cuda.synchronize()
    for f in out_k._fields:
        assert torch.equal(getattr(out_k, f), getattr(out_r, f)), f
    assert float((tally_k - tally_r).abs().max()) <= 1e-5 * max(float(tally_r.abs().max()), 1e-30)
    if n_active == 0:
        assert float(tally_k.abs().max()) == 0.0


def test_spectral_kernel_occupancy(cuda):
    from cmacionize_torch.kernels import trace_packets_spectral as k2_ops

    lanes = k2_ops.occupancy(cuda)
    assert 0 < lanes["registers"] <= 255 and lanes["blocks_per_sm"] >= 1, lanes


# ------------------------------------------ K4 (temperature balance)

ABUND = {"He": 0.1, "C": 2.2e-4, "N": 4.0e-5, "O": 3.3e-4, "Ne": 5.0e-5, "S": 9.0e-6}


def _thermal_cells(seed, n, device):
    """Lexington-like random cells (the recipe of test_temperature.py), the
    first 64 without gas."""
    rng = np.random.default_rng(seed)
    jH = 10.0 ** rng.uniform(-14, -6, n)
    scale = {"H_n": 1.0, "He_n": 0.7}
    j = {name: jH * scale.get(name, 10.0 ** rng.uniform(-3, 0)) for name in ION_NAMES}
    hH = jH * 10.0 ** rng.uniform(-19.0, -18.0, n)
    nd = 10.0 ** rng.uniform(6, 10, n)
    nd[:64] = 0.0
    T = 10.0 ** rng.uniform(2.0, 4.3, n)

    def t(a):
        return torch.tensor(np.asarray(a, np.float64), device=device)

    return t(T), {k: t(v) for k, v in j.items()}, (t(hH), t(0.5 * hH)), t(nd)


@pytest.mark.parametrize("pahfac, crfac", [(1.0, 0.0), (0.0, 0.5)])
def test_temperature_kernel_matches_plain_version(cuda, pahfac, crfac):
    T, j, h, nd = _thermal_cells(11, 4096, cuda)
    before = kernels.LAUNCHES["temperature"]
    got = temperature.solve_temperature(T, j, h, nd, ABUND, pahfac=pahfac, crfac=crfac)
    assert kernels.LAUNCHES["temperature"] == before + 1
    ref = temperature.solve_temperature_reference(T, j, h, nd, ABUND, pahfac=pahfac, crfac=crfac)
    both_nan = torch.isnan(got.T) & torch.isnan(ref.T)
    rel = torch.where(both_nan, 0.0, (got.T - ref.T).abs() / ref.T.abs())
    rel = torch.nan_to_num(rel, nan=float("inf"))
    assert float((rel <= 1e-9).double().mean()) >= 0.99
    assert float(rel.max()) <= 5e-3
    assert bool(torch.isfinite(got.T).all())
    assert bool((got.sweeps[:64] == 100).all())
    assert float((got.sweeps == ref.sweeps).double().mean()) >= 0.99
    for name in ("h0", "he0"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name), rtol=1e-5,
                                   atol=1e-9, equal_nan=True)
    for name, value in ref.metals.items():
        torch.testing.assert_close(got.metals[name], value, rtol=1e-5, atol=1e-9,
                                   equal_nan=True)


def test_temperature_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    T, j, h, nd = _thermal_cells(2, 128, cuda)
    kwargs = dict(pahfac=0.0, crfac=0.0, epsilon=1e-3, max_iterations=100,
                  minimum_ionized_temperature=4000.0)
    with pytest.raises(ValueError, match="float64"):
        solve_temperature_cuda(T.float(), j, h, nd, ABUND, **kwargs)
    with pytest.raises(ValueError, match="j\\[O_n\\]"):
        solve_temperature_cuda(T, dict(j, O_n=j["O_n"][:64]), h, nd, ABUND, **kwargs)
    with pytest.raises(ValueError, match="CUDA"):
        solve_temperature_cuda(T.cpu(), j, h, nd, ABUND, **kwargs)


# --------------------------------- K4f (the f32 temperature balance)


def _compare_f32(got, ref):
    """K4f against its plain version, per cell: >= 99% of cells within 1e-4
    relative in T and all within 5e-3 (chip_smoke.py's bounds), >= 99% with
    the same sweep count, the state within 1e-3."""
    both_nan = torch.isnan(got.T) & torch.isnan(ref.T)
    rel = torch.where(both_nan, 0.0, (got.T - ref.T).abs() / ref.T.abs())
    rel = torch.nan_to_num(rel, nan=float("inf"))
    assert got.T.dtype == torch.float32
    assert float((rel <= 1e-4).double().mean()) >= 0.99
    assert float(rel.max()) <= 5e-3
    assert float((got.sweeps == ref.sweeps).double().mean()) >= 0.99
    for name in ("h0", "he0"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name), rtol=1e-3,
                                   atol=1e-4, equal_nan=True)
    for name, value in ref.metals.items():
        torch.testing.assert_close(got.metals[name], value, rtol=1e-3, atol=1e-4,
                                   equal_nan=True)


@pytest.mark.parametrize("pahfac, crfac", [(1.0, 0.0), (0.0, 0.5)])
def test_temperature_f32_kernel_matches_plain_version(cuda, pahfac, crfac):
    """Random Lexington states (64 without gas), through
    solve_temperature_device, which launches K4f on CUDA tensors."""
    T, j, h, nd = _thermal_cells(11, 4096, cuda)
    before = kernels.LAUNCHES["temperature_f32"]
    got = temperature.solve_temperature_device(T, j, h, nd, ABUND, pahfac=pahfac, crfac=crfac)
    assert kernels.LAUNCHES["temperature_f32"] == before + 1
    ref = temperature.solve_temperature_device_reference(
        T, j, h, nd, ABUND, pahfac=pahfac, crfac=crfac)
    _compare_f32(got, ref)
    assert bool(torch.isfinite(got.T).all())
    assert bool((got.sweeps[:64] == 100).all())


def test_temperature_f32_kernel_on_empty_and_cavity_cells(cuda):
    """Cells without gas (nd = 0), without radiation (j = 0, h = 0), and
    both, beside ordinary ones: the kernel follows the plain version's
    arithmetic, NaN included, and never traps."""
    T, j, h, nd = _thermal_cells(5, 1024, cuda)
    no_light = slice(100, 300)
    cavity = slice(200, 400)
    for value in j.values():
        value[no_light] = 0.0
    h[0][no_light] = 0.0
    h[1][no_light] = 0.0
    nd[cavity] = 0.0
    got = temperature.solve_temperature_device(T, j, h, nd, ABUND, pahfac=1.0)
    ref = temperature.solve_temperature_device_reference(T, j, h, nd, ABUND, pahfac=1.0)
    torch.cuda.synchronize()
    _compare_f32(got, ref)
    assert bool((got.h0[100:200] == 1.0).all()) and bool((got.he0[100:200] == 1.0).all())
    assert bool((got.metals["O_n"][100:200] == 0.0).all())


def test_temperature_f32_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    T, j, h, nd = _thermal_cells(2, 128, cuda)
    kwargs = dict(pahfac=0.0, crfac=0.0, epsilon=1e-3, max_iterations=100,
                  minimum_ionized_temperature=4000.0)
    f32 = {k: v.float() for k, v in j.items()}
    h32 = (h[0].float(), h[1].float())
    with pytest.raises(ValueError, match="float32"):
        solve_temperature_device_cuda(T, f32, h32, nd.float(), ABUND, **kwargs)
    with pytest.raises(ValueError, match="CUDA"):
        solve_temperature_device_cuda(T.float().cpu(), f32, h32, nd.float(), ABUND, **kwargs)


def test_f32_backend_driver_on_card(cuda):
    """The 16³ lexington-mini of tests/test_torch_multifreq_f32.py with the
    f32 backend on the card: every solve launches K4f (and no K4), and the
    run tracks the f64 backend's from the same seed within that test's
    bands."""
    geometry = GridGeometry((-5 * PC,) * 3, (10 * PC,) * 3, (16, 16, 16))
    common = dict(
        geometry=geometry, number_density=1e8, initial_temperature=8000.0,
        source_position=(0.0, 0.0, 0.0), luminosity=4.26e49, spectrum_type="planck",
        spectrum_temperature=40000.0, spectrum_frequency=3.3e15, n_photons=30000,
        n_iterations=6, abundances=dict(ABUND), do_temperature=True, diffuse_field=False,
        n_bins=32,
    )
    runs = {}
    for backend in ("f64-host", "f32-device"):
        sim = MultiFreqIonizationSimulation(
            MultiFreqConfig(**common, temperature_backend=backend), device=cuda, seed=21)
        kernels.LAUNCHES.clear()
        xion, T = sim.run()
        runs[backend] = ({k: v.cpu().numpy() for k, v in xion.items()}, T.cpu().numpy(),
                         dict(kernels.LAUNCHES))
    (xh, Th, lh), (xd, Td, ld) = runs["f64-host"], runs["f32-device"]
    assert lh["temperature"] == 3 and lh.get("temperature_f32", 0) == 0
    assert ld["temperature_f32"] == 3 and ld.get("temperature", 0) == 0
    ion = xh["H_n"].ravel() < 0.5
    rel = np.abs(Td.ravel()[ion] - Th.ravel()[ion]) / Th.ravel()[ion]
    assert np.median(rel) < 5e-3 and np.quantile(rel, 0.95) < 3e-2
    assert abs((xd["H_n"] < 0.5).sum() - ion.sum()) <= max(0.02 * ion.sum(), 5)



# ------------------- K4 and K4f: the persistent grid, lanes refilled from a counter

SOLVERS = {
    "f64": (temperature.solve_temperature, temperature.solve_temperature_reference),
    "f32": (temperature.solve_temperature_device,
            temperature.solve_temperature_device_reference),
}


def _compare_to_plain(precision, got, ref):
    """K4 (f64) or K4f (f32) against its plain version with the tolerances
    of chip_smoke.py: >= 99% of cells within 1e-9 (f64) or 1e-4 (f32)
    relative in T, all within 5e-3, >= 99% with the same sweep count; NaN
    where the plain version has NaN."""
    if precision == "f32":
        _compare_f32(got, ref)
        return
    both_nan = torch.isnan(got.T) & torch.isnan(ref.T)
    rel = torch.where(both_nan, 0.0, (got.T - ref.T).abs() / ref.T.abs())
    rel = torch.nan_to_num(rel, nan=float("inf"))
    assert float((rel <= 1e-9).double().mean()) >= 0.99
    assert float(rel.max()) <= 5e-3
    assert float((got.sweeps == ref.sweeps).double().mean()) >= 0.99
    for name in ("h0", "he0"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name), rtol=1e-5,
                                   atol=1e-9, equal_nan=True)
    for name, value in ref.metals.items():
        torch.testing.assert_close(got.metals[name], value, rtol=1e-5, atol=1e-9,
                                   equal_nan=True)


def _fields(solution):
    """(name, tensor) of every output of a solve, metals included."""
    return [("T", solution.T), ("h0", solution.h0), ("he0", solution.he0),
            ("sweeps", solution.sweeps)] + sorted(solution.metals.items())


def _assert_same_bits(a, b):
    """Every output of two solves equal bit for bit, NaN where NaN."""
    for (name, x), (_, y) in zip(_fields(a), _fields(b)):
        if x.is_floating_point():
            bits = torch.int64 if x.dtype == torch.float64 else torch.int32
            same = (x.view(bits) == y.view(bits)) | (x.isnan() & y.isnan())
            assert bool(same.all()), name
        else:
            assert torch.equal(x, y), name


def _take(cells, index):
    T, j, h, nd = cells
    return (T[index], {k: v[index] for k, v in j.items()}, (h[0][index], h[1][index]),
            nd[index])


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_temperature_kernels_give_permuted_outputs_for_permuted_cells(cuda, precision):
    """No cell's result depends on the lane that ran it or on the cells
    beside it: the cells permuted give the outputs permuted, bit for bit."""
    solve, plain = SOLVERS[precision]
    cells = _thermal_cells(7, 6000, cuda)
    got = solve(*cells, ABUND, pahfac=1.0)
    order = torch.from_numpy(np.random.default_rng(3).permutation(6000)).to(cuda)
    permuted = solve(*_take(cells, order), ABUND, pahfac=1.0)
    _assert_same_bits(permuted, type(got)(*(
        value[order] if not isinstance(value, dict) else {k: v[order] for k, v in value.items()}
        for value in got)))
    _compare_to_plain(precision, got, plain(*cells, ABUND, pahfac=1.0))


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_temperature_kernels_repeat_bit_for_bit(cuda, precision):
    """Launches back to back, and one on a side stream, give the same bits:
    the work counter is zeroed before every launch (a stale one would skip
    cells and leave their outputs unwritten)."""
    solve, plain = SOLVERS[precision]
    cells = _thermal_cells(8, 5000, cuda)
    first = solve(*cells, ABUND, crfac=0.5)
    second = solve(*cells, ABUND, crfac=0.5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        third = solve(*cells, ABUND, crfac=0.5)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    _assert_same_bits(first, second)
    _assert_same_bits(first, third)
    _compare_to_plain(precision, first, plain(*cells, ABUND, crfac=0.5))


@pytest.mark.parametrize("precision, n", [
    ("f64", 0), ("f64", 1), ("f64", 31), ("f64", 33), ("f64", 12000), ("f64", 2**18 + 5),
    ("f32", 0), ("f32", 1), ("f32", 33), ("f32", 12000),
])
def test_temperature_kernels_on_few_and_many_cells(cuda, precision, n):
    """From no cell (no launch) through fewer cells than the card's
    resident lanes (12000) to more than 2^18, against the plain version, and
    each cell bit for bit as in a launch over more cells."""
    solve, plain = SOLVERS[precision]
    name = "temperature" if precision == "f64" else "temperature_f32"
    cells = _thermal_cells(9, max(n, 64), cuda)
    few = _take(cells, slice(0, n))
    before = kernels.LAUNCHES[name]
    got = solve(*few, ABUND, pahfac=1.0)
    assert kernels.LAUNCHES[name] == before + (n > 0)
    assert got.T.shape == (n,) and got.sweeps.dtype == torch.int32
    if n == 0:
        return
    _compare_to_plain(precision, got, plain(*few, ABUND, pahfac=1.0))
    if n < 64:
        whole = solve(*cells, ABUND, pahfac=1.0)
        _assert_same_bits(got, type(whole)(*(
            value[:n] if not isinstance(value, dict) else {k: v[:n] for k, v in value.items()}
            for value in whole)))


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_temperature_kernels_mix_capped_and_one_sweep_cells_in_a_warp(cuda, precision):
    """Every other cell without gas (all max_iterations sweeps) beside cells
    that start at their equilibrium (one sweep): each lane's cells keep
    their own sweep counts and results."""
    solve, plain = SOLVERS[precision]
    T, j, h, nd = _thermal_cells(12, 4096, cuda)
    nd[:64] = 1e8
    settled = plain(T, j, h, nd, ABUND, pahfac=1.0).T.to(T.dtype)
    T0 = torch.where(torch.isfinite(settled), settled, T)
    nd[1::2] = 0.0
    cells = (T0, j, h, nd)
    got = solve(*cells, ABUND, pahfac=1.0)
    ref = plain(*cells, ABUND, pahfac=1.0)
    assert bool((got.sweeps[1::2] == 100).all())
    assert float((got.sweeps[0::2] == 1).double().mean()) > 0.5
    _compare_to_plain(precision, got, ref)


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("max_iterations", [0, 1])
def test_temperature_kernels_at_zero_and_one_sweep(cuda, precision, max_iterations):
    """max_iterations 0 (the start state and the fix-ups, no sweep) and 1."""
    solve, plain = SOLVERS[precision]
    cells = _thermal_cells(13, 3000, cuda)
    got = solve(*cells, ABUND, max_iterations=max_iterations)
    ref = plain(*cells, ABUND, max_iterations=max_iterations)
    assert bool((got.sweeps == max_iterations).all())
    _compare_to_plain(precision, got, ref)


def test_temperature_kernel_on_empty_and_cavity_cells(cuda):
    """K4 on cells without gas (nd = 0), without radiation (j = 0, h = 0)
    and both, beside ordinary ones, as K4f's test above."""
    T, j, h, nd = _thermal_cells(5, 1024, cuda)
    no_light = slice(100, 300)
    for value in j.values():
        value[no_light] = 0.0
    h[0][no_light] = 0.0
    h[1][no_light] = 0.0
    nd[200:400] = 0.0
    got = temperature.solve_temperature(T, j, h, nd, ABUND, pahfac=1.0)
    ref = temperature.solve_temperature_reference(T, j, h, nd, ABUND, pahfac=1.0)
    _compare_to_plain("f64", got, ref)
    assert bool((got.h0[100:200] == 1.0).all()) and bool((got.he0[100:200] == 1.0).all())
    assert bool((got.metals["O_n"][100:200] == 0.0).all())
    assert bool((got.sweeps[200:400] == 100).all())


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_temperature_kernels_on_pivot_ties_and_nan(cuda, precision):
    """Cells whose 5x5 level systems hold tied pivot candidates (no gas:
    the collisional terms vanish, so columns hold equal zeros) and NaN
    (infinite density or temperature, or NaN rates: the pivot search takes
    a NaN as the largest value, as torch.argmax does), beside ordinary
    cells: the kernel gives the plain version's values, NaN where it has
    NaN, and never traps."""
    solve, plain = SOLVERS[precision]
    T, j, h, nd = _thermal_cells(14, 2048, cuda)
    nd[64:128] = float("inf")
    T[128:192] = float("inf")
    T[192:256] = float("nan")
    for value in j.values():
        value[256:320] = float("nan")
    got = solve(T, j, h, nd, ABUND, pahfac=1.0)
    ref = plain(T, j, h, nd, ABUND, pahfac=1.0)
    torch.cuda.synchronize()
    _compare_to_plain(precision, got, ref)
    assert torch.equal(got.T.isnan(), ref.T.isnan())


def test_temperature_grid_and_tables_are_kept_per_device(cuda):
    """The persistent grid is the card's resident blocks (from the occupancy
    query, whose registers are the build report's); the packed tables are
    copied once per configuration and dtype."""
    from cmacionize_torch.kernels import temperature as k4

    T, j, h, nd = _thermal_cells(2, 128, cuda)
    temperature.solve_temperature(T, j, h, nd, ABUND)
    report = k4.ptxas_report()
    for dtype, label in ((torch.float64, "K4"), (torch.float32, "K4f")):
        for lanes, name in ((1, label), (3, f"{label} (3 lanes)")):
            found = k4.occupancy(cuda, dtype, lanes)
            assert found["blocks_per_sm"] >= 1 and found["sms"] >= 1
            assert k4.grid_blocks(cuda, dtype, lanes) == found["blocks_per_sm"] * found["sms"]
            assert report[name]["registers"] == found["registers"]
        resident = k4.grid_blocks(cuda, dtype, 1) * k4.THREADS
        assert k4.lanes_per_cell(resident, cuda, dtype) == 3
        assert k4.lanes_per_cell(resident + 1, cuda, dtype) == 1
    kwargs = dict(pahfac=0.0, crfac=0.0, epsilon=1e-3, minimum_ionized_temperature=4000.0,
                  scale=1.0)
    a = k4.device_tables(torch.float64, T.device, ABUND, **kwargs)
    assert k4.device_tables(torch.float64, T.device, dict(ABUND), **kwargs) is a
    assert k4.device_tables(torch.float64, T.device, ABUND, **dict(kwargs, crfac=0.5)) is not a
    assert k4.device_omega_table(T.device) is k4.device_omega_table(T.device)


# --------------------------------------------- the multi-frequency driver


def test_mini_lexington_on_card(cuda):
    """tests/test_lexington.py's run (16³, 5e4 packets, 8 iterations, 64
    bins, 4 generations) on the card, within the same bands."""
    prev = os.getcwd()
    os.chdir(os.path.join(ROOT, "benchmarks"))
    try:
        params = ParameterFile("lexingtonHII20.param")
        config = MultiFreqConfig.from_params(params)
        config = dataclasses.replace(
            config, geometry=dataclasses.replace(config.geometry, shape=(16, 16, 16)),
            n_photons=50000, n_iterations=8, n_bins=64, n_reemission_rounds=4)
        df = density_function_from_params(params, config.geometry)
    finally:
        os.chdir(prev)
    sim = MultiFreqIonizationSimulation(
        config, density=df.number_density, initial_temperature=df.temperature,
        seed=11, device=cuda)
    kernels.LAUNCHES.clear()
    xion, T = sim.run()
    assert kernels.LAUNCHES["trace_packets_spectral"] == 8 * 5
    assert kernels.LAUNCHES["temperature"] == 8 - config.minimum_iteration_number
    assert T.device.type == "cuda" and T.dtype == torch.float64
    r = np.sqrt((config.geometry.cell_centers() ** 2).sum(-1))
    nd = df.number_density
    T = T.cpu().numpy()
    x = {name: value.cpu().numpy() for name, value in xion.items()}

    def shell(lo, hi):
        return (r > lo * 3.086e16) & (r < hi * 3.086e16) & (nd > 0)

    assert 6000.0 < float(T[shell(1.0, 2.0)].mean()) < 8300.0
    assert float(np.median(x["H_n"][shell(1.0, 2.5)])) < 3e-3
    assert (x["He_n"] < 0.5).sum() <= 1.05 * (x["H_n"] < 0.5).sum()
    assert float(np.median(x["O_n"][shell(1.0, 2.0)])) > 0.9
    assert float(np.median(x["O_p1"][shell(1.0, 2.0)])) < 0.1
    assert (T[nd == 0] == 500.0).all()


# ------------------------------------------- K6, K6s and K7 (Voronoi)

PC = 3.086e16


def _voronoi_grid(seed, n, periodic=(False, False, False), si=True):
    from cmacionize_torch.models import voronoi

    rng = np.random.default_rng(seed)
    geometry = (GridGeometry((-1.256 * PC,) * 3, (2.512 * PC,) * 3, (8, 8, 8), periodic)
                if si else GridGeometry((0.0,) * 3, (1.0,) * 3, (8, 8, 8), periodic))
    return voronoi.build_voronoi_grid(geometry, rng.random((n, 3)), num_lloyd=1)


def _voronoi_packets(grid, seed, n, device, spectral=False, n_bins=8):
    """Isotropic packets near the box centre, an ionized sphere in neutral
    gas with a fully ionized cone along +z (χ per meter), made with numpy."""
    from cmacionize_torch.models import voronoi

    rng = np.random.default_rng(seed)
    rel = grid.generators - 0.5
    r = np.sqrt((rel**2).sum(1))
    x = np.where(r < 0.3, rng.uniform(1e-7, 1e-5, r.shape), 1.0)
    x = np.where(rel[:, 2] > r * np.cos(np.radians(25.0)), 1e-9, x)
    chi = 3.113e9 * 6.3e-22 * x
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = 0.5 + rng.uniform(-0.05, 0.05, (n, 3))
    pk = voronoi.make_voronoi_packets(
        grid, pos, d, -np.log1p(-rng.random(n)), rng.uniform(0.5, 1.5, n), device=device)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    if not spectral:
        return t(chi), pk
    fbin = torch.tensor(rng.integers(0, n_bins, n), dtype=torch.int32, device=device)
    spk = voronoi.SpectralVoronoiPacketBatch(
        *pk[:5], t(rng.uniform(0.5e-22, 6.3e-22, n)), t(rng.uniform(0.0, 7e-22, n)), fbin,
        torch.arange(n, device=device) % 5 != 0, pk.absorbed)
    return t(3.113e9 * x), t(0.1 * 3.113e9 * x), spk


def _compare_marches(out_k, out_r, tally_k, tally_r, n):
    flags = int(((out_k.absorbed != out_r.absorbed) | (out_k.active != out_r.active)).sum())
    assert flags <= 1e-5 * n + 1, flags
    same = (out_k.absorbed == out_r.absorbed) & (out_k.active == out_r.active)
    assert float((out_k.pos - out_r.pos)[same].abs().max()) <= 1e-5
    rel_l1 = float((tally_k - tally_r).abs().sum() / tally_r.abs().sum())
    assert rel_l1 <= 1e-4, rel_l1


@pytest.mark.parametrize("periodic, max_steps", [
    ((False, False, False), 0), ((True, True, True), 0), ((True, False, True), 0),
    ((False, False, False), 6),
])
def test_voronoi_march_kernel_matches_plain_version(cuda, periodic, max_steps):
    from cmacionize_torch.models import voronoi

    grid = _voronoi_grid(0, 3000, periodic)
    chi, pk = _voronoi_packets(grid, 1, 50_000, cuda)
    tables = voronoi.voronoi_tables(grid, cuda)
    C = grid.n_cells
    march = dict(eps=voronoi.march_eps(C), max_steps=voronoi.default_max_steps(C, max_steps))
    before = kernels.LAUNCHES["trace_voronoi"]
    tally_k, out_k = voronoi.trace_packets_voronoi(grid, chi, pk, max_steps=max_steps,
                                                   tables=tables)
    assert kernels.LAUNCHES["trace_voronoi"] == before + 1
    tally_r, out_r = voronoi.trace_packets_voronoi_reference(
        tables, chi * grid.scale, pk, torch.zeros(C, device=cuda), **march)
    torch.cuda.synchronize()
    n_absorbed = int(out_r.absorbed.sum())
    assert 0 < n_absorbed and (n_absorbed < pk.size or any(periodic))
    _compare_marches(out_k, out_r, tally_k, tally_r * grid.scale, pk.size)
    assert bool(pk.active.all())  # the input batch is left as it was


@pytest.mark.parametrize("periodic", [(False, False, False), (True, True, True)])
def test_voronoi_spectral_kernel_matches_plain_version(cuda, periodic):
    from cmacionize_torch.models import voronoi

    grid = _voronoi_grid(2, 3000, periodic)
    n_bins = 8
    chi_h, chi_he, pk = _voronoi_packets(grid, 3, 50_000, cuda, spectral=True, n_bins=n_bins)
    tables = voronoi.voronoi_tables(grid, cuda)
    C = grid.n_cells
    march = dict(eps=voronoi.march_eps(C), max_steps=voronoi.default_max_steps(C))
    before = kernels.LAUNCHES["trace_voronoi_spectral"]
    tally_k, out_k = voronoi.trace_packets_voronoi_spectral(
        grid, chi_h, chi_he, pk, n_bins=n_bins, tables=tables)
    assert kernels.LAUNCHES["trace_voronoi_spectral"] == before + 1
    tally_r, out_r = voronoi.trace_packets_voronoi_spectral_reference(
        tables, chi_h * grid.scale, chi_he * grid.scale, pk,
        torch.zeros(n_bins * C, device=cuda), **march)
    torch.cuda.synchronize()
    _compare_marches(out_k, out_r, tally_k.reshape(-1), tally_r * grid.scale, pk.size)
    frozen = ~pk.active
    assert torch.equal(out_k.pos[frozen], pk.pos[frozen])
    assert not bool(out_k.absorbed[frozen].any())


@pytest.mark.parametrize("active_share", [1.0, 0.3])
@pytest.mark.parametrize("periodic", [(False, False, False), (True, True, True)])
def test_voronoi_spectral_kernel_state_bit_for_bit(cuda, active_share, periodic):
    """K6s on the packed face rows with warp deposits: flags, cells,
    positions and tau_left bit for bit the plain version's, on a source batch
    and on a re-emission generation's mask; the tally within the plain
    version's round-off."""
    from cmacionize_torch.models import voronoi

    grid = _voronoi_grid(2, 3000, periodic)
    n_bins = 8
    chi_h, chi_he, pk = _voronoi_packets(grid, 7, 50_000, cuda, spectral=True, n_bins=n_bins)
    rng = np.random.default_rng(8)
    pk = pk._replace(active=torch.tensor(rng.uniform(size=pk.size) < active_share, device=cuda))
    tables = voronoi.voronoi_tables(grid, cuda)
    C = grid.n_cells
    march = dict(eps=voronoi.march_eps(C), max_steps=voronoi.default_max_steps(C))
    tally_k, out_k = voronoi.trace_packets_voronoi_spectral(
        grid, chi_h, chi_he, pk, n_bins=n_bins, tables=tables)
    tally_r, out_r = voronoi.trace_packets_voronoi_spectral_reference(
        tables, chi_h * grid.scale, chi_he * grid.scale, pk,
        torch.zeros(n_bins * C, device=cuda), **march)
    torch.cuda.synchronize()
    assert torch.equal(out_k.cell, out_r.cell)
    for f in ("pos", "tau_left"):
        assert torch.equal(getattr(out_k, f).view(torch.int32), getattr(out_r, f).view(torch.int32)), f
    for f in ("active", "absorbed"):
        assert torch.equal(getattr(out_k, f), getattr(out_r, f)), f
    assert 0 < int(out_k.absorbed.sum())
    tally_r = tally_r * grid.scale
    rel_l1 = float((tally_k.reshape(-1) - tally_r).abs().sum() / tally_r.abs().sum())
    assert rel_l1 <= 1e-4, rel_l1


def test_voronoi_spectral_kernel_occupancy(cuda):
    from cmacionize_torch.kernels import trace_voronoi_spectral as k6s_ops

    lanes = k6s_ops.occupancy(cuda)
    assert 0 < lanes["registers"] <= 255 and lanes["blocks_per_sm"] >= 1, lanes


def _voronoi_hydro_inputs(grid, seed, si, device):
    from cmacionize_torch.models import voronoi_hydro

    rng = np.random.default_rng(seed)
    r = np.sqrt(((grid.generators - 0.5) ** 2).sum(1))
    nd = np.where(r < 0.15, 0.02, np.where(r < 0.25, 3.0, 1.0)) * rng.uniform(0.98, 1.02, r.shape)
    T = np.where(r < 0.15, 1e4, 100.0)
    v = rng.normal(size=(len(r), 3)) * (1e4 if si else 0.1)
    if si:
        rho, p = nd * 3.113e9 * 1.672621898e-27, nd * 3.113e9 * 1.380649e-23 * T
    else:
        rho, p = nd, nd * T / 100.0
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    gamma = 1.0001 if si else 5.0 / 3.0
    state = voronoi_hydro.conserved_from_primitives(
        t(rho), t(v[:, 0]), t(v[:, 1]), t(v[:, 2]), t(p), None, gamma)
    gen_vel = t(rng.normal(size=(len(r), 3)) * (3e3 if si else 0.03))
    return state, gen_vel, gamma


@pytest.mark.parametrize("si, periodic, second_order, dt", [
    (True, (False, False, False), True, 1.6e11),
    (True, (False, False, False), False, 2e10),
    (False, (True, True, True), True, 2e-3),
    (True, (True, False, True), True, 2e10),
])
def test_voronoi_flux_kernel_matches_plain_version(cuda, si, periodic, second_order, dt):
    from cmacionize_torch.models import voronoi_hydro

    grid = _voronoi_grid(4, 2000, periodic, si=si)
    state, gen_vel, gamma = _voronoi_hydro_inputs(grid, 5, si, cuda)
    tables = voronoi_hydro.hydro_tables(grid, cuda)
    stats_k, stats_r = {}, {}
    before = kernels.LAUNCHES["voronoi_flux"]
    out_k = voronoi_hydro.voronoi_flux_update(
        *tables, state, gen_vel, dt, gamma, second_order, stats=stats_k)
    assert kernels.LAUNCHES["voronoi_flux"] == before + 1
    out_r = voronoi_hydro.voronoi_flux_update_reference(
        *tables, state, gen_vel, dt, gamma, second_order, stats=stats_r)
    torch.cuda.synchronize()
    if second_order:
        assert torch.equal(stats_k["flag"], stats_r["flag"])
    for name, a, b in zip(out_r._fields, out_r, out_k):
        assert bool(torch.isfinite(b).all()), name
        err = float((a - b).abs().max() / a.abs().max())
        assert err <= 1e-5, (name, err)
    assert float((out_k.energy - state.energy).abs().max()) > 0.0


def test_voronoi_flux_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from cmacionize_torch.kernels.voronoi_flux import voronoi_flux_update_cuda
    from cmacionize_torch.models import voronoi_hydro

    grid = _voronoi_grid(6, 300)
    state, gen_vel, gamma = _voronoi_hydro_inputs(grid, 7, True, cuda)
    tables = voronoi_hydro.hydro_tables(grid, cuda)
    with pytest.raises(ValueError, match="neighbors"):
        voronoi_flux_update_cuda(tables.neighbors.long(), *tables[1:], state, gen_vel, 1e10,
                                 gamma=gamma)
    with pytest.raises(ValueError, match="gen_vel"):
        voronoi_flux_update_cuda(*tables, state, gen_vel[:, :2].contiguous(), 1e10, gamma=gamma)
    with pytest.raises(ValueError, match="CUDA"):
        voronoi_flux_update_cuda(*(t.cpu() for t in tables), state, gen_vel, 1e10, gamma=gamma)


def test_voronoi_drivers_on_card(cuda):
    """H-only Strömgren volume and a short starbench_voronoi run on the card
    through K6 and K7."""
    from cmacionize_torch.models import voronoi, voronoi_hydro

    rng = np.random.default_rng(8)
    nH, L, alpha = 1.0e8, 1.0e48, 2.7e-19
    r_s = (3.0 * L / (4.0 * np.pi * alpha * nH * nH)) ** (1.0 / 3.0)
    box = 6.0 * r_s
    grid = voronoi.build_voronoi_grid(
        GridGeometry((0.0,) * 3, (box,) * 3, (8, 8, 8)), rng.random((3000, 3)), num_lloyd=1)
    kernels.LAUNCHES.clear()
    sim = voronoi.HOnlyVoronoiSimulation(
        grid, lambda p: np.full(len(p), nH), device=cuda,
        source_position=(box / 2,) * 3, luminosity=L, cross_section=6.3e-22,
        recombination_rate=alpha, n_photons=1 << 16, seed=9)
    sim.run(12)
    assert kernels.LAUNCHES["trace_voronoi"] == 12
    v_exact = 4.0 / 3.0 * np.pi * r_s**3
    assert abs(sim.ionized_volume() - v_exact) / v_exact < 0.3

    grid = _voronoi_grid(9, 3000)
    kernels.LAUNCHES.clear()
    rhd = voronoi_hydro.VoronoiRHDSimulation(
        grid, device=cuda, gamma=1.0001, timestep=0.141 * 3.15576e13 / 48, luminosity=1e49,
        source_position=(0.0, 0.0, 0.0), cross_section=6.3e-22, recombination_rate=2.7e-19,
        n_photons=20000, nloop=4, number_density=3.113e9, temperature=100.0, seed=31)
    m0 = voronoi_hydro.total_mass(rhd.state, grid.volumes)
    rhd.run(8)
    assert kernels.LAUNCHES["trace_voronoi"] == 32 and kernels.LAUNCHES["voronoi_flux"] == 8
    for f in rhd.state:
        assert bool(torch.isfinite(f).all())
    assert voronoi_hydro.total_mass(rhd.state, grid.volumes) == pytest.approx(m0, rel=1e-5)


# ---------------------------------------------- K5, K5s and K5d (AMR octree)


def _octree_grid(n=16, max_level=5, zone=1.0 / 16):
    """A deep grid: the coarse cells of the corner zone refined to
    ``max_level`` (16³ at level 5: a 512³ finest lattice, no owner map)."""
    from cmacionize_torch.models import amr

    scheme = amr.SpatialRefinement((0.0,) * 3, (zone,) * 3, max_level)
    return amr.build_amr_grid(GridGeometry((0.0,) * 3, (1.0,) * 3, (n, n, n)), scheme,
                              lambda p: np.ones(len(p)), max_level=max_level)


def _octree_inputs(grid, seed, n, device, spectral=False, n_bins=8):
    """χ per coarse unit per leaf (an ionized core around the refined corner
    in neutral gas) and packets from near the corner, a quarter on walls of
    the finest lattice, made with numpy; positions in coarse units."""
    rng = np.random.default_rng(seed)
    nx = grid.geometry.shape[0]
    r = np.sqrt(((grid.centers - 0.05) ** 2).sum(1)) * nx
    x = np.where(r < 4.0, rng.uniform(1e-4, 1e-3, r.shape), 1.0)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = rng.uniform(0.3, 1.2, (n, 3))
    pos[: n // 4] = np.round(pos[: n // 4] * 32) / 32
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    root, children = (torch.tensor(a, device=device) for a in grid.octree())
    pk = traversal.make_packets(t(pos), t(d), t(-np.log1p(-rng.random(n))),
                                t(rng.uniform(0.5, 1.5, n)), grid.geometry.shape)
    march = dict(coarse_shape=grid.geometry.shape, max_level=grid.max_level)
    if not spectral:
        return root, children, t(30.0 * x), pk, march
    fbin = torch.tensor(rng.integers(0, n_bins, n), dtype=torch.int32, device=device)
    spk = traversal.SpectralPacketBatch(
        *pk[:11], t(rng.uniform(0.5, 6.3, n)), t(rng.uniform(0.0, 7.0, n)), fbin,
        torch.arange(n, device=device) % 5 != 0, pk.absorbed)
    return root, children, t(3.0 * x), t(0.3 * x), spk, march


def _compare_octree_marches(out_k, out_r, tally_k, tally_r, n):
    flags = int(((out_k.absorbed != out_r.absorbed) | (out_k.active != out_r.active)).sum())
    assert flags <= 1e-5 * n + 1, flags
    same = (out_k.absorbed == out_r.absorbed) & (out_k.active == out_r.active)
    for f in ("px", "py", "pz"):
        assert float((getattr(out_k, f) - getattr(out_r, f))[same].abs().max()) <= 1e-5, f
    rel_l1 = float((tally_k - tally_r).abs().sum() / tally_r.abs().sum())
    assert rel_l1 <= 1e-4, rel_l1


@pytest.mark.parametrize("max_level, max_steps", [(5, 0), (3, 0), (5, 7)])
def test_octree_kernel_matches_plain_version(cuda, max_level, max_steps):
    from cmacionize_torch.ops import amr_traversal

    grid = _octree_grid(max_level=max_level, zone=1.0 / 16 if max_level == 5 else 0.25)
    root, children, chi, pk, march = _octree_inputs(grid, 1, 50_000, cuda)
    C = grid.n_cells
    before = kernels.LAUNCHES["trace_octree"]
    tally_k, out_k = amr_traversal.trace_packets_octree(
        root, children, chi, pk, torch.zeros(C, device=cuda), max_steps=max_steps, **march)
    assert kernels.LAUNCHES["trace_octree"] == before + 1
    tally_r, out_r = amr_traversal.trace_packets_octree_reference(
        root, children, chi, pk, torch.zeros(C, device=cuda), max_steps=max_steps, **march)
    torch.cuda.synchronize()
    n_absorbed = int(out_r.absorbed.sum())
    assert 0 < n_absorbed < pk.size
    _compare_octree_marches(out_k, out_r, tally_k, tally_r, pk.size)
    assert bool(pk.active.all())  # the input batch is left as it was


def test_octree_spectral_kernel_matches_plain_version(cuda):
    from cmacionize_torch.ops import amr_traversal

    grid = _octree_grid()
    n_bins = 8
    root, children, chi_h, chi_he, pk, march = _octree_inputs(
        grid, 3, 50_000, cuda, spectral=True, n_bins=n_bins)
    C = grid.n_cells
    before = kernels.LAUNCHES["trace_octree_spectral"]
    tally_k, out_k = amr_traversal.trace_packets_octree_spectral(
        root, children, chi_h, chi_he, pk, torch.zeros(n_bins * C, device=cuda),
        n_bins=n_bins, **march)
    assert kernels.LAUNCHES["trace_octree_spectral"] == before + 1
    tally_r, out_r = amr_traversal.trace_packets_octree_spectral_reference(
        root, children, chi_h, chi_he, pk, torch.zeros(n_bins * C, device=cuda),
        n_bins=n_bins, **march)
    torch.cuda.synchronize()
    assert int(out_r.absorbed.sum()) > 0
    _compare_octree_marches(out_k, out_r, tally_k, tally_r, pk.size)
    frozen = ~pk.active
    assert torch.equal(out_k.px[frozen], pk.px[frozen])
    assert not bool(out_k.absorbed[frozen].any())


def test_leaf_descent_kernel_matches_plain_version(cuda):
    from cmacionize_torch.ops import amr_traversal

    grid = _octree_grid()
    root, children = (torch.tensor(a, device=cuda) for a in grid.octree())
    rng = np.random.default_rng(5)
    q = rng.uniform(-0.2, 16.2, (200_000, 3)).astype(np.float32)
    q[:50_000] = rng.uniform(0.0, 1.0, (50_000, 3)).astype(np.float32)  # the deep corner
    q[:20_000] = np.round(q[:20_000] * 32) / 32  # on walls of the finest lattice
    pts = [torch.tensor(q[:, i], device=cuda) for i in range(3)]
    march = dict(coarse_shape=grid.geometry.shape, max_level=grid.max_level)
    before = kernels.LAUNCHES["leaf_of_positions"]
    leaf_k = amr_traversal.leaf_of_positions(root, children, *pts, **march)
    assert kernels.LAUNCHES["leaf_of_positions"] == before + 1
    leaf_r = amr_traversal.leaf_of_positions_reference(root, children, *pts, **march)
    assert leaf_k.dtype == torch.int32 and torch.equal(leaf_k, leaf_r)
    assert int(leaf_k.max()) < grid.n_cells and int(leaf_k.min()) >= 0


def test_octree_level10_chain_terminates_on_card(cuda):
    """tests/test_amr.py's far-corner chain through K5: every packet
    terminates well inside the step cap."""
    from cmacionize_torch.models import amr
    from cmacionize_torch.ops import amr_traversal

    class FarCornerChain:
        def refine(self, level, centers, volume, nd, fractions):
            if level >= 10:
                return np.zeros(len(centers), bool)
            return np.all(centers > 1.0 - 1.0 / 16 / (2**level), axis=1)

    g = amr.build_amr_grid(GridGeometry((0.0,) * 3, (1.0,) * 3, (16, 16, 16)), FarCornerChain(),
                           lambda p: np.ones(len(p)), max_level=10)
    root, children = (torch.tensor(a, device=cuda) for a in g.octree())
    rng = np.random.default_rng(1)
    n = 2048
    d = rng.normal(size=(n, 3))
    d = torch.tensor((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32),
                     device=cuda)
    tau = torch.tensor((-np.log1p(-rng.random(n))).astype(np.float32), device=cuda)
    pk = traversal.make_packets(torch.full((n, 3), 15.95, device=cuda) + 1e-4 * d, d, tau,
                                torch.ones(n, device=cuda), (16, 16, 16))
    _, out = amr_traversal.trace_packets_octree(
        root, children, torch.full((g.n_cells,), 0.05, device=cuda),
        pk, torch.zeros(g.n_cells, device=cuda), coarse_shape=(16, 16, 16), max_level=10,
        max_steps=4000)
    assert int(out.active.sum()) == 0 and 0 < int(out.absorbed.sum()) < n


def test_octree_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from cmacionize_torch.kernels.leaf_of_positions import leaf_of_positions_cuda
    from cmacionize_torch.kernels.trace_octree import trace_octree_cuda
    from cmacionize_torch.kernels.trace_octree_spectral import trace_octree_spectral_cuda

    grid = _octree_grid(max_level=3, zone=0.25)
    root, children, chi, pk, march = _octree_inputs(grid, 4, 100, cuda)
    C = grid.n_cells
    fields = pk._asdict()
    kw = dict(eps=1e-4, max_steps=10, **march)
    with pytest.raises(ValueError, match="children"):
        trace_octree_cuda(root, children.long(), chi, torch.zeros(C, device=cuda), fields, **kw)
    with pytest.raises(ValueError, match="tally"):
        trace_octree_cuda(root, children, chi, torch.zeros(C + 1, device=cuda), fields, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        trace_octree_cuda(root.cpu(), children.cpu(), chi.cpu(), torch.zeros(C), fields, **kw)
    with pytest.raises(ValueError, match="int32"):
        trace_octree_spectral_cuda(root, children, chi, chi, torch.zeros(1, device=cuda),
                                   fields, n_bins=2**31 // C + 1, **kw)
    leaf = torch.empty(pk.size, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="leaf"):
        leaf_of_positions_cuda(root, children, pk.px, pk.py, pk.pz, leaf, **march)


def test_amr_drivers_on_card(cuda):
    """H-only and multi-frequency ionization on a deep grid through K5, K5s
    and K5d (the mirrors of tests/test_amr.py's deep tests)."""
    from cmacionize_torch.models import amr

    box = 1.0e17
    scheme = amr.SpatialRefinement((0.0,) * 3, (box / 16,) * 3, max_level=5)
    geom = GridGeometry((0.0,) * 3, (box,) * 3, (16, 16, 16))
    kernels.LAUNCHES.clear()
    sim = amr.AMRIonizationSimulation(
        geom, scheme, lambda p: np.full(len(p), 1e8), device=cuda,
        source_position=(0.05 * box,) * 3, luminosity=4.26e49, cross_section=6.3e-22,
        recombination_rate=4e-19, n_photons=1 << 16, max_level=5, seed=3)
    assert sim.grid.owner is None
    xn = sim.run(4)
    assert kernels.LAUNCHES["trace_octree"] == 4
    assert float(xn.min()) < 1e-2 and sim.ionized_volume() > 0
    assert tuple(sim.n_escaped.shape) == (4,)

    kernels.LAUNCHES.clear()
    grid = amr.build_amr_grid(geom, scheme, lambda p: np.full(len(p), 1e8), max_level=5)
    mf = amr.MultiFreqAMRSimulation(
        grid, lambda p: np.full(len(p), 1e8), device=cuda, source_position=(0.05 * box,) * 3,
        luminosity=4.26e49, n_photons=1 << 16,
        abundances={"He": 0.1, "C": 2.2e-4, "N": 4e-5, "O": 3.3e-4, "Ne": 5e-5, "S": 9e-6},
        do_temperature=True, diffuse_field=True, n_bins=16, n_reemission_rounds=2, seed=4)
    xion, T = mf.run(4)
    assert kernels.LAUNCHES["trace_octree_spectral"] == 12
    assert kernels.LAUNCHES["leaf_of_positions"] == 8
    assert kernels.LAUNCHES["temperature"] == 1
    xH = xion["H_n"].cpu().numpy()
    assert np.isfinite(xH).all() and xH.min() < 1e-2 and xH.max() > 0.9
    assert bool(torch.isfinite(T).all())


def _nudge_grid_inputs(cuda, n=4000):
    """tests/test_torch_amr.py::test_nudge_rounding_matches_jax's grid (8³,
    the corner half refined to level 2) and its two packets, the first of
    which stalls on the wall x = 1, after ``n`` seeded packets over the box;
    χ per coarse unit 10^U(-1.5, 0.5) per leaf."""
    from cmacionize_torch.models import amr

    grid = amr.build_amr_grid(GridGeometry((0.0,) * 3, (1.0,) * 3, (8, 8, 8)),
                              amr.SpatialRefinement((0.0,) * 3, (0.5,) * 3, 2),
                              lambda p: np.ones(len(p)), max_level=2)
    rng = np.random.default_rng(21)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = rng.uniform(0.5, 7.5, (n, 3))
    pos[: n // 4] = np.round(pos[: n // 4] * 4) / 4
    tau = -np.log1p(-rng.random(n)) * 3
    dx, dy = np.float32(-0.00011920929), np.float32(0.00095367426)
    pos = np.concatenate([pos, [[1.0, 6.3, 6.55], [3.0 - 1e-3, 7.9999986, 6.55]]])
    d = np.concatenate([d, [[dx, 1.0, 0.0], [1.0, dy, 0.0]]])
    tau = np.concatenate([tau, [1e3, 1e3]])
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda)  # noqa: E731
    pk = traversal.make_packets(t(pos), t(d), t(tau), t(rng.uniform(0.5, 1.5, n + 2)), (8, 8, 8))
    root, children = (torch.tensor(a, device=cuda) for a in grid.octree())
    chi = t(10 ** rng.uniform(-1.5, 0.5, grid.n_cells))
    return root, children, chi, pk, dict(coarse_shape=(8, 8, 8), max_level=2)


def _k5_and_plain(root, children, chi, pk, march, max_steps=0):
    """(K5's and the plain version's tally and batch) on one input; K5
    through the public march, one launch (none for no packets)."""
    from cmacionize_torch.ops import amr_traversal

    C = chi.numel()
    before = kernels.LAUNCHES["trace_octree"]
    tally_k, out_k = amr_traversal.trace_packets_octree(
        root, children, chi, pk, torch.zeros(C, device=chi.device), max_steps=max_steps,
        **march)
    assert kernels.LAUNCHES["trace_octree"] == before + (pk.size > 0)
    tally_r, out_r = amr_traversal.trace_packets_octree_reference(
        root, children, chi, pk, torch.zeros(C, device=chi.device), max_steps=max_steps, **march)
    torch.cuda.synchronize()
    return (tally_k, out_k), (tally_r, out_r)


def _assert_same_states(out_k, out_r):
    for f in ("px", "py", "pz", "tau_left"):
        assert torch.equal(getattr(out_k, f).view(torch.int32),
                           getattr(out_r, f).view(torch.int32)), f
    for f in ("active", "absorbed"):
        assert torch.equal(getattr(out_k, f), getattr(out_r, f)), f


@pytest.mark.parametrize("max_steps", [0, 1, 2])
def test_octree_kernel_ends_stalled_packets_as_the_plain_version(cuda, max_steps):
    # the stalled packet of the nudge test among seeded ones: K5 ends it at
    # its fixed point, the plain version at the cap, in the same state
    root, children, chi, pk, march = _nudge_grid_inputs(cuda)
    (tally_k, out_k), (tally_r, out_r) = _k5_and_plain(root, children, chi, pk, march,
                                                       max_steps)
    _assert_same_states(out_k, out_r)
    assert bool(out_k.active[-2]) and float(out_k.px[-2]) == 1.0
    assert float(out_k.py[-1]) == np.float32(8.0) - np.float32(2.0**-21)
    rel_l1 = float((tally_k - tally_r).abs().sum() / tally_r.abs().sum())
    assert rel_l1 <= 1e-4, rel_l1
    if max_steps == 0:
        assert 0 < int(out_k.absorbed.sum()) < pk.size


def test_octree_kernel_on_many_waves_of_blocks(cuda):
    # 2^20 packets on the level-5 grid: many waves of blocks, each of 256
    # packets in direction order
    from cmacionize_torch.kernels.trace_octree import occupancy

    grid = _octree_grid()
    root, children, chi, pk, march = _octree_inputs(grid, 7, 1 << 20, cuda)
    lanes = occupancy(cuda)
    assert pk.size > 3 * lanes["blocks_per_sm"] * lanes["sms"] * 256
    (tally_k, out_k), (tally_r, out_r) = _k5_and_plain(root, children, chi, pk, march)
    _compare_octree_marches(out_k, out_r, tally_k, tally_r, pk.size)
    assert 0 < int(out_r.absorbed.sum()) < pk.size


def test_octree_kernel_leaves_inactive_packets_as_handed_in(cuda):
    grid = _octree_grid(max_level=3, zone=0.25)
    root, children, chi, pk, march = _octree_inputs(grid, 8, 30_000, cuda)
    frozen = torch.arange(pk.size, device=cuda) % 3 == 1
    even = torch.arange(pk.size, device=cuda) % 2 == 0
    pk = pk._replace(active=~frozen, absorbed=frozen & even)
    (tally_k, out_k), (tally_r, out_r) = _k5_and_plain(root, children, chi, pk, march)
    _compare_octree_marches(out_k, out_r, tally_k, tally_r, pk.size)
    for f in ("px", "py", "pz", "tau_left", "active", "absorbed"):
        assert torch.equal(getattr(out_k, f)[frozen], getattr(pk, f)[frozen]), f


@pytest.mark.parametrize("n", [0, 1, 33])
def test_octree_kernel_on_few_packets(cuda, n):
    root, children, chi, pk, march = _nudge_grid_inputs(cuda, n=40)
    pk = pk._replace(**{f: v[-n:] if n else v[:0] for f, v in pk._asdict().items()})
    (tally_k, out_k), (tally_r, out_r) = _k5_and_plain(root, children, chi, pk, march)
    _assert_same_states(out_k, out_r)
    assert float((tally_k - tally_r).abs().sum()) <= 1e-4 * max(float(tally_r.sum()), 1e-30)


@pytest.mark.parametrize("max_level", [0, 3, 5, 10])
def test_octree_kernel_at_each_depth(cuda, max_level):
    # level 10: a grid far deeper than stromgren_amr's 3 levels, with a chain
    # of refined cells to the far corner
    from cmacionize_torch.models import amr

    if max_level == 10:
        class FarCornerChain:
            def refine(self, level, centers, volume, nd, fractions):
                if level >= 10:
                    return np.zeros(len(centers), bool)
                return np.all(centers > 1.0 - 1.0 / 16 / (2**level), axis=1)

        grid = amr.build_amr_grid(GridGeometry((0.0,) * 3, (1.0,) * 3, (16, 16, 16)),
                                  FarCornerChain(), lambda p: np.ones(len(p)), max_level=10)
        rng = np.random.default_rng(10)
        n = 4096
        d = rng.normal(size=(n, 3))
        d = torch.tensor((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32),
                         device=cuda)
        tau = torch.tensor((-np.log1p(-rng.random(n))).astype(np.float32), device=cuda)
        pk = traversal.make_packets(torch.full((n, 3), 15.95, device=cuda) + 1e-4 * d, d, tau,
                                    torch.ones(n, device=cuda), (16, 16, 16))
        root, children = (torch.tensor(a, device=cuda) for a in grid.octree())
        chi = torch.full((grid.n_cells,), 0.05, device=cuda)
        march = dict(coarse_shape=(16, 16, 16), max_level=10)
    elif max_level == 0:
        grid = amr.build_amr_grid(GridGeometry((0.0,) * 3, (1.0,) * 3, (16, 16, 16)), None,
                                  lambda p: np.ones(len(p)), max_level=0)
        root, children, chi, pk, march = _octree_inputs(grid, 11, 30_000, cuda)
    else:
        grid = _octree_grid(max_level=max_level, zone=1.0 / 16 if max_level == 5 else 0.25)
        root, children, chi, pk, march = _octree_inputs(grid, 12, 30_000, cuda)
    (tally_k, out_k), (tally_r, out_r) = _k5_and_plain(root, children, chi, pk, march)
    _compare_octree_marches(out_k, out_r, tally_k, tally_r, pk.size)
    assert int(out_r.absorbed.sum()) > 0


# -- K8, K8p: the dust peel-off ------------------------------------------------


def _dust_sim(cuda, shape=(40, 40, 40), **kw):
    from cmacionize_torch.models import dust_simulation as dust

    kpc = dust.KPC
    base = dict(geometry=GridGeometry((-12 * kpc,) * 3, (24 * kpc,) * 3, shape),
                dust_central_density=21.9 * 1.674e-27 * 1e6, dust_scale_radius=6 * kpc,
                dust_scale_height=0.22 * kpc, stellar_scale_radius=5 * kpc,
                stellar_scale_height=0.6 * kpc, n_photons=20000, ccd_pixels=(48, 40),
                view_theta=np.radians(89.7), view_phi=0.0)
    base.update(kw)
    return dust.DustSimulation(dust.DustConfig(**base), device=cuda, seed=5)


def _dust_events(sim, seed, n, cuda):
    rng = np.random.default_rng(seed)
    shape = np.asarray(sim.view.shape)
    pos = rng.uniform(size=(n, 3)) * (shape - 1e-3)
    pos[: n // 8] = np.round(pos[: n // 8] * 4) / 4  # on cell walls
    d = rng.normal(size=(n, 3))
    d[:64] = sim.view.phase_direction  # toward the observer
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    a = rng.normal(size=(n, 3))
    nref = a - (a * d).sum(1, keepdims=True) * d
    nref /= np.linalg.norm(nref, axis=1, keepdims=True)
    w = rng.uniform(0.5, 1.5, n) / n
    stokes = (w, *(rng.uniform(-0.3, 0.3, n) * w for _ in range(2)),
              rng.uniform(-0.05, 0.05, n) * w)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=cuda)

    active = torch.tensor(rng.uniform(size=n) < 0.8, device=cuda)
    return t(pos), t(d), t(nref), tuple(t(s) for s in stokes), active


DUST_VIEWS = {
    "edge-on": {},
    "face-on": dict(view_theta=0.0),
    "window": dict(view_theta=np.radians(35.0), view_phi=0.3, ccd_anchor=(-1.5e20, -1.2e20),
                   ccd_sides=(2.8e20, 2.2e20)),
    "periodic": dict(view_theta=np.radians(60.0), view_phi=1.0),
}


@pytest.mark.parametrize("view", sorted(DUST_VIEWS))
def test_peel_off_kernels_match_plain_versions(cuda, view):
    """K8 (emission and scattering) and K8p against their plain versions:
    identical τ and pixels, the images within f32 round-off."""
    from cmacionize_torch.kernels.peel_off import peel_off_cuda
    from cmacionize_torch.kernels.peel_off_polarized import peel_off_polarized_cuda
    from cmacionize_torch.ops import peel_off
    from cmacionize_torch.ops.polarization import ScatteringBand

    kw = dict(DUST_VIEWS[view])
    if view == "periodic":
        kpc = 3.086e19
        kw["geometry"] = GridGeometry((-12 * kpc, -16 * kpc, -10 * kpc),
                                      (24 * kpc, 32 * kpc, 20 * kpc), (24, 32, 20),
                                      (True, False, True))
    sim = _dust_sim(cuda, **kw)
    v = sim.view
    n = 50_000
    pos, d, nref, stokes, active = _dust_events(sim, 7, n, cuda)
    npix = v.pixels[0] * v.pixels[1]
    band = ScatteringBand(hgg=0.44, pl=0.43, albedo=0.67, kappa=0.0, sc=0.3, pc=0.2)

    def planes():
        return tuple(torch.zeros(npix, device=cuda) for _ in range(4))

    for direction in (None, d):
        ccd_k, ccd_r = torch.zeros(npix, device=cuda), torch.zeros(npix, device=cuda)
        tau_k = torch.empty(n, device=cuda)
        pix_k = torch.empty(n, dtype=torch.int32, device=cuda)
        before = kernels.LAUNCHES["peel_off"]
        peel_off_cuda(sim.chi, pos, direction, stokes[0], active, ccd_k, view=v, albedo=0.67,
                      hgg=0.44, tau_out=tau_k, pix_out=pix_k)
        assert kernels.LAUNCHES["peel_off"] == before + 1
        factor = peel_off.peel_off_factor(stokes[0], direction, view=v, albedo=0.67, hgg=0.44)
        tau_r, pix_r = peel_off.peel_off_deposit_reference(sim.chi, pos, factor, active, ccd_r,
                                                           view=v)
        torch.cuda.synchronize()
        assert torch.equal(tau_k[active], tau_r[active])
        assert torch.equal(pix_k[active], pix_r[active])
        assert bool((pix_k[~active] == -1).all())
        assert float(tau_r.max()) > 0.1
        rel_l1 = float((ccd_k - ccd_r).abs().sum() / ccd_r.abs().sum())
        assert rel_l1 <= 1e-5, rel_l1

    planes_k, planes_r = planes(), planes()
    tau_k = torch.empty(n, device=cuda)
    pix_k = torch.empty(n, dtype=torch.int32, device=cuda)
    before = kernels.LAUNCHES["peel_off_polarized"]
    peel_off_polarized_cuda(sim.chi, pos, d, nref, stokes, active, planes_k, view=v, band=band,
                            tau_out=tau_k, pix_out=pix_k)
    assert kernels.LAUNCHES["peel_off_polarized"] == before + 1
    tau_r, pix_r = peel_off.peel_off_polarized_reference(sim.chi, pos, d, nref, stokes, active,
                                                         planes_r, view=v, band=band)
    torch.cuda.synchronize()
    assert torch.equal(tau_k[active], tau_r[active])
    assert torch.equal(pix_k[active], pix_r[active])
    for k, a, b in zip("IQUV", planes_k, planes_r):
        rel_l1 = float((a - b).abs().sum() / b.abs().sum())
        assert rel_l1 <= 1e-5, (k, rel_l1)


def test_peel_off_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from cmacionize_torch.kernels.peel_off import peel_off_cuda
    from cmacionize_torch.kernels.peel_off_polarized import peel_off_polarized_cuda
    from cmacionize_torch.ops.polarization import ScatteringBand

    sim = _dust_sim(cuda, shape=(8, 8, 8))
    v = sim.view
    pos, d, nref, stokes, active = _dust_events(sim, 1, 100, cuda)
    ccd = torch.zeros(v.pixels[0] * v.pixels[1], device=cuda)
    with pytest.raises(ValueError, match="chi"):
        peel_off_cuda(sim.chi.double(), pos, None, stokes[0], active, ccd, view=v)
    with pytest.raises(ValueError, match="ccd"):
        peel_off_cuda(sim.chi, pos, None, stokes[0], active, ccd[:-1], view=v)
    with pytest.raises(ValueError, match="CUDA"):
        peel_off_cuda(sim.chi.cpu(), pos.cpu(), None, stokes[0].cpu(), active.cpu(), ccd.cpu(),
                      view=v)
    with pytest.raises(ValueError, match="active"):
        peel_off_cuda(sim.chi, pos, d, stokes[0], active.float(), ccd, view=v)
    with pytest.raises(ValueError, match="position"):
        peel_off_cuda(sim.chi, pos.t(), d, stokes[0], active, ccd, view=v)
    band = ScatteringBand(hgg=0.44, pl=0.43, albedo=0.67, kappa=0.0)
    with pytest.raises(ValueError, match="nref"):
        peel_off_polarized_cuda(sim.chi, pos, d, nref[:50], stokes, active, (ccd,) * 4, view=v,
                                band=band)
    with pytest.raises(ValueError, match="four"):
        peel_off_polarized_cuda(sim.chi, pos, d, nref, stokes, active, (ccd,) * 3, view=v,
                                band=band)


def test_dust_drivers_on_card(cuda, monkeypatch):
    """run() and run_polarized() on the card go through K1 for the
    interactions, K8 at emission and every order that scattered, K8p for the
    polarized orders, and never through the plain versions."""
    from cmacionize_torch.ops import peel_off

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for name in ("peel_off_deposit_reference", "peel_off_polarized_reference"):
        monkeypatch.setattr(peel_off, name, plain)
    monkeypatch.setattr(traversal, "trace_packets_reference", plain)
    sim = _dust_sim(cuda, shape=(48, 48, 48), ccd_pixels=(32, 32))
    kernels.LAUNCHES.clear()
    image = sim.run()
    counts = sim.scattered_per_order
    scattering_orders = sum(c > 0 for c in counts)
    assert kernels.LAUNCHES["trace_packets"] == len(counts)
    assert kernels.LAUNCHES["peel_off"] == 1 + scattering_orders
    assert counts[-1] == 0 or len(counts) == 12
    assert image.device.type == "cuda" and image.shape == (32, 32)
    assert bool(torch.isfinite(image).all()) and float(image.sum()) > 0

    kernels.LAUNCHES.clear()
    out = sim.run_polarized()
    counts = sim.scattered_per_order
    assert kernels.LAUNCHES["peel_off"] == 1
    assert kernels.LAUNCHES["peel_off_polarized"] == sum(c > 0 for c in counts)
    assert float(out["I"].sum()) > 0
    assert float(out["V"].abs().max()) <= 1e-8 * float(out["I"].max())
    assert float(out["Q"].sum()) < 0  # polarized parallel to the edge-on disc


# ------------------------------------------------- K9c, K9p and the sharded drivers


def _same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("n, capacity", [
    (0, 10), (5, 0), (1000, 300), (1000, 1000), (3000, 4097),
    (1_062_500, 1_000_000),  # the slab merge at 1e6 packets
])
@pytest.mark.parametrize("share", [0.0, 0.02, 0.5, 1.0])
def test_compact_kernel_equals_plain_version(cuda, n, capacity, share):
    """K9c against compact_reference: every lane, every bit, every count."""
    from cmacionize_torch.parallel import domain

    rng = np.random.default_rng(n + capacity)
    fields = tuple(torch.tensor(rng.standard_normal(n).astype(np.float32), device=cuda)
                   for _ in range(8))
    mask = torch.tensor(rng.uniform(size=n) < share, device=cuda)
    kernels.LAUNCHES.clear()
    out, in_range, over = domain.compact(fields, mask, capacity)
    assert kernels.LAUNCHES["compact"] == 1
    ref, ref_range, ref_over = domain.compact_reference(fields, mask, capacity)
    assert all(_same_bits(a, b) for a, b in zip(out, ref))
    assert torch.equal(in_range, ref_range) and int(over) == int(ref_over)


@pytest.mark.parametrize("n, capacities", [
    (1000, (300, 700)), (4000, (5000, 17)), (2_000_000, (531_250, 531_250)),
])
def test_partition_kernel_equals_plain_version(cuda, n, capacities):
    """K9p against partition_reference, with and without the frame shift."""
    from cmacionize_torch.parallel import domain

    rng = np.random.default_rng(n)
    fields = tuple(torch.tensor(rng.standard_normal(n).astype(np.float32), device=cuda)
                   for _ in range(8))
    codes = rng.choice([-1, 0, 1], size=n, p=[0.9, 0.05, 0.05]).astype(np.int8)
    bucket = torch.tensor(codes, device=cuda)
    for shifts in ((16.0, -16.0), (None, None)):
        kernels.LAUNCHES.clear()
        out = domain.partition(fields, bucket, capacities, shifts)
        assert kernels.LAUNCHES["partition"] == 1
        ref = domain.partition_reference(fields, bucket, capacities, shifts)
        for (f, r, o), (fr, rr, orr) in zip(out, ref):
            assert all(_same_bits(a, b) for a, b in zip(f, fr))
            assert torch.equal(r, rr) and int(o) == int(orr)


def test_compact_kernels_refuse_what_they_do_not_take(cuda):
    from cmacionize_torch.kernels.compact import compact_cuda, partition_cuda

    f = torch.zeros(10, device=cuda)
    with pytest.raises(ValueError, match="bool"):
        compact_cuda((f,), torch.zeros(10, dtype=torch.int8, device=cuda), 4)
    with pytest.raises(ValueError, match="float32"):
        compact_cuda((f.double(),), torch.zeros(10, dtype=torch.bool, device=cuda), 4)
    with pytest.raises(ValueError, match="fields"):
        compact_cuda((f,) * 9, torch.zeros(10, dtype=torch.bool, device=cuda), 4)
    with pytest.raises(ValueError, match="two"):
        partition_cuda((f,), torch.zeros(10, dtype=torch.int8, device=cuda), (4,))


def test_sharded_honly_driver_on_card(cuda):
    """(2, 2, 2) tiles on the card: K1, K9p and K9c launched, no plain
    version; the ionized volume within 15% of the single-device run."""
    geometry = GridGeometry((-5 * 3.086e16,) * 3, (10 * 3.086e16,) * 3, (16, 16, 16))
    config = HOnlyConfig(
        geometry=geometry, number_density=1e8, temperature=8000.0,
        source_position=(0.0, 0.0, 0.0), luminosity=4.26e49, cross_section=6.3e-22,
        recombination_rate=4e-19, n_photons=16384, n_iterations=5)
    from cmacionize_torch.models.ionization_simulation import ShardedHOnlyIonizationSimulation

    kernels.LAUNCHES.clear()
    sharded = ShardedHOnlyIonizationSimulation(config, tiling=(2, 2, 2), seed=3)
    xh = sharded.run().cpu().numpy()
    assert all(d.type == "cuda" for d in sharded.mesh.devices)
    assert kernels.LAUNCHES["compact"] > 0 and kernels.LAUNCHES["partition"] > 0
    assert kernels.LAUNCHES["trace_packets"] >= 8 * 5
    assert sharded.last_diagnostics["buffer_overflow"] == 0
    assert sharded.last_diagnostics["truncated_live"] == 0
    single = HOnlyIonizationSimulation(config, device=cuda, seed=3).run().cpu().numpy()
    assert (xh < 0.5).sum() == pytest.approx((single < 0.5).sum(), rel=0.15)


def test_sharded_rhd_driver_on_card(cuda):
    """(4, 1, 1) slabs on the card: K1, K3 and the exchange kernels; the front
    within 10% and the mass within 1e-4 of the single-device run."""
    from cmacionize_torch.models.rhd_simulation import RHDConfig, ShardedRHDSimulation

    pc, total = 3.086e16, 0.05 * 3.15576e13
    config = RHDConfig(
        geometry=GridGeometry((-1.256 * pc,) * 3, (2.512 * pc,) * 3, (16, 16, 16)),
        gamma=1.0001, timestep=total / 64.0, total_time=total, luminosity=1e49,
        source_position=(0.0, 0.0, 0.0), cross_section=6.3e-22, recombination_rate=2.7e-19,
        n_photons=8192, nloop=2, background_density=3.113e9, background_temperature=100.0)
    kernels.LAUNCHES.clear()
    sharded = ShardedRHDSimulation(config, tiling=(4, 1, 1), seed=5)
    sharded.advance(24, log_every=10**9)
    assert kernels.LAUNCHES["hydro_step"] == 4 * 24
    assert kernels.LAUNCHES["compact"] > 0
    assert sharded.last_diagnostics["buffer_overflow"] == 0
    single = RHDSimulation(config, device=cuda, seed=5)
    single.advance(24, log_every=10**9)
    assert sharded.ionization_front_radius() == pytest.approx(
        single.ionization_front_radius(), rel=0.1)
    assert float(sharded.state.rho.double().sum()) == pytest.approx(
        float(single.state.rho.double().sum()), rel=1e-4)


# -- K10, K11, K11r, K12t, K12r, K12s, K12a ----------------------------------------------------------


def _cone_compare(out_k, out_r, n, max_state_mismatch=1):
    """K10 against its plain version: state mismatches within 1e-5 of the
    lanes (at least one lane: the two sum a slab's optical depth in other
    orders), positions within 1e-4 cells and cells equal where the states
    agree, tally rel L1 <= 1e-5."""
    (tally_k, pf_k, pi_k), (tally_r, pf_r, pi_r) = out_k, out_r
    same = pi_k[:, 3] == pi_r[:, 3]
    assert int((~same).sum()) <= max(max_state_mismatch, 1e-5 * n)
    assert float((pf_k[same, :3] - pf_r[same, :3]).abs().max()) <= 1e-4
    assert torch.equal(pi_k[same, :3], pi_r[same, :3])
    assert torch.equal(pf_k[:, 3:6], pf_r[:, 3:6]) and torch.equal(pf_k[:, 7], pf_r[:, 7])
    rel_l1 = float((tally_k - tally_r).abs().sum() / tally_r.abs().sum())
    assert rel_l1 <= 1e-5, rel_l1


def test_cone_kernel_equals_plain_version_on_stratified_lanes(cuda):
    from cmacionize_torch.tools import experimental_cone_kernel as cone
    from cmacionize_torch.tools import experimental_emission_octa as octa

    shape, n = (32, 32, 32), 2**14
    rng = np.random.default_rng(21)
    chi = torch.tensor(rng.uniform(0.0, 0.3, shape).astype(np.float32), device=cuda)
    generator = torch.Generator(device=cuda).manual_seed(21)
    pf, pi = cone.pack_packets(*octa.emit_point_source_stratified(
        generator, n, (16.0, 16.0, 16.0), cuda), shape)
    kernels.LAUNCHES.clear()
    out_k = cone.trace_packets_cone(chi, pf, pi, shape=shape)
    assert kernels.LAUNCHES["trace_packets_cone"] == 1
    out_r = cone.trace_packets_cone_reference(chi, pf, pi, shape=shape)
    torch.cuda.synchronize()
    states = torch.bincount(out_r[2][:, 3], minlength=3)
    assert states[0] == 0 and states[1] > 0 and states[2] > 0
    _cone_compare(out_k, out_r, n)


def test_cone_kernel_equals_plain_version_on_incoherent_lanes(cuda):
    from cmacionize_torch.tools import experimental_cone_kernel as cone

    shape, n = (32, 24, 20), 2**14
    rng = np.random.default_rng(22)
    chi = torch.tensor(rng.uniform(0.0, 0.3, shape).astype(np.float32), device=cuda)
    pos = rng.uniform(0.0, 1.0, (n, 3)) * np.asarray(shape)
    v = rng.normal(size=(n, 3))
    d = v / np.linalg.norm(v, axis=1, keepdims=True)
    tau = -np.log(rng.uniform(1e-10, 1.0, n))
    pf, pi = cone.pack_packets(*(torch.tensor(np.asarray(a, np.float32), device=cuda)
                                 for a in (pos, d, tau, np.ones(n))), shape)
    in_flight = []
    for max_phases in (4, 128):
        out_k = cone.trace_packets_cone(chi, pf, pi, shape=shape, max_phases=max_phases)
        out_r = cone.trace_packets_cone_reference(chi, pf, pi, shape=shape,
                                                  max_phases=max_phases)
        torch.cuda.synchronize()
        in_flight.append(int((out_r[2][:, 3] == 0).sum()))
        _cone_compare(out_k, out_r, n)
    # mixed signs in a chunk march with more phases: some lanes stay in
    # flight after 4, fewer after 128
    assert in_flight[0] > in_flight[1]
    assert torch.equal(pi[:, 3], torch.zeros_like(pi[:, 3]))  # the inputs are untouched


def test_cone_kernel_places_what_the_plain_version_leaves_unplaced(cuda):
    # 512 lanes along +x from x = 0 through an 8³ grid, eight in each row,
    # tau_left the plain version's prefix-scan total of the row.  Where its
    # slab sum rounds above that, the plain version (on the CPU here, so that
    # the sum's order is fixed) absorbs the lane where it entered; K10 sums
    # the row in travel order and absorbs the lane in the row's last cell
    # where that sum rounds above tau_left, else lets it escape at x = 8
    from cmacionize_torch.tools import experimental_cone_kernel as cone

    shape = (8, 8, 8)
    chi = np.random.default_rng(5).uniform(0.0, 1.0, shape).astype(np.float32)
    row = np.arange(512) % 64
    y, z = row // 8, row % 8
    tau = []
    for j, k in zip(y, z):
        a = chi[:, j, k]
        for shift in (1, 2, 4):
            a = np.concatenate([a[:shift], a[shift:] + a[:-shift]])
        tau.append(a[-1])
    tau = np.asarray(tau, np.float32)
    travel_sum = np.cumsum(chi[:, y, z], axis=0, dtype=np.float32)[-1]
    k10_absorbs = torch.tensor(tau < travel_sum)
    packets = (np.stack([np.zeros(512), y + 0.5, z + 0.5], axis=1), np.tile([1.0, 0, 0], (512, 1)),
               tau, np.ones(512))
    pf, pi = cone.pack_packets(*(torch.tensor(np.asarray(a, np.float32)) for a in packets), shape)
    stats = {}
    tally_r, pf_r, pi_r = cone.trace_packets_cone_reference(torch.tensor(chi), pf, pi,
                                                            shape=shape, stats=stats)
    kernels.LAUNCHES.clear()
    tally_k, pf_k, pi_k = (a.cpu() for a in cone.trace_packets_cone(
        torch.tensor(chi, device=cuda), pf.to(cuda), pi.to(cuda), shape=shape))
    assert kernels.LAUNCHES["trace_packets_cone"] == 1
    unplaced = stats["unplaced"]
    assert int((unplaced & k10_absorbs).sum()) > 0 and int((~k10_absorbs).sum()) > 0
    assert (pi_r[unplaced, 3] == 1).all() and (pf_r[unplaced, 0] == 0.0).all()
    assert torch.equal(pi_k[:, 3], torch.where(k10_absorbs, 1, 2).to(torch.int32))
    x = pf_k[:, 0]
    assert ((x[k10_absorbs] > 7.0) & (x[k10_absorbs] <= 8.0)).all()
    assert (x[~k10_absorbs] == 8.0).all()
    assert torch.equal(pf_k[:, 1:3], pf_r[:, 1:3])
    placed = (pi_k[:, 3] == pi_r[:, 3]) & ~unplaced
    assert float((pf_k[placed, :3] - pf_r[placed, :3]).abs().max()) <= 1e-4
    rel_l1 = float((tally_k - tally_r).abs().sum() / tally_r.abs().sum())
    assert rel_l1 <= 1e-5, rel_l1


def _cone_lanes(rng, shape, n):
    """Random positions and isotropic directions anywhere in the box."""
    pos = rng.uniform(0.0, 1.0, (n, 3)) * np.asarray(shape)
    v = rng.normal(size=(n, 3))
    d = v / np.linalg.norm(v, axis=1, keepdims=True)
    tau = -np.log(rng.uniform(1e-10, 1.0, n))
    return pos, d, tau, np.ones(n)


@pytest.mark.parametrize("max_phases", [0, 1, 2])
def test_cone_kernel_stops_at_max_phases(cuda, max_phases):
    """A chunk runs at most max_phases phases (none at 0: the state is the
    input's), as the plain version does; launched from a side stream."""
    from cmacionize_torch.tools import experimental_cone_kernel as cone

    shape, n = (24, 16, 20), 2048
    rng = np.random.default_rng(30 + max_phases)
    chi = torch.tensor(rng.uniform(0.0, 0.2, shape).astype(np.float32), device=cuda)
    pf, pi = cone.pack_packets(*(torch.tensor(np.asarray(a, np.float32), device=cuda)
                                 for a in _cone_lanes(rng, shape, n)), shape)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    kernels.LAUNCHES.clear()
    with torch.cuda.stream(side):
        out_k = cone.trace_packets_cone(chi, pf, pi, shape=shape, max_phases=max_phases)
    torch.cuda.current_stream().wait_stream(side)
    out_r = cone.trace_packets_cone_reference(chi, pf, pi, shape=shape, max_phases=max_phases)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["trace_packets_cone"] == 1
    if max_phases == 0:  # nothing marched: the input's state and an empty tally
        for out in (out_k, out_r):
            assert torch.equal(out[1], pf) and torch.equal(out[2], pi)
            assert float(out[0].abs().max()) == 0.0
    else:
        assert int((out_k[2][:, 3] == 0).sum()) > 0  # lanes left in flight
        _cone_compare(out_k, out_r, n)


def test_cone_kernel_repeats_its_states_bit_for_bit(cuda):
    """Back to back and from a side stream: identical states and positions
    (the tally's atomics may add in another order)."""
    from cmacionize_torch.tools import experimental_cone_kernel as cone
    from cmacionize_torch.tools import experimental_emission_octa as octa

    shape, n = (32, 32, 32), 2**16  # n / 8 = 2 k^2 for the stratified emission
    rng = np.random.default_rng(31)
    chi = torch.tensor(rng.uniform(0.0, 0.3, shape).astype(np.float32), device=cuda)
    generator = torch.Generator(device=cuda).manual_seed(31)
    pf, pi = cone.pack_packets(*octa.emit_point_source_stratified(
        generator, n, (11.0, 19.0, 16.0), cuda), shape)
    first = cone.trace_packets_cone(chi, pf, pi, shape=shape)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        second = cone.trace_packets_cone(chi, pf, pi, shape=shape)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for a, b in zip(first[1:], second[1:]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    rel_l1 = float((first[0] - second[0]).abs().sum() / first[0].abs().sum())
    assert rel_l1 <= 1e-6, rel_l1


def test_cone_kernel_layout(cuda):
    """K10 fits three blocks of 512 threads on an SM (its first port: two)."""
    from cmacionize_torch.kernels import trace_packets_cone as k10

    layout = k10.occupancy(cuda)
    assert layout["blocks_per_sm"] >= 3 and layout["registers"] <= 42, layout


def test_cone_kernel_on_the_saved_fault(cuda):
    """tests/torch_cone_fault.npz: phase 32's final χ from a card run and the
    chunks of two lanes that phase 33's check once refused (several
    cells held their tau_left in the plain version's prefix scans).  K10 gives
    the saved states and positions bit for bit and passes the repaired check
    against the plain version on the card: the two lanes at the first cell's
    point."""
    from cmacionize_torch.tools import experimental_cone_kernel as cone

    saved = np.load(os.path.join(ROOT, "tests", "torch_cone_fault.npz"))
    chi = torch.tensor(saved["chi"], device=cuda)
    shape = tuple(chi.shape)
    pf, pi = (torch.tensor(saved[k], device=cuda) for k in ("pf", "pi"))
    kernels.LAUNCHES.clear()
    out_k = cone.trace_packets_cone(chi, pf, pi, shape=shape)
    stats = {}
    out_r = cone.trace_packets_cone_reference(chi, pf, pi, shape=shape, stats=stats)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["trace_packets_cone"] == 1
    assert torch.equal(out_k[1].cpu(), torch.tensor(saved["pf_k"]))
    assert torch.equal(out_k[2].cpu(), torch.tensor(saved["pi_k"]))
    verdicts = cone.lane_verdicts(out_k, out_r, stats, position_tol=1e-4, diagonal=8 * 3**0.5)
    assert verdicts["refused"] == []
    rows = [list(saved["chunks"]).index(int(lane) // 512) * 512 + int(lane) % 512
            for lane in saved["lanes"]]
    assert all(int(stats["hits"][r]) > 1 for r in rows) and len(verdicts["several"]) >= 2
    rel_l1 = float((out_k[0] - out_r[0]).abs().sum() / out_r[0].abs().sum())
    assert rel_l1 <= 1e-5, rel_l1


def test_cone_kernel_refuses_what_it_does_not_take(cuda):
    from cmacionize_torch.kernels.trace_packets_cone import trace_packets_cone_cuda

    shape = (8, 8, 8)
    chi = torch.zeros(shape, device=cuda)
    pf = torch.zeros((512, 8), device=cuda)
    pi = torch.zeros((512, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="slab=8, chunk=512"):
        trace_packets_cone_cuda(chi, chi.clone(), pf, pi, shape=shape, slab=4, chunk=512,
                                max_phases=8)
    with pytest.raises(ValueError, match="pi must be"):
        trace_packets_cone_cuda(chi, chi.clone(), pf, pi.float(), shape=shape, slab=8,
                                chunk=512, max_phases=8)


@pytest.mark.parametrize("n", [1, 1000, 2**20 + 3])
def test_gather_kernels_equal_plain_versions(cuda, n):
    from cmacionize_torch.kernels import gather

    rng = np.random.default_rng(n)
    n_cell = 64**3
    idx = rng.integers(0, n_cell, n).astype(np.int32)
    idx[0] = n_cell - 1
    idx[-1] = 0
    idx = torch.tensor(idx, device=cuda)
    tbl = torch.tensor(rng.normal(size=n_cell).astype(np.float32), device=cuda)
    tbl2 = tbl.reshape(-1, 128)
    kernels.LAUNCHES.clear()
    assert torch.equal(gather.gather(tbl, idx), gather.gather_reference(tbl, idx))
    rows, lanes = idx // 128, idx % 128
    assert torch.equal(gather.gather2d(tbl2, rows, lanes),
                       gather.gather2d_reference(tbl2, rows, lanes))
    assert kernels.LAUNCHES["gather"] == 1 and kernels.LAUNCHES["gather2d"] == 1
    with pytest.raises(ValueError, match="idx must be"):
        gather.gather(tbl, idx.long())


def _probe_lookups(rng, n, hi, shape, cuda):
    """``n`` random indices below ``hi`` with the first and last entries of
    the table among them, int32 on the card."""
    idx = rng.integers(0, hi, n)
    idx[0], idx[-1] = hi - 1, 0
    return torch.tensor(idx.astype(np.int32).reshape(shape), device=cuda)


@pytest.mark.parametrize("n", [8192, 2**20])
def test_probe_gather_kernels_equal_plain_versions(cuda, n):
    from cmacionize_torch.kernels import probe_gather as pg

    rng = np.random.default_rng(n + 1)

    def table(rows, width):
        return torch.tensor(rng.normal(size=(rows, width)).astype(np.float32), device=cuda)

    blk = table(n, 128)
    lanes = _probe_lookups(rng, n, 128, (n, 1), cuda)
    tab_rows = table(4096, 64)
    rows = _probe_lookups(rng, n, 4096, (n,), cuda)
    tab = table(2048, 128)
    sub = _probe_lookups(rng, n, 2048, (n // 128, 128), cuda)
    flat = torch.tensor(rng.permutation(2048 * 128)[:min(n, 2048 * 128)].astype(np.int32),
                        device=cuda)
    val = torch.tensor(rng.normal(size=flat.shape).astype(np.float32), device=cuda)
    kernels.LAUNCHES.clear()
    assert torch.equal(pg.take_along_lanes(blk, lanes), pg.take_along_lanes_reference(blk, lanes))
    assert torch.equal(pg.row_gather(tab_rows, rows), pg.row_gather_reference(tab_rows, rows))
    assert torch.equal(pg.sublane_gather(tab, sub), pg.sublane_gather_reference(tab, sub))
    # distinct indices: no two atomics meet
    assert torch.equal(pg.scatter_add(flat, val, (2048, 128)),
                       pg.scatter_add_reference(flat, val, (2048, 128)))
    assert {k: kernels.LAUNCHES[k] for k in (
        "take_along_lanes", "row_gather", "sublane_gather", "scatter_add")} == {
        "take_along_lanes": 1, "row_gather": 1, "sublane_gather": 1, "scatter_add": 1}


def test_scatter_add_kernel_with_duplicates(cuda):
    from cmacionize_torch.kernels import probe_gather as pg

    rng = np.random.default_rng(5)
    idx = _probe_lookups(rng, 2**20, 65536, (2**12, 256), cuda)  # ~16 lookups per index
    weights = torch.tensor(rng.integers(-3, 4, idx.shape).astype(np.float32), device=cuda)
    out = pg.scatter_add(idx, weights, (2048, 128))
    assert torch.equal(out, pg.scatter_add_reference(idx, weights, (2048, 128)))
    assert float(out.view(-1)[65536:].abs().max()) == 0.0  # zeroed past the indices
    weights = torch.tensor(rng.uniform(0.0, 1.0, idx.shape).astype(np.float32), device=cuda)
    out = pg.scatter_add(idx, weights, (2048, 128))
    ref = pg.scatter_add_reference(idx, weights, (2048, 128))
    assert float((out - ref).abs().sum() / ref.abs().sum()) <= 1e-6


def test_flat_gather_2d_launches_k11r(cuda):
    from cmacionize_torch.tools import probe_pallas_gather as tool

    fn, args = tool.b_flat_gather_2d(cuda)
    kernels.LAUNCHES.clear()
    out = fn(*args)
    assert kernels.LAUNCHES["gather2d"] == 1
    tab, hi, lo = args
    assert out.shape == hi.shape and torch.equal(out, tab[hi.long(), lo.long()])


def test_probe_gather_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from cmacionize_torch.kernels import probe_gather as pg

    tab = torch.zeros((2048, 128), device=cuda)
    idx = torch.zeros((8, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="idx must be"):
        pg.sublane_gather(tab, idx.long())
    with pytest.raises(ValueError, match="tab must be"):
        pg.sublane_gather(tab.double(), idx)
    with pytest.raises(ValueError, match="idx must be"):
        pg.sublane_gather(tab, idx.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        pg.sublane_gather(tab, idx.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        pg.take_along_lanes(tab[:, ::2], idx[:, :1].repeat(256, 1))
    with pytest.raises(ValueError, match="idx must be"):
        pg.take_along_lanes(tab, idx[:, :2].contiguous())
    with pytest.raises(ValueError, match="idx must be"):
        pg.row_gather(tab, idx)
    with pytest.raises(ValueError, match="val must be"):
        pg.scatter_add(idx, idx, (2048, 128))
    with pytest.raises(ValueError, match="one shape"):
        pg.scatter_add(idx, tab[:4], (2048, 128))


# K12s and K12t, the kernels on kernels/launch.py: seeded arguments of n
# lookups (the tables' first and last entries among them)
def _launch_path_args(name, rng, n, cuda):
    def table(rows, width):
        return torch.tensor(rng.normal(size=(rows, width)).astype(np.float32), device=cuda)

    if name == "sublane_gather":
        return table(2048, 128), _probe_lookups(rng, n, 2048, (n // 128, 128), cuda)
    return table(n, 128), _probe_lookups(rng, n, 128, (n, 1), cuda)


LAUNCH_PATH_KERNELS = ("sublane_gather", "take_along_lanes")


def _launch_path_case(name, case, cuda):
    from cmacionize_torch.kernels import probe_gather as pg
    from cmacionize_torch.tools import probe_pallas_gather as tool

    fn, plain = getattr(pg, name), getattr(pg, f"{name}_reference")
    if case == "probe":
        make = tool.b_sublane_gather if name == "sublane_gather" else tool.b_taa_lanes
        return fn, plain, make(cuda)[1]
    n = {"seeded": 1024 if name == "sublane_gather" else 8192, "2^20": 2**20}[case]
    return fn, plain, _launch_path_args(name, np.random.default_rng(n + len(name)), n, cuda)


@pytest.mark.parametrize("case", ["probe", "seeded", "2^20"])
@pytest.mark.parametrize("name", LAUNCH_PATH_KERNELS)
def test_launch_path_kernels_equal_plain_versions(cuda, name, case):
    fn, plain, args = _launch_path_case(name, case, cuda)
    kernels.LAUNCHES.clear()
    out = fn(*args)
    assert kernels.LAUNCHES[name] == 1  # once per call
    out2 = fn(*args)
    assert kernels.LAUNCHES[name] == 2
    ref = plain(*args)
    assert out.dtype == torch.float32 and out.shape == args[1].shape and out.is_contiguous()
    assert torch.equal(out, ref) and torch.equal(out2, ref)


@pytest.mark.parametrize("name", LAUNCH_PATH_KERNELS)
def test_launch_path_on_a_side_stream(cuda, name):
    # the default stream is kept busy; a kernel launched there instead of on
    # the side stream would run after the side stream's copy had read out
    fn, plain, args = _launch_path_case(name, "2^20", cuda)
    ref = plain(*args).cpu()
    big = torch.randn((4096, 4096), device=cuda)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    for _ in range(8):
        big = big @ big / 64.0
    with torch.cuda.stream(side):
        out = fn(*args)
        host = out.cpu()  # a torch op on the side stream, its only synchronise
    assert torch.equal(host, ref)


@pytest.mark.parametrize("name", LAUNCH_PATH_KERNELS)
def test_launch_path_in_a_cuda_graph(cuda, name):
    fn, plain, args = _launch_path_case(name, "seeded", cuda)
    rng = np.random.default_rng(7)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    kernels.LAUNCHES.clear()
    with torch.cuda.graph(graph):
        out = fn(*args)
    assert kernels.LAUNCHES[name] == 1
    for _ in range(2):  # new inputs in the captured tensors, then a replay
        table, idx = _launch_path_args(name, rng, args[1].numel(), cuda)
        args[0].copy_(table)
        args[1].copy_(idx)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, plain(*args))
    assert kernels.LAUNCHES[name] == 1  # a replay calls no wrapper


@pytest.mark.parametrize("name", LAUNCH_PATH_KERNELS)
def test_launch_path_rejects_what_the_kernels_do_not_take(cuda, name):
    from cmacionize_torch.kernels import probe_gather as pg

    fn, _, (tab, idx) = _launch_path_case(name, "probe", cuda)
    table = "tab" if name == "sublane_gather" else "blk"
    kernels.LAUNCHES.clear()
    with pytest.raises(ValueError, match=f"{table} must be"):
        fn(tab.double(), idx)
    with pytest.raises(ValueError, match="idx must be"):
        fn(tab, idx.long())
    with pytest.raises(ValueError, match="idx must be"):
        fn(tab, idx.cpu())
    with pytest.raises(ValueError, match=f"{table} must be contiguous"):
        fn(tab.t().contiguous().t(), idx)
    with pytest.raises(ValueError, match="idx must be contiguous"):
        fn(tab, torch.stack([idx, idx], -1)[..., 0])
    with pytest.raises(ValueError, match="idx must be"):
        fn(tab, idx.reshape(-1))
    assert kernels.LAUNCHES[name] == 0
    launcher = pg._SUBLANE_GATHER if name == "sublane_gather" else pg._TAKE_ALONG_LANES
    with pytest.raises(TypeError):  # typed once: five ints and the stream, not two
        launcher(tab.get_device(), 1, 2)
    huge = torch.empty((2**24, 128), device=cuda)  # 2^31 elements, never read
    with pytest.raises(ValueError, match="sizes must fit int32"):
        fn(huge, idx if name == "sublane_gather" else torch.zeros((2**24, 1), dtype=torch.int32,
                                                                  device=cuda))
    assert kernels.LAUNCHES[name] == 0


def test_probe_tool_on_card(cuda, capsys):
    from cmacionize_torch.tools import probe_pallas_gather as tool

    kernels.LAUNCHES.clear()
    seconds = tool.main(device=cuda)
    assert list(seconds) == [name for name, _ in tool.PROBES]
    assert all(kernels.LAUNCHES[k] > 0 for k in (
        "take_along_lanes", "row_gather", "gather2d", "sublane_gather", "scatter_add"))
    assert capsys.readouterr().out.count("correct=True") == 5


# -- K13h, K13e, K13w, K13f, K14a, K14b, K14c ----------------------------------------------------------


def _seeded_lanes(rng, n, cuda):
    """Directions for the DDA probes: a in [0.05, 0.95], b in [-0.6, 0.6]
    with a few b = 0 (K13e's 1e-12 branch) and lanes past the unit circle
    (its dz = 0 branch)."""
    a = rng.uniform(0.05, 0.95, n).astype(np.float32)
    b = rng.uniform(-0.6, 0.6, n).astype(np.float32)
    b[:4] = 0.0
    return torch.tensor(a, device=cuda), torch.tensor(b, device=cuda)


@pytest.mark.parametrize("nstep", [0, 1, 300, 7808])
@pytest.mark.parametrize("weights", ["integer", "random"])
def test_shifted_histogram_kernel_equals_plain_version(cuda, nstep, weights):
    from cmacionize_torch.kernels import probe_deposit as pd

    rng = np.random.default_rng(nstep)
    n = 4099  # not a multiple of the block
    lidx = rng.integers(0, 128, n)
    lidx[:2] = (0, 127)
    dep = rng.integers(-3, 4, n) if weights == "integer" else rng.uniform(0.0, 1.0, n)
    dep = torch.tensor(dep.astype(np.float32), device=cuda)
    lidx = torch.tensor(lidx.astype(np.int32), device=cuda)
    kernels.LAUNCHES.clear()
    out = pd.shifted_histogram(dep, lidx, nstep)
    ref = pd.shifted_histogram_reference(dep, lidx, nstep)
    assert kernels.LAUNCHES["shifted_histogram"] == 1 and out.shape == (128,)
    if weights == "integer" or nstep == 0:
        assert torch.equal(out, ref)
    else:
        assert float(((out - ref).abs() / ref.abs()).max()) <= 1e-5
    if nstep == 0:
        assert float(out.abs().max()) == 0.0


@pytest.mark.parametrize("n", [1024, 2**16 + 5])
def test_dda_kernels_equal_plain_versions(cuda, n):
    from cmacionize_torch.kernels import probe_deposit as pd
    from cmacionize_torch.tools import probe_deposit as tool

    nstep = 7808 if n == 1024 else 300
    cases = [_seeded_lanes(np.random.default_rng(n), n, cuda)]
    if n == 1024:
        a, b = tool.e_inputs(cuda)
        cases.append((a.reshape(-1).contiguous(), b.reshape(-1).contiguous()))
    kernels.LAUNCHES.clear()
    for a, b in cases:
        assert torch.equal(pd.dda_math(a, b, nstep), pd.dda_math_reference(a, b, nstep))
        assert torch.equal(pd.dda_incremental(a, b, nstep),
                           pd.dda_incremental_reference(a, b, nstep))
    assert kernels.LAUNCHES["dda_math"] == kernels.LAUNCHES["dda_incremental"] == len(cases)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 65, 1024, 2**16 + 5])
def test_dda_math_kernel_on_blocks_and_small_divisors(cuda, n):
    """K13e against its plain version bit for bit at lane counts around its
    blocks of 32, with one warp all of whose lanes divide by 1e-12 (b = 0,
    and dz = 0 past the unit circle), launched from a side stream too."""
    from cmacionize_torch.kernels import probe_deposit as pd

    rng = np.random.default_rng(40 + n)
    a = rng.uniform(0.05, 0.95, n).astype(np.float32)
    b = rng.uniform(-0.6, 0.6, n).astype(np.float32)
    warp = slice(32, 64) if n >= 64 else slice(0, n)
    a[warp] = rng.uniform(0.9, 0.95, len(a[warp])).astype(np.float32)
    b[warp] = np.where(np.arange(len(a[warp])) % 2 == 0, 0.0, a[warp] * 0.5).astype(np.float32)
    a, b = torch.tensor(a, device=cuda), torch.tensor(b, device=cuda)
    nstep = 7808 if n <= 1024 else 300
    kernels.LAUNCHES.clear()
    out = pd.dda_math(a, b, nstep)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = pd.dda_math(a, b, nstep)
    torch.cuda.current_stream().wait_stream(side)
    ref = pd.dda_math_reference(a, b, nstep)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dda_math"] == 2
    assert torch.equal(out, ref) and torch.equal(again, ref)


def test_dda_math_kernel_refuses_what_it_does_not_take(cuda):
    from cmacionize_torch.kernels import probe_deposit as pd

    a = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="dda_math: b must be"):
        pd.dda_math(a, a.double(), 10)
    with pytest.raises(ValueError, match="one shape"):
        pd.dda_math(a, torch.zeros(65, device=cuda), 10)
    with pytest.raises(ValueError, match="nstep"):
        pd.dda_math(a, a, -1)


def test_fill_first_kernel_copies_the_first_bits(cuda):
    from cmacionize_torch.kernels import probe_deposit as pd

    dep = torch.tensor(np.random.default_rng(3).normal(size=(8, 128)).astype(np.float32),
                       device=cuda)
    for first in (1.5, -0.0, float("inf")):
        dep[0, 0] = first
        out, ref = pd.fill_first(dep), pd.fill_first_reference(dep)
        assert out.shape == (1, 128)
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
        assert torch.equal(out.view(torch.int32), dep[:1, :1].view(torch.int32).expand(1, 128))


@pytest.mark.parametrize("n", [0, 2048, 100_003])
def test_count_positive_kernel_equals_plain_version(cuda, n):
    from cmacionize_torch.kernels import probe_cohort as pc

    cnt = torch.tensor(np.random.default_rng(n).integers(-3, 4, n).astype(np.int32),
                       device=cuda)
    out = pc.count_positive(cnt)
    assert out.shape == (8, 128) and torch.equal(out, pc.count_positive_reference(cnt))


@pytest.mark.parametrize("rows", [8, 4096])
def test_lane_gather_loop_kernel_equals_plain_version(cuda, rows):
    from cmacionize_torch.kernels import probe_cohort as pc

    rng = np.random.default_rng(rows)
    tab = torch.tensor(rng.normal(size=(rows, 128)).astype(np.float32), device=cuda)
    idx = torch.tensor(rng.integers(-200, 300, (rows, 128)).astype(np.int32), device=cuda)
    assert torch.equal(pc.lane_gather_loop(tab, idx), pc.lane_gather_loop_reference(tab, idx))


@pytest.mark.parametrize("items", [8, 7808, 7811])
def test_stream_rows_kernel_equals_plain_version_and_repeats_itself(cuda, items):
    from cmacionize_torch.kernels import probe_cohort as pc

    pk = torch.tensor(np.random.default_rng(items).standard_normal((items, 16, 128),
                                                                    np.float32), device=cuda)
    out, s = pc.stream_rows(pk)
    out_r, s_r = pc.stream_rows_reference(pk)
    assert torch.equal(out, out_r) and s.shape == (1, 1)
    magnitude = float((pk[:, 0].double() * pk[:, 1].double()).abs().sum())
    assert abs(float(s) - float(s_r)) <= 1e-6 * magnitude
    out2, s2 = pc.stream_rows(pk)
    assert torch.equal(out2, out) and torch.equal(s2.view(torch.int32), s.view(torch.int32))


def test_probe_deposit_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from cmacionize_torch.kernels import probe_cohort as pc
    from cmacionize_torch.kernels import probe_deposit as pd

    dep = torch.ones((8, 128), device=cuda)
    lidx = torch.zeros((8, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="lidx must be"):
        pd.shifted_histogram(dep, lidx.long(), 10)
    with pytest.raises(ValueError, match="one shape"):
        pd.shifted_histogram(dep, lidx[:4], 10)
    with pytest.raises(ValueError, match="nstep"):
        pd.shifted_histogram(dep, lidx, -1)
    with pytest.raises(ValueError, match="contiguous"):
        pd.dda_math(dep.t(), dep.t(), 10)
    with pytest.raises(ValueError, match="b must be"):
        pd.dda_incremental(dep, dep.double(), 10)
    with pytest.raises(ValueError, match="empty"):
        pd.fill_first(dep[:0])
    with pytest.raises(ValueError, match="cnt must be"):
        pc.count_positive(lidx)
    with pytest.raises(ValueError, match=r"\[R, 128\]"):
        pc.lane_gather_loop(dep[:, :64].contiguous(), lidx[:, :64].contiguous())
    with pytest.raises(ValueError, match="16-byte"):
        pc.stream_rows(torch.ones(2 * 16 * 128 + 1, device=cuda)[1:].view(2, 16, 128))
    with pytest.raises(ValueError, match=r"\[N, 16, 128\]"):
        pc.stream_rows(torch.ones((2, 8, 128), device=cuda))


def test_probe_deposit_and_cohort_tools_on_card(cuda, capsys):
    from cmacionize_torch.tools import probe_cohort_kernel, probe_deposit, probe_deposit2

    kernels.LAUNCHES.clear()
    for tool in (probe_deposit, probe_deposit2, probe_cohort_kernel):
        times = tool.main(device=cuda)
        assert list(times) == [name for name, *_ in tool.BODIES]
    assert all(kernels.LAUNCHES[k] > 0 for k in (
        "shifted_histogram", "dda_math", "dda_incremental", "fill_first", "count_positive",
        "lane_gather_loop", "stream_rows"))
    assert capsys.readouterr().out.count("(CUDA events)") == 16


# -- K14c and K12r on kernels/launch.py: the bulk-async stream and the vector rows --------------


def _stream_input(items, seed, cuda):
    return torch.tensor(np.random.default_rng(seed).standard_normal((items, 16, 128), np.float32),
                        device=cuda)


def _assert_stream_rows_equal(pk, out, s):
    from cmacionize_torch.kernels import probe_cohort as pc

    out_r, s_r = pc.stream_rows_reference(pk)
    assert torch.equal(out, out_r) and s.shape == (1, 1)
    magnitude = float((pk[:, 0].double() * pk[:, 1].double()).abs().sum())
    assert abs(float(s) - float(s_r)) <= 1e-6 * magnitude


# chunks of four items, at most 132 blocks, six fixed chunks a block before the
# counter: 1-7 items, a chunk boundary at 4 and a partial last chunk; 528 and
# 529, one chunk a block on all 132 blocks, then one block with a second;
# 3168 and 3169, the fixed chunks all taken, then the counter's first chunk;
# 15616, twice the tool's items
@pytest.mark.parametrize("items", [1, 2, 3, 7, 528, 529, 3168, 3169, 15616])
def test_stream_rows_bulk_copies_equal_plain_version_in_one_launch(cuda, items):
    from cmacionize_torch.kernels import probe_cohort as pc

    pk = _stream_input(items, items + 13, cuda)
    kernels.LAUNCHES.clear()
    out, s = pc.stream_rows(pk)
    assert kernels.LAUNCHES["stream_rows"] == 1  # once per call
    _assert_stream_rows_equal(pk, out, s)


def test_stream_rows_on_the_tools_input(cuda):
    from cmacionize_torch.kernels import probe_cohort as pc
    from cmacionize_torch.tools import probe_cohort_kernel as tool

    (pk,) = tool.c_inputs(cuda)
    out, s = pc.stream_rows(pk)
    _assert_stream_rows_equal(pk, out, s)
    assert float(s) == float(pk[:, 0].double().mul(pk[:, 1].double()).sum())  # exact on ones


def test_stream_rows_repeats_itself_after_another_size(cuda):
    # the ticket is zeroed by each launch: a call of another size in between
    # leaves the next call's bits as they were
    from cmacionize_torch.kernels import probe_cohort as pc

    pk, small = _stream_input(7808, 1, cuda), _stream_input(3, 2, cuda)
    out, s = pc.stream_rows(pk)
    out_small, s_small = pc.stream_rows(small)
    out2, s2 = pc.stream_rows(pk)
    assert torch.equal(out2, out) and torch.equal(s2.view(torch.int32), s.view(torch.int32))
    _assert_stream_rows_equal(small, out_small, s_small)


def test_stream_rows_on_a_side_stream(cuda):
    from cmacionize_torch.kernels import probe_cohort as pc

    pk = _stream_input(7808, 3, cuda)
    ref, s_ref = pc.stream_rows(pk)
    ref, s_ref = ref.cpu(), s_ref.cpu()
    big = torch.randn((4096, 4096), device=cuda)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    for _ in range(8):  # keeps the default stream busy
        big = big @ big / 64.0
    with torch.cuda.stream(side):
        out, s = pc.stream_rows(pk)
        host, s_host = out.cpu(), s.cpu()  # torch ops on the side stream, its only synchronise
    assert torch.equal(host, ref) and torch.equal(s_host.view(torch.int32), s_ref.view(torch.int32))


def test_stream_rows_in_a_cuda_graph(cuda):
    from cmacionize_torch.kernels import probe_cohort as pc

    pk = _stream_input(7808, 4, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pc.stream_rows(pk)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    kernels.LAUNCHES.clear()
    with torch.cuda.graph(graph):
        out, s = pc.stream_rows(pk)
    assert kernels.LAUNCHES["stream_rows"] == 1
    for seed in (5, 6):  # new inputs in the captured tensor, then a replay
        pk.copy_(_stream_input(7808, seed, cuda))
        graph.replay()
        torch.cuda.synchronize()
        _assert_stream_rows_equal(pk, out, s)
        _, s_eager = pc.stream_rows(pk)
        assert torch.equal(s.view(torch.int32), s_eager.view(torch.int32))
    assert kernels.LAUNCHES["stream_rows"] == 3  # a replay calls no wrapper


def _row_gather_case(case, cuda):
    """(tab, idx) of K12r: the probe's, 2^20 lookups, widths on the vector
    path (multiples of 4, rows that end inside a warp's run) and on the
    scalar one (a width not a multiple of 4, a table 4 bytes past 16-byte
    alignment)."""
    from cmacionize_torch.tools import probe_pallas_gather as tool

    if case == "probe":
        return tool.b_row_gather(cuda)[1]
    rows, width, n, offset = {"2^20": (4096, 64, 2**20, 0), "width 4": (1000, 4, 8195, 0),
                              "width 12": (1000, 12, 4099, 0), "width 132": (512, 132, 777, 0),
                              "width 63": (4096, 63, 8192, 0), "width 1": (300, 1, 1001, 0),
                              "unaligned": (4096, 64, 8192, 1)}[case]
    rng = np.random.default_rng(rows + width + n)
    flat = torch.tensor(rng.normal(size=rows * width + offset).astype(np.float32), device=cuda)
    tab = flat[offset:].view(rows, width)
    assert (tab.data_ptr() % 16 == 0) == (offset == 0)
    return tab, _probe_lookups(rng, n, rows, (n,), cuda)


ROW_GATHER_CASES = ("probe", "2^20", "width 4", "width 12", "width 132", "width 63", "width 1",
                    "unaligned")


@pytest.mark.parametrize("case", ROW_GATHER_CASES)
def test_row_gather_launch_path_equals_indexing(cuda, case):
    from cmacionize_torch.kernels import probe_gather as pg

    tab, idx = _row_gather_case(case, cuda)
    kernels.LAUNCHES.clear()
    out = pg.row_gather(tab, idx)
    assert kernels.LAUNCHES["row_gather"] == 1  # once per call
    assert out.shape == (idx.shape[0], tab.shape[1]) and out.is_contiguous()
    assert torch.equal(out, tab[idx.long()]) and torch.equal(out, pg.row_gather_reference(tab, idx))


def test_row_gather_launch_path_on_a_side_stream(cuda):
    from cmacionize_torch.kernels import probe_gather as pg

    tab, idx = _row_gather_case("2^20", cuda)
    ref = tab[idx.long()].cpu()
    big = torch.randn((4096, 4096), device=cuda)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    for _ in range(8):
        big = big @ big / 64.0
    with torch.cuda.stream(side):
        host = pg.row_gather(tab, idx).cpu()
    assert torch.equal(host, ref)


def test_row_gather_launch_path_in_a_cuda_graph(cuda):
    from cmacionize_torch.kernels import probe_gather as pg

    tab, idx = _row_gather_case("probe", cuda)
    rng = np.random.default_rng(11)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pg.row_gather(tab, idx)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    kernels.LAUNCHES.clear()
    with torch.cuda.graph(graph):
        out = pg.row_gather(tab, idx)
    assert kernels.LAUNCHES["row_gather"] == 1
    for _ in range(2):
        tab.copy_(torch.tensor(rng.normal(size=tuple(tab.shape)).astype(np.float32)))
        idx.copy_(_probe_lookups(rng, idx.numel(), tab.shape[0], idx.shape, cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, tab[idx.long()])
    assert kernels.LAUNCHES["row_gather"] == 1


def test_row_gather_and_stream_rows_reject_what_the_kernels_do_not_take(cuda):
    from cmacionize_torch.kernels import probe_cohort as pc
    from cmacionize_torch.kernels import probe_gather as pg

    tab, idx = _row_gather_case("probe", cuda)
    kernels.LAUNCHES.clear()
    for args, message in (((tab.double(), idx), "tab must be"), ((tab, idx.long()), "idx must be"),
                          ((tab, idx.cpu()), "idx must be"),
                          ((tab.t().contiguous().t(), idx), "tab must be contiguous"),
                          ((tab, idx[::2]), "idx must be contiguous")):
        with pytest.raises(ValueError, match=f"row_gather: {message}"):
            pg.row_gather(*args)
    with pytest.raises(ValueError, match="sizes must fit int32"):
        pg.row_gather(tab, torch.zeros(2**25, dtype=torch.int32, device=cuda))
    pk = torch.ones((4, 16, 128), device=cuda)
    for arg, message in ((pk.double(), "pk must be a 3D"), (pk.reshape(4, 2048), "pk must be a 3D"),
                         (pk.transpose(1, 2).contiguous().transpose(1, 2), "pk must be contiguous"),
                         (pk[:, :8].contiguous(), r"pk must be \[N, 16, 128\]")):
        with pytest.raises(ValueError, match=f"stream_rows: {message}"):
            pc.stream_rows(arg)
    assert kernels.LAUNCHES["row_gather"] == kernels.LAUNCHES["stream_rows"] == 0
    with pytest.raises(TypeError):  # typed once: four pointers, one int and the stream
        pc._STREAM_ROWS(pk.get_device(), 1, 2)


# -- K11r and K13f on kernels/launch.py --------------------------------------------------------------


def _unaligned_copy(t):
    """A contiguous copy of ``t`` on its device, 4 bytes past a 16-byte
    boundary (a view with a storage offset)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


GATHER2D_CASES = {  # the index blocks' shape; which views start off 16-byte alignment
    "2^20": ((2**20,), ""), "2D": ((64, 128), ""), "3D": ((4, 16, 128), ""),
    "4D": ((2, 3, 5, 7), ""), "2^20 - 3": ((2**20 - 3,), ""), "1026": ((1026,), ""),
    "7": ((7,), ""), "one": ((1,), ""), "unaligned rows": ((8192,), "rows"),
    "unaligned lanes": ((64, 128), "lanes"), "unaligned table": ((8192,), "table"),
}


def _gather2d_case(case, cuda):
    """(tbl2, rows, lanes) of K11r: the flat 2D probe's, or seeded lookups
    into [2048, 128] (its first and last entries among them) as index blocks
    of GATHER2D_CASES' shape, with the named view off 16-byte
    alignment."""
    from cmacionize_torch.tools import probe_pallas_gather as tool

    if case == "probe":
        return tool.b_flat_gather_2d(cuda)[1]
    shape, unaligned = GATHER2D_CASES[case]
    n = int(np.prod(shape))
    rng = np.random.default_rng(n + len(case))
    flat = _probe_lookups(rng, n, 2048 * 128, shape, cuda)
    tab = torch.tensor(rng.normal(size=(2048, 128)).astype(np.float32), device=cuda)
    rows, lanes = flat // 128, flat % 128
    if unaligned == "rows":
        rows = _unaligned_copy(rows)
    elif unaligned == "lanes":
        lanes = _unaligned_copy(lanes)
    elif unaligned == "table":
        tab = _unaligned_copy(tab)
    return tab, rows, lanes


@pytest.mark.parametrize("case", ["probe", *GATHER2D_CASES])
def test_gather2d_launch_path_equals_indexing(cuda, case):
    from cmacionize_torch.kernels import gather

    tab, rows, lanes = _gather2d_case(case, cuda)
    kernels.LAUNCHES.clear()
    out = gather.gather2d(tab, rows, lanes)
    assert kernels.LAUNCHES["gather2d"] == 1  # once per call
    assert out.shape == rows.shape and out.dtype == torch.float32 and out.is_contiguous()
    assert torch.equal(out.view(torch.int32), tab[rows.long(), lanes.long()].view(torch.int32))
    assert torch.equal(out, gather.gather2d_reference(tab, rows, lanes))


def test_gather2d_launch_path_on_a_side_stream(cuda):
    from cmacionize_torch.kernels import gather

    tab, rows, lanes = _gather2d_case("2^20 - 3", cuda)
    ref = tab[rows.long(), lanes.long()].cpu()
    big = torch.randn((4096, 4096), device=cuda)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    for _ in range(8):
        big = big @ big / 64.0
    with torch.cuda.stream(side):
        host = gather.gather2d(tab, rows, lanes).cpu()
    assert torch.equal(host, ref)


@pytest.mark.parametrize("case", ["probe", "unaligned rows"])
def test_gather2d_launch_path_in_a_cuda_graph(cuda, case):
    from cmacionize_torch.kernels import gather

    tab, rows, lanes = _gather2d_case(case, cuda)
    rng = np.random.default_rng(13)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gather.gather2d(tab, rows, lanes)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    kernels.LAUNCHES.clear()
    with torch.cuda.graph(graph):
        out = gather.gather2d(tab, rows, lanes)
    assert kernels.LAUNCHES["gather2d"] == 1
    for _ in range(2):  # new inputs in the captured tensors, then a replay
        flat = _probe_lookups(rng, rows.numel(), 2048 * 128, rows.shape, cuda)
        tab.copy_(torch.tensor(rng.normal(size=tuple(tab.shape)).astype(np.float32)))
        rows.copy_(flat // 128)
        lanes.copy_(flat % 128)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, tab[rows.long(), lanes.long()])
    assert kernels.LAUNCHES["gather2d"] == 1  # a replay calls no wrapper


@pytest.mark.parametrize("n", [0, 1, 8192, 2**20 + 3])
def test_gather_launch_path_equals_indexing(cuda, n):
    # K11 on kernels/launch.py: one launch a call, tbl[idx]'s bits with the
    # table's first and last entries among the indices, an empty index too
    from cmacionize_torch.kernels import gather

    rng = np.random.default_rng(n + 5)
    tbl = torch.tensor(rng.normal(size=64**3).astype(np.float32), device=cuda)
    idx = rng.integers(0, 64**3, n).astype(np.int32)
    if n:
        idx[0], idx[-1] = 64**3 - 1, 0
    idx = torch.tensor(idx, device=cuda)
    kernels.LAUNCHES.clear()
    out = gather.gather(tbl, idx)
    assert kernels.LAUNCHES["gather"] == 1
    assert out.shape == (n,) and out.dtype == torch.float32 and out.is_contiguous()
    assert torch.equal(out.view(torch.int32), tbl[idx.long()].view(torch.int32))


def test_gather_launch_path_on_a_side_stream_and_in_a_cuda_graph(cuda):
    from cmacionize_torch.kernels import gather

    rng = np.random.default_rng(19)
    tbl = torch.tensor(rng.normal(size=64**3).astype(np.float32), device=cuda)
    idx = torch.tensor(rng.integers(0, 64**3, 2**20).astype(np.int32), device=cuda)
    ref = tbl[idx.long()].cpu()
    big = torch.randn((4096, 4096), device=cuda)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    for _ in range(8):
        big = big @ big / 64.0
    with torch.cuda.stream(side):
        host = gather.gather(tbl, idx).cpu()
    assert torch.equal(host, ref)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gather.gather(tbl, idx)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    kernels.LAUNCHES.clear()
    with torch.cuda.graph(graph):
        out = gather.gather(tbl, idx)
    for _ in range(2):  # new inputs in the captured tensors, then a replay
        tbl.copy_(torch.tensor(rng.normal(size=64**3).astype(np.float32)))
        idx.copy_(torch.tensor(rng.integers(0, 64**3, 2**20).astype(np.int32)))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, tbl[idx.long()])
    assert kernels.LAUNCHES["gather"] == 1  # a replay calls no wrapper


def test_gather_refuses_what_the_kernel_does_not_take(cuda):
    from cmacionize_torch.kernels import gather

    tbl = torch.zeros(64**3, device=cuda)
    idx = torch.zeros(1000, dtype=torch.int32, device=cuda)
    kernels.LAUNCHES.clear()
    for args, message in (((tbl.double(), idx), "tbl must be a 1D"),
                          ((tbl.reshape(64, -1), idx), "tbl must be a 1D"),
                          ((tbl, idx.long()), "idx must be a 1D torch.int32"),
                          ((tbl, idx.reshape(10, -1)), "idx must be a 1D torch.int32"),
                          ((tbl, idx.cpu()), "idx must be a 1D torch.int32 tensor on cuda"),
                          ((tbl[::2], idx), "tbl must be contiguous"),
                          ((tbl, idx[::2]), "idx must be contiguous")):
        with pytest.raises(ValueError, match=f"gather: {message}"):
            gather.gather(*args)
    huge = torch.empty(2**31, dtype=torch.int32, device=cuda)  # never read
    with pytest.raises(ValueError, match="gather: sizes must fit int32"):
        gather.gather(tbl, huge)
    assert kernels.LAUNCHES["gather"] == 0
    with pytest.raises(TypeError):  # typed once: three pointers, one int and the stream
        gather._GATHER(tbl.get_device(), 1, 2)


def test_fill_first_launch_path(cuda):
    # one launch a call, the first value's bits (-0.0 among them), on a side
    # stream and in a CUDA graph whose replays read new inputs
    from cmacionize_torch.kernels import probe_deposit as pd

    rng = np.random.default_rng(17)
    dep = torch.tensor(rng.normal(size=(8, 128)).astype(np.float32), device=cuda)
    for first in (2.5, -0.0, float("nan")):
        dep[0, 0] = first
        kernels.LAUNCHES.clear()
        out = pd.fill_first(dep)
        assert kernels.LAUNCHES["fill_first"] == 1
        assert out.shape == (1, 128) and out.is_contiguous()
        assert torch.equal(out.view(torch.int32), pd.fill_first_reference(dep).view(torch.int32))
    big = torch.randn((4096, 4096), device=cuda)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    for _ in range(8):
        big = big @ big / 64.0
    with torch.cuda.stream(side):
        host = pd.fill_first(dep[1:]).cpu()
    assert torch.equal(host.view(torch.int32), dep[1:2, :1].cpu().view(torch.int32).expand(1, 128))
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pd.fill_first(dep)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    kernels.LAUNCHES.clear()
    with torch.cuda.graph(graph):
        out = pd.fill_first(dep)
    for _ in range(2):
        dep.copy_(torch.tensor(rng.normal(size=(8, 128)).astype(np.float32)))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), pd.fill_first_reference(dep).view(torch.int32))
    assert kernels.LAUNCHES["fill_first"] == 1


def test_gather2d_and_fill_first_reject_what_the_kernels_do_not_take(cuda):
    from cmacionize_torch.kernels import gather
    from cmacionize_torch.kernels import probe_deposit as pd

    tab, rows, lanes = _gather2d_case("probe", cuda)
    kernels.LAUNCHES.clear()
    for args, message in (((tab.double(), rows, lanes), "tbl2 must be a 2D"),
                          ((tab.reshape(-1), rows, lanes), "tbl2 must be a 2D"),
                          ((tab, rows.long(), lanes), "rows must be a torch.int32"),
                          ((tab, rows, lanes.long()), "lanes must be a torch.int32"),
                          ((tab, rows, lanes.cpu()), "lanes must be a torch.int32 tensor on cuda"),
                          ((tab, rows.cpu(), lanes), "rows must be a torch.int32 tensor on cuda"),
                          ((tab.t().contiguous().t(), rows, lanes), "tbl2 must be contiguous"),
                          ((tab, rows.t().contiguous().t(), lanes), "rows must be contiguous"),
                          ((tab, rows, lanes.t().contiguous().t()), "lanes must be contiguous"),
                          ((tab, rows, lanes.reshape(-1)), "rows and lanes must have one shape")):
        with pytest.raises(ValueError, match=f"gather2d: {message}"):
            gather.gather2d(*args)
    huge = torch.empty((2**24, 128), device=cuda)  # 2^31 elements, never read
    with pytest.raises(ValueError, match="gather2d: sizes must fit int32"):
        gather.gather2d(huge, rows, lanes)
    dep = torch.ones((8, 128), device=cuda)
    for arg, message in ((dep.double(), "dep must be a torch.float32"),
                         (dep.t(), "dep must be contiguous"), (dep[:0], "dep must not be empty")):
        with pytest.raises(ValueError, match=f"fill_first: {message}"):
            pd.fill_first(arg)
    assert kernels.LAUNCHES["gather2d"] == kernels.LAUNCHES["fill_first"] == 0
    with pytest.raises(TypeError):  # typed once: four pointers, two ints and the stream
        gather._GATHER2D(tab.get_device(), 1, 2)
    with pytest.raises(TypeError):  # two pointers and the stream, not the stream alone
        pd._FILL_FIRST(dep.get_device())


# -- K1 and K6: K1's shared-memory window, K6's packed face rows and run-summed deposits ---------


def _same_packet_states(out_k, out_r, fields):
    for f in fields:
        a, b = getattr(out_k, f), getattr(out_r, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


def _rel_l1_against_f64(tally, tally_64):
    return float((tally.double() - tally_64).abs().sum() / tally_64.abs().sum())


K1_STATE = ("px", "py", "pz", "cx", "cy", "cz", "tau_left", "active", "absorbed")
K6_STATE = ("pos", "cell", "tau_left", "active", "absorbed")


def _k1_against_plain(chi, pk, shape, periodic=(False, False, False), max_steps=0):
    """K1 through the public march (one launch, none for no packets) against
    the plain version: identical states; the tally within 1e-4 of the plain
    march summed in f64."""
    march = dict(shape=shape, periodic=periodic, max_steps=max_steps)
    before = kernels.LAUNCHES["trace_packets"]
    tally_k, out_k = traversal.trace_packets(chi, pk, torch.zeros_like(chi), **march)
    assert kernels.LAUNCHES["trace_packets"] == before + (pk.size > 0)
    tally_r, out_r = traversal.trace_packets_reference(chi, pk, torch.zeros_like(chi), **march)
    tally_64 = traversal.trace_packets_reference(chi, pk, torch.zeros_like(chi).double(),
                                                 **march)[0]
    torch.cuda.synchronize()
    _same_packet_states(out_k, out_r, K1_STATE)
    if float(tally_64.abs().sum()) > 0.0:
        assert _rel_l1_against_f64(tally_k, tally_64) <= 1e-4
    else:
        assert float(tally_k.abs().sum()) == 0.0
    return out_k


def _one_cell_packets(shape, n, seed, cuda, sort=False):
    """n isotropic packets, all from the centre of one cell (the collision
    case of a point source), in emission order or sorted by direction."""
    from cmacionize_torch.kernels.trace_octree import direction_order

    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda)  # noqa: E731
    centre = np.asarray(shape, np.float64) // 2 + 0.5
    pk = traversal.make_packets(t(np.tile(centre, (n, 1))), t(d), t(-np.log1p(-rng.random(n))),
                                t(rng.uniform(0.5, 1.5, n)), shape)
    if sort:
        order = direction_order(pk.dx, pk.dy, pk.dz).long()
        pk = type(pk)(*(f[order] for f in pk))
    return pk


@pytest.mark.parametrize("sort", [False, True])
def test_k1_on_packets_from_one_cell(cuda, sort):
    shape = (64, 64, 64)
    chi, _ = _inputs(3, shape, 1, 30.0, cuda)
    pk = _one_cell_packets(shape, 300_000, 5, cuda, sort)
    out = _k1_against_plain(chi, pk, shape)
    assert 0 < int(out.absorbed.sum()) < pk.size


@pytest.mark.parametrize("inside", [0, 1, 128, 256])
def test_k1_on_blocks_whose_packets_start_in_and_out_of_the_window(cuda, inside):
    """Each block of 256 packets has its first ``inside`` packets in the grid's
    centre cell and the rest at seeded places with x < 20 cells, outside the
    16-cell shared window around that cell (with none inside, the window
    sits around a scattered packet); a short last block."""
    shape = (64, 64, 64)
    chi, _ = _inputs(8, shape, 1, 30.0, cuda)
    n = 4 * 256 + 100
    rng = np.random.default_rng(9)
    position = rng.uniform((0.0, 0.0, 0.0), (20.0, 64.0, 64.0), (n, 3))
    in_centre = np.arange(n) % 256 < inside
    position[in_centre] = 32.5
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda)  # noqa: E731
    pk = traversal.make_packets(t(position), t(d), t(-np.log1p(-rng.random(n))),
                                t(rng.uniform(0.5, 1.5, n)), shape)
    _k1_against_plain(chi, pk, shape)


@pytest.mark.parametrize("n", [0, 1, 5, 31, 32, 33, 1000 + 7])
def test_k1_on_few_packets_and_ragged_warps(cuda, n):
    shape = (16, 16, 16)
    chi, pk = _inputs(4, shape, max(n, 1), 3.0, cuda)
    pk = type(pk)(*(f[:n] for f in pk))
    _k1_against_plain(chi, pk, shape)


def test_k1_on_many_waves_of_blocks(cuda):
    from cmacionize_torch.kernels.trace_packets import occupancy

    shape = (64, 64, 64)
    chi, pk = _inputs(6, shape, 1 << 20, 300.0, cuda)
    lanes = occupancy(cuda)
    assert pk.size > 3 * lanes["blocks_per_sm"] * lanes["sms"] * 256
    _k1_against_plain(chi, pk, shape)


def test_k1_leaves_inactive_packets_as_handed_in(cuda):
    shape = (24, 24, 24)
    chi, pk = _inputs(7, shape, 30_000, 30.0, cuda)
    frozen = torch.arange(pk.size, device=cuda) % 3 == 1
    pk = pk._replace(active=~frozen, absorbed=frozen & (torch.arange(pk.size, device=cuda) % 2 == 0))
    out = _k1_against_plain(chi, pk, shape)
    for f in K1_STATE:
        assert torch.equal(getattr(out, f)[frozen], getattr(pk, f)[frozen]), f


@pytest.mark.parametrize("max_steps", [1, 2, 5])
@pytest.mark.parametrize("periodic", [(False, False, False), (True, True, True), (True, False, True)])
def test_k1_under_a_step_cap_and_periodic_axes(cuda, max_steps, periodic):
    shape = (16, 16, 16)
    chi, pk = _inputs(8, shape, 20_000, 0.3, cuda)
    out = _k1_against_plain(chi, pk, shape, periodic, max_steps)
    assert bool(out.active.any())  # packets left at the cap


@pytest.mark.parametrize("periodic", [(True, True, True), (True, False, True)])
def test_k1_from_one_cell_on_periodic_axes(cuda, periodic):
    shape = (24, 16, 20)
    chi, _ = _inputs(9, shape, 1, 0.3, cuda)
    _k1_against_plain(chi, _one_cell_packets(shape, 50_000, 10, cuda, sort=True), shape, periodic)


def test_k1_wrapper_refuses_on_the_launch_path(cuda):
    from cmacionize_torch.kernels import trace_packets as k1

    shape = (8, 8, 8)
    chi, pk = _inputs(1, shape, 64, 1.0, cuda)
    fields = pk._asdict()
    march = dict(shape=shape, periodic=(False,) * 3, max_steps=96)
    kernels.LAUNCHES.clear()
    for args, message in (
            ((chi.double(), torch.zeros_like(chi), fields), "opacity must be"),
            ((chi, torch.zeros(7, device=cuda), fields), "tally must be"),
            ((chi, torch.zeros_like(chi), dict(fields, cx=pk.cx.long())), "cx must be"),
            ((chi, torch.zeros_like(chi), dict(fields, px=pk.px.cpu())), "px must be"),
            ((chi, torch.zeros_like(chi), dict(fields, px=torch.stack([pk.px, pk.py], 1)[:, 0])),
             "px must be contiguous"),
            ((chi.cpu(), torch.zeros(512), {k: v.cpu() for k, v in fields.items()}),
             "needs CUDA tensors")):
        with pytest.raises(ValueError, match=message):
            k1.trace_packets_cuda(*args, **march)
    with pytest.raises(ValueError, match="sizes must fit int32"):
        k1.trace_packets_cuda(chi, torch.zeros_like(chi), fields, shape=shape,
                              periodic=(False,) * 3, max_steps=-1)
    assert kernels.LAUNCHES["trace_packets"] == 0
    with pytest.raises(TypeError):  # typed once: 15 pointers, 6 ints and the stream
        k1._TRACE_PACKETS(chi.get_device(), 1, 2)


@functools.lru_cache(maxsize=None)
def _cached_voronoi_grid(seed, n, periodic):
    return _voronoi_grid(seed, n, periodic)


def _k6_against_plain(grid, chi, pk, max_steps=0):
    """K6 through the public march (one launch, none for no packets) against
    the plain version: identical states; the tally within 1e-4 of the plain
    march summed in f64."""
    from cmacionize_torch.models import voronoi

    tables = voronoi.voronoi_tables(grid, chi.device)
    C = grid.n_cells
    march = dict(eps=voronoi.march_eps(C), max_steps=voronoi.default_max_steps(C, max_steps))
    before = kernels.LAUNCHES["trace_voronoi"]
    tally_k, out_k = voronoi.trace_packets_voronoi(grid, chi, pk, max_steps=max_steps,
                                                   tables=tables)
    assert kernels.LAUNCHES["trace_voronoi"] == before + (pk.size > 0)
    chi_u = chi * grid.scale
    tally_r, out_r = voronoi.trace_packets_voronoi_reference(
        tables, chi_u, pk, torch.zeros(C, device=chi.device), **march)
    tally_64 = voronoi.trace_packets_voronoi_reference(
        tables, chi_u, pk, torch.zeros(C, dtype=torch.float64, device=chi.device), **march)[0]
    torch.cuda.synchronize()
    _same_packet_states(out_k, out_r, K6_STATE)
    if float(tally_64.abs().sum()) > 0.0:
        assert _rel_l1_against_f64(tally_k / grid.scale, tally_64) <= 1e-4
    else:
        assert float(tally_k.abs().sum()) == 0.0
    return out_k


def _k6_one_cell_packets(grid, n, seed, cuda, sort=False):
    from cmacionize_torch.kernels.trace_octree import direction_order
    from cmacionize_torch.models import voronoi

    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pk = voronoi.make_voronoi_packets(grid, np.full((n, 3), 0.5), d, -np.log1p(-rng.random(n)),
                                      rng.uniform(0.5, 1.5, n), device=cuda)
    if sort:
        order = direction_order(*pk.dirn.unbind(1)).long()
        pk = type(pk)(*(f[order] for f in pk))
    return pk


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("periodic", [(False, False, False), (True, True, True)])
def test_k6_on_packets_from_one_cell(cuda, periodic, sort):
    grid = _cached_voronoi_grid(0, 3000, periodic)
    chi, _ = _voronoi_packets(grid, 1, 1, cuda)
    pk = _k6_one_cell_packets(grid, 200_000, 2, cuda, sort)
    assert int(torch.unique(pk.cell).numel()) == 1
    out = _k6_against_plain(grid, chi, pk)
    assert int(out.absorbed.sum()) > 0


@pytest.mark.parametrize("n", [0, 1, 5, 31, 33, 1000 + 7])
def test_k6_on_few_packets_and_ragged_warps(cuda, n):
    grid = _cached_voronoi_grid(0, 3000, (False, False, False))
    chi, pk = _voronoi_packets(grid, 3, max(n, 1), cuda)
    _k6_against_plain(grid, chi, type(pk)(*(f[:n] for f in pk)))


def test_k6_on_many_waves_of_blocks(cuda):
    from cmacionize_torch.kernels.trace_voronoi import occupancy

    grid = _cached_voronoi_grid(0, 3000, (True, True, True))
    chi, pk = _voronoi_packets(grid, 4, 1 << 20, cuda)
    lanes = occupancy(cuda)
    assert pk.size > 3 * lanes["blocks_per_sm"] * lanes["sms"] * 256
    _k6_against_plain(grid, chi, pk)


def test_k6_leaves_inactive_packets_as_handed_in(cuda):
    grid = _cached_voronoi_grid(0, 3000, (False, False, False))
    chi, pk = _voronoi_packets(grid, 5, 30_000, cuda)
    frozen = torch.arange(pk.size, device=cuda) % 3 == 1
    pk = pk._replace(active=~frozen, absorbed=frozen & (torch.arange(pk.size, device=cuda) % 2 == 0))
    out = _k6_against_plain(grid, chi, pk)
    for f in K6_STATE:
        assert torch.equal(getattr(out, f)[frozen], getattr(pk, f)[frozen]), f


@pytest.mark.parametrize("max_steps", [1, 2, 5])
@pytest.mark.parametrize("periodic", [(False, False, False), (True, True, True)])
def test_k6_under_a_step_cap(cuda, max_steps, periodic):
    grid = _cached_voronoi_grid(0, 3000, periodic)
    chi, pk = _voronoi_packets(grid, 6, 20_000, cuda)
    out = _k6_against_plain(grid, chi, pk, max_steps)
    assert bool(out.active.any())


def test_k6_wrapper_refuses_on_the_launch_path(cuda):
    from cmacionize_torch.kernels import trace_voronoi as k6
    from cmacionize_torch.models import voronoi

    grid = _cached_voronoi_grid(0, 3000, (False, False, False))
    chi, pk = _voronoi_packets(grid, 7, 64, cuda)
    tables = voronoi.voronoi_tables(grid, cuda)
    C = grid.n_cells
    chi_u, fields = chi * grid.scale, pk._asdict()
    march = dict(eps=voronoi.march_eps(C), max_steps=40)
    K = grid.max_faces
    unaligned = torch.empty(C * K * 4 + 1, device=cuda)[1:].view(C, K, 4)
    kernels.LAUNCHES.clear()
    for tbl, chi_, tally, flds, message in (
            (tables, chi_u.double(), torch.zeros(C, device=cuda), fields, "chi must be"),
            (tables, chi_u, torch.zeros(C - 1, device=cuda), fields, "tally must be"),
            (tables._replace(faces=tables.faces[:, :-1]), chi_u, torch.zeros(C, device=cuda),
             fields, "faces must be"),
            (tables._replace(face_count=tables.face_count.long()), chi_u,
             torch.zeros(C, device=cuda), fields, "face_count must be"),
            (tables._replace(faces=unaligned), chi_u, torch.zeros(C, device=cuda), fields,
             "16-byte aligned"),
            (tables, chi_u, torch.zeros(C, device=cuda), dict(fields, cell=pk.cell.long()),
             "cell must be"),
            (tables, chi_u, torch.zeros(C, device=cuda),
             dict(fields, pos=pk.pos.t().contiguous().t()), "pos must be contiguous")):
        with pytest.raises(ValueError, match=message):
            k6.trace_voronoi_cuda(tbl, chi_, tally, flds, **march)
    with pytest.raises(ValueError, match="max_steps"):
        k6.trace_voronoi_cuda(tables, chi_u, torch.zeros(C, device=cuda), fields, eps=1e-5,
                              max_steps=-1)
    assert kernels.LAUNCHES["trace_voronoi"] == 0
    with pytest.raises(TypeError):  # typed once: 13 pointers, 4 ints, a float and the stream
        k6._TRACE_VORONOI(chi.get_device(), 1, 2)


# ------------------------------------------- K5s redesigned, K9p in one launch


def _spectral_batch(pk, seed, n_bins=8, active=None):
    """A SpectralPacketBatch of ``pk``'s packets with seeded σ_H, σ_He and
    bins (numpy), and ``active`` as its flags where given."""
    rng = np.random.default_rng(seed)
    n, device = pk.size, pk.px.device
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return traversal.SpectralPacketBatch(
        *pk[:11], t(rng.uniform(0.5, 6.3, n)), t(rng.uniform(0.0, 7.0, n)),
        torch.tensor(rng.integers(0, n_bins, n), dtype=torch.int32, device=device),
        pk.active if active is None else active, pk.absorbed)


def _k5s_and_plain(root, children, chi_h, chi_he, pk, march, n_bins=8, max_steps=0):
    """(K5s's and the plain version's tally and batch) on one input; K5s
    through the public march, one launch (none for no packets)."""
    from cmacionize_torch.ops import amr_traversal

    size = n_bins * chi_h.numel()
    before = kernels.LAUNCHES["trace_octree_spectral"]
    tally_k, out_k = amr_traversal.trace_packets_octree_spectral(
        root, children, chi_h, chi_he, pk, torch.zeros(size, device=chi_h.device),
        n_bins=n_bins, max_steps=max_steps, **march)
    assert kernels.LAUNCHES["trace_octree_spectral"] == before + (pk.size > 0)
    tally_r, out_r = amr_traversal.trace_packets_octree_spectral_reference(
        root, children, chi_h, chi_he, pk, torch.zeros(size, device=chi_h.device),
        n_bins=n_bins, max_steps=max_steps, **march)
    torch.cuda.synchronize()
    return (tally_k, out_k), (tally_r, out_r)


def _tally_rel_l1(tally_k, tally_r):
    return float((tally_k - tally_r).abs().sum()) / max(float(tally_r.abs().sum()), 1e-30)


@pytest.mark.parametrize("max_steps", [0, 1, 2])
def test_octree_spectral_kernel_ends_stalled_packets_as_the_plain_version(cuda, max_steps):
    # the stalled packet of the nudge test among seeded ones: K5s ends it at
    # its fixed point, the plain version at the cap, in the same state
    root, children, chi, pk, march = _nudge_grid_inputs(cuda)
    spk = _spectral_batch(pk, 31)
    (tally_k, out_k), (tally_r, out_r) = _k5s_and_plain(
        root, children, chi, 0.2 * chi, spk, march, max_steps=max_steps)
    _assert_same_states(out_k, out_r)
    assert bool(out_k.active[-2]) and float(out_k.px[-2]) == 1.0
    assert _tally_rel_l1(tally_k, tally_r) <= 1e-4
    if max_steps == 0:
        assert 0 < int(out_k.absorbed.sum()) < spk.size


@pytest.mark.parametrize("share", [0.03, 0.5])
def test_octree_spectral_kernel_on_a_generation_mask(cuda, share):
    # a re-emission generation: the whole batch, the re-emitted lanes active
    # (a sparse or a half mask over 2^20 packets, many waves of blocks); the
    # others come back as they were handed in
    grid = _octree_grid()
    root, children, chi_h, chi_he, spk, march = _octree_inputs(
        grid, 12, 1 << 20, cuda, spectral=True)
    rng = np.random.default_rng(13)
    active = torch.tensor(rng.uniform(size=spk.size) < share, device=cuda)
    spk = spk._replace(active=active, absorbed=~active & (torch.arange(spk.size, device=cuda)
                                                          % 2 == 0))
    (tally_k, out_k), (tally_r, out_r) = _k5s_and_plain(root, children, chi_h, chi_he, spk,
                                                        march)
    _assert_same_states(out_k, out_r)
    assert _tally_rel_l1(tally_k, tally_r) <= 1e-4
    frozen = ~active
    for f in ("px", "py", "pz", "tau_left", "active", "absorbed"):
        assert torch.equal(getattr(out_k, f)[frozen], getattr(spk, f)[frozen]), f
    assert 0 < int(out_r.absorbed[active].sum()) <= int(active.sum())


def test_octree_spectral_kernel_with_every_lane_inactive(cuda):
    grid = _octree_grid(max_level=3, zone=0.25)
    root, children, chi_h, chi_he, spk, march = _octree_inputs(
        grid, 14, 5000, cuda, spectral=True)
    spk = spk._replace(active=torch.zeros_like(spk.active))
    (tally_k, out_k), (tally_r, out_r) = _k5s_and_plain(root, children, chi_h, chi_he, spk,
                                                        march)
    _assert_same_states(out_k, out_r)
    for f in ("px", "py", "pz", "tau_left", "active", "absorbed"):
        assert torch.equal(getattr(out_k, f), getattr(spk, f)), f
    assert float(tally_k.abs().sum()) == 0.0


@pytest.mark.parametrize("n", [0, 1, 33])
def test_octree_spectral_kernel_on_few_packets(cuda, n):
    root, children, chi, pk, march = _nudge_grid_inputs(cuda, n=40)
    pk = pk._replace(**{f: v[-n:] if n else v[:0] for f, v in pk._asdict().items()})
    spk = _spectral_batch(pk, 15)
    (tally_k, out_k), (tally_r, out_r) = _k5s_and_plain(root, children, chi, 0.2 * chi, spk,
                                                        march)
    _assert_same_states(out_k, out_r)
    assert float((tally_k - tally_r).abs().sum()) <= 1e-4 * max(float(tally_r.sum()), 1e-30)


def test_octree_spectral_occupancy_and_launch_path(cuda):
    from cmacionize_torch.kernels import trace_octree_spectral as k5s

    layout = k5s.occupancy(cuda)
    assert layout["registers"] > 0 and layout["blocks_per_sm"] >= 1 and layout["sms"] > 0
    assert k5s._LAUNCH.function is not None  # bound by the launches above or now
    with pytest.raises(TypeError):  # typed once: 20 pointers, 7 ints, a float and the stream
        k5s._LAUNCH(cuda.index or 0, 1, 2)


def _partition_inputs(n, members, seed, device):
    rng = np.random.default_rng(seed)
    fields = tuple(torch.tensor(rng.standard_normal(n).astype(np.float32), device=device)
                   for _ in range(8))
    codes = {"none": np.full(n, -1), "all left": np.zeros(n), "all right": np.ones(n),
             "mixed": rng.choice([-1, 0, 1], size=n, p=[0.6, 0.25, 0.15])}[members]
    return fields, torch.tensor(codes.astype(np.int8), device=device)


def _assert_same_partition(out, ref):
    for (f, r, o), (fr, rr, orr) in zip(out, ref, strict=True):
        assert len(f) == len(fr) and all(_same_bits(a, b) for a, b in zip(f, fr))
        assert torch.equal(r, rr) and int(o) == int(orr)


@pytest.mark.parametrize("n", [0, 1, 1000, 1025, 70_001])
@pytest.mark.parametrize("members", ["none", "all left", "all right", "mixed"])
@pytest.mark.parametrize("capacities", ["zero", "past n", "mixed"])
def test_partition_kernel_edge_cases(cuda, n, members, capacities):
    """K9p in one launch against partition_reference: every lane, bit and
    count, with and without the frame shift, and twice for the same bits."""
    from cmacionize_torch.parallel import domain

    fields, bucket = _partition_inputs(n, members, n + len(members), cuda)
    caps = {"zero": (0, 0), "past n": (n + 5, n + 2000),
            "mixed": (n // 3, n + 1)}[capacities]
    for shifts in ((16.0, -16.0), (None, None), (None, 0.1)):
        kernels.LAUNCHES.clear()
        out = domain.partition(fields, bucket, caps, shifts)
        again = domain.partition(fields, bucket, caps, shifts)
        assert kernels.LAUNCHES["partition"] == 2
        ref = domain.partition_reference(fields, bucket, caps, shifts)
        _assert_same_partition(out, ref)
        _assert_same_partition(again, out)


def test_partition_kernel_with_fewer_fields_and_on_a_side_stream(cuda):
    from cmacionize_torch.parallel import domain

    fields, bucket = _partition_inputs(300_000, "mixed", 5, cuda)
    ref = domain.partition_reference(fields[:3], bucket, (90_000, 70_000), (2.0, None))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = domain.partition(fields[:3], bucket, (90_000, 70_000), (2.0, None))
    torch.cuda.current_stream().wait_stream(side)
    _assert_same_partition(out, ref)
    _assert_same_partition(domain.partition(fields[:3], bucket, (90_000, 70_000), (2.0, None)),
                           ref)


def test_partition_kernel_in_a_cuda_graph(cuda):
    # the first call on the capture's stream makes its scratch inside the
    # capture, zeroed by each replay; a later call outside takes its own
    from cmacionize_torch.parallel import domain

    fields, bucket = _partition_inputs(100_000, "mixed", 6, cuda)
    caps, shifts = (30_000, 30_000), (1.0, -1.0)
    ref = domain.partition_reference(fields, bucket, caps, shifts)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        domain.partition(fields, bucket, caps, shifts)  # builds and binds outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = domain.partition(fields, bucket, caps, shifts)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    _assert_same_partition(out, ref)
    _assert_same_partition(domain.partition(fields, bucket, caps, shifts), ref)


def test_partition_kernel_occupancy_and_refusals(cuda):
    from cmacionize_torch.kernels import compact

    layout = compact.occupancy(cuda)
    assert layout["blocks_per_sm"] >= 1 and layout["sms"] > 0
    f = torch.zeros(10, device=cuda)
    codes = torch.zeros(10, dtype=torch.int8, device=cuda)
    kernels.LAUNCHES.clear()
    with pytest.raises(ValueError, match="int8"):
        compact.partition_cuda((f,), codes.bool(), (4, 4))
    with pytest.raises(ValueError, match="capacities"):
        compact.partition_cuda((f,), codes, (4, -1))
    with pytest.raises(ValueError, match="fields"):
        compact.partition_cuda((f,) * 9, codes, (4, 4))
    with pytest.raises(ValueError, match="field 0"):
        compact.partition_cuda((f[:9],), codes, (4, 4))
    assert kernels.LAUNCHES["partition"] == 0


# -- K9c on segments and K7 a thread a face slot -------------------------------------------


def _segments(sizes, share, seed, device, form="rows"):
    """Segments (fields, mask) of the given lanes, 8 fields each: rows of one
    [8, n] tensor, a strided view of a wider one, or a tuple; fields from a
    normal draw, -0.0 in field 0 of a tenth of the lanes."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        values = rng.standard_normal((8, n)).astype(np.float32)
        values[0, : n // 10] = -0.0
        if form == "strided":
            wide = torch.zeros((8, n + 7), device=device)
            wide[:, 3:3 + n] = torch.tensor(values, device=device)
            fields = wide[:, 3:3 + n]
        else:
            fields = torch.tensor(values, device=device)
            if form == "tuple":
                fields = tuple(f.clone() for f in fields)
        mask = torch.tensor(rng.uniform(size=n) < share, device=device)
        out.append((fields, mask))
    return out


def _plain_of_segments(segments, capacity):
    from cmacionize_torch.parallel import domain

    fields = [torch.cat(rows) for rows in zip(*(f for f, _ in segments))]
    return domain.compact_reference(fields, torch.cat([m for _, m in segments]), capacity)


@pytest.mark.parametrize("sizes", [(0,), (1,), (1000,), (1025, 70_001), (0, 300, 0),
                                   (40_000, 1, 33_333), (531_250, 531_250)])
@pytest.mark.parametrize("share", [0.0, 0.01, 0.5, 1.0])
@pytest.mark.parametrize("cap", ["below", "equal", "above"])
def test_compact_segments_kernel_equals_plain_version(cuda, sizes, share, cap):
    """K9c on 1-3 segments read in place against compact_reference of their
    concatenation: every lane, bit and count; the output one [8, capacity]
    view of one buffer."""
    from cmacionize_torch.parallel import domain

    segments = _segments(sizes, share, sum(sizes) + int(100 * share), cuda)
    n = sum(sizes)
    capacity = {"below": n // 3, "equal": n, "above": n + 777}[cap]
    kernels.LAUNCHES.clear()
    out, in_range, over = domain.compact_segments(segments, capacity)
    assert kernels.LAUNCHES["compact"] == 1
    ref, ref_range, ref_over = _plain_of_segments(segments, capacity)
    assert out.shape == (8, capacity) and all(_same_bits(a, b) for a, b in zip(out, ref))
    assert torch.equal(in_range, ref_range) and int(over) == int(ref_over)
    plain = domain.compact_segments_reference(segments, capacity)
    assert all(_same_bits(a, b) for a, b in zip(plain[0], ref))


@pytest.mark.parametrize("form", ["tuple", "strided"])
def test_compact_segments_kernel_takes_tuples_and_strided_rows(cuda, form):
    from cmacionize_torch.parallel import domain

    segments = _segments((5000, 3000, 77), 0.2, 9, cuda, form)
    segments[1] = _segments((3000,), 0.2, 10, cuda, "rows")[0]  # forms mixed
    out = domain.compact_segments(segments, 6000)
    ref = _plain_of_segments(segments, 6000)
    assert all(_same_bits(a, b) for a, b in zip(out[0], ref[0]))
    assert torch.equal(out[1], ref[1]) and int(out[2]) == int(ref[2])


def test_compact_segments_kernel_on_partition_views_with_shifted_padding(cuda):
    """The slab merge's inputs: two K9p buckets (capacity past the input, so
    field 0 of the padding carries the frame shift) as K9c's segments."""
    from cmacionize_torch.parallel import domain

    fields, bucket = _partition_inputs(20_000, "mixed", 11, cuda)
    sends = domain.partition(fields, bucket, (30_000, 30_000), (16.0, -16.0))
    segments = [(f, m) for f, m, _ in sends]
    for capacity in (10_000, 50_000, 60_000, 70_000):
        out = domain.compact_segments(segments, capacity)
        ref = _plain_of_segments(segments, capacity)
        assert all(_same_bits(a, b) for a, b in zip(out[0], ref[0]))
        assert torch.equal(out[1], ref[1]) and int(out[2]) == int(ref[2])


def test_compact_segments_kernel_on_a_side_stream_and_in_a_cuda_graph(cuda):
    from cmacionize_torch.parallel import domain

    segments = _segments((100_000, 90_000), 0.3, 12, cuda)
    ref = _plain_of_segments(segments, 150_000)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        first = domain.compact_segments(segments, 150_000)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = domain.compact_segments(segments, 150_000)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    for got in (first, out, domain.compact_segments(segments, 150_000)):
        assert all(_same_bits(a, b) for a, b in zip(got[0], ref[0]))
        assert torch.equal(got[1], ref[1]) and int(got[2]) == int(ref[2])


def test_compact_segments_kernel_occupancy_and_refusals(cuda):
    from cmacionize_torch.kernels import compact

    layout = compact.occupancy(cuda, compact.COMPACT)
    assert layout["blocks_per_sm"] >= 1 and layout["sms"] > 0
    (f, m), = _segments((10,), 0.5, 13, cuda)
    kernels.LAUNCHES.clear()
    with pytest.raises(ValueError, match="segments"):
        compact.compact_segments_cuda([(f, m)] * 4, 4)
    with pytest.raises(ValueError, match="8 fields"):
        compact.compact_segments_cuda([(f, m), (f[:3], m)], 4)
    with pytest.raises(ValueError, match="contiguous rows"):
        compact.compact_segments_cuda([(f.t().contiguous().t(), m)], 4)
    with pytest.raises(ValueError, match="capacity"):
        compact.compact_segments_cuda([(f, m)], -1)
    assert kernels.LAUNCHES["compact"] == 0


def _flux_inputs(cuda, n=2000, seed=4, si=True, dt=1.6e11, periodic=(False, False, False)):
    from cmacionize_torch.models import voronoi_hydro

    grid = _voronoi_grid(seed, n, periodic, si=si)
    state, gen_vel, gamma = _voronoi_hydro_inputs(grid, 5, si, cuda)
    return grid, voronoi_hydro.hydro_tables(grid, cuda), state, gen_vel, gamma, dt


@pytest.mark.parametrize("dt", [2e10, 1.6e11, 1.6e12, 1.6e13])
@pytest.mark.parametrize("second_order", [True, False])
def test_voronoi_flux_kernel_rows_with_first_order_faces(cuda, dt, second_order):
    """K7 against its plain version from few to most rows flagged (the update
    redoes the rows with a first-order face): identical flags, gradients and
    every field within 1e-5 of their max, and the same bits on a second
    call."""
    from cmacionize_torch.models import voronoi_hydro

    grid, tables, state, gen_vel, gamma, dt = _flux_inputs(cuda, dt=dt)
    stats_k, stats_r = {}, {}
    out_k = voronoi_hydro.voronoi_flux_update(*tables, state, gen_vel, dt, gamma, second_order,
                                              stats=stats_k)
    out_r = voronoi_hydro.voronoi_flux_update_reference(*tables, state, gen_vel, dt, gamma,
                                                        second_order, stats=stats_r)
    torch.cuda.synchronize()
    if second_order:
        assert torch.equal(stats_k["flag"], stats_r["flag"])
        for g_k, g_r in zip(stats_k["gradients"], stats_r["gradients"]):
            assert float((g_k - g_r).abs().max()) <= 1e-5 * max(float(g_r.abs().max()), 1e-30)
    for name, a, b in zip(out_r._fields, out_r, out_k):
        err = float((a - b).abs().max() / a.abs().max())
        assert err <= 1e-5, (name, err)
    again = voronoi_hydro.voronoi_flux_update(*tables, state, gen_vel, dt, gamma, second_order)
    assert all(_same_bits(a, b) for a, b in zip(out_k, again))


def test_voronoi_flux_kernel_on_a_side_stream_and_two_grids(cuda):
    from cmacionize_torch.models import voronoi_hydro

    small = _flux_inputs(cuda, n=300, seed=6)
    big = _flux_inputs(cuda, n=3000, seed=7, si=False, dt=2e-3, periodic=(True, True, True))
    refs = [voronoi_hydro.voronoi_flux_update_reference(*t, s, g, dt, gm, True)
            for _, t, s, g, gm, dt in (small, big)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs = [voronoi_hydro.voronoi_flux_update(*t, s, g, dt, gm, True)
                for _, t, s, g, gm, dt in (big, small, big)]
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for out, ref in zip(outs, (refs[1], refs[0], refs[1])):
        for a, b in zip(ref, out):
            assert float((a - b).abs().max() / a.abs().max()) <= 1e-5


def test_voronoi_flux_kernel_layout_and_wide_rows(cuda):
    from cmacionize_torch.kernels import voronoi_flux
    from cmacionize_torch.models import voronoi_hydro

    grid, tables, state, gen_vel, gamma, dt = _flux_inputs(cuda, n=500, seed=8)
    voronoi_hydro.voronoi_flux_update(*tables, state, gen_vel, dt, gamma, True)
    report, layout = voronoi_flux.ptxas_report(), voronoi_flux.occupancy(cuda)
    assert set(report) == set(voronoi_flux.KERNELS)
    assert all(r["registers"] > 0 for r in report.values())
    assert all(v["blocks_per_sm"] >= 1 for v in layout.values())
    # rows padded to 64 and to 256 slots give the same update
    ref = voronoi_hydro.voronoi_flux_update(*tables, state, gen_vel, dt, gamma, True)
    for K in (64, 256):
        pad = K - tables.neighbors.shape[1]
        wide = voronoi_hydro.HydroTables(
            torch.nn.functional.pad(tables.neighbors, (0, pad), value=-2),
            torch.nn.functional.pad(tables.normals, (0, 0, 0, pad)),
            torch.nn.functional.pad(tables.area_over_vol, (0, pad)),
            torch.nn.functional.pad(tables.face_rel, (0, 0, 0, pad)),
            torch.nn.functional.pad(tables.nbr_rel, (0, 0, 0, pad)))
        out = voronoi_hydro.voronoi_flux_update(*wide, state, gen_vel, dt, gamma, True)
        plain = voronoi_hydro.voronoi_flux_update_reference(*wide, state, gen_vel, dt, gamma,
                                                            True)
        for a, b, c in zip(ref, out, plain):
            assert float((a - b).abs().max() / a.abs().max()) <= 1e-5
            assert float((c - b).abs().max() / c.abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="at most 256"):
        wider = torch.nn.functional.pad(tables.neighbors, (0, 257 - tables.neighbors.shape[1]),
                                        value=-2)
        voronoi_flux.voronoi_flux_update_cuda(
            wider, *(torch.nn.functional.pad(t, (0, 0, 0, 257 - t.shape[1])) if t.dim() == 3
                     else torch.nn.functional.pad(t, (0, 257 - t.shape[1]))
                     for t in tables[1:]), state, gen_vel, dt, gamma=gamma)


@pytest.mark.parametrize("received", [0, 4952])
def test_compact_segments_kernel_at_the_slab_merge(cuda, received):
    """K9c at the sharded starbench's merge: two K9p buckets of 531,250
    lanes (members first, then other lanes, field 0 in the receiver's frame)
    compacted into the 1e6-lane carry, against compact_reference of their
    concatenation."""
    from cmacionize_torch.parallel import domain

    n, cap, W = 2_000_000, 531_250, 1_000_000
    rng = np.random.default_rng(received)
    fields = torch.tensor(rng.standard_normal((8, n)).astype(np.float32), device=cuda)
    codes = np.full(n, -1, np.int8)
    codes[rng.choice(n, received, replace=False)] = 1
    sends = domain.partition(fields, torch.tensor(codes, device=cuda), (cap, cap),
                             (16.0, -16.0))
    segments = [(sends[1][0], sends[1][1]), (sends[0][0], sends[0][1])]
    kernels.LAUNCHES.clear()
    out = domain.compact_segments(segments, W)
    assert kernels.LAUNCHES["compact"] == 1 and out[0].shape == (8, W)
    ref = _plain_of_segments(segments, W)
    assert all(_same_bits(a, b) for a, b in zip(out[0], ref[0]))
    assert torch.equal(out[1], ref[1]) and int(out[2]) == int(ref[2]) == 0
    assert int(out[1].sum()) == received


def test_voronoi_flux_kernel_on_the_starbench_voronoi_grid(cuda):
    """K7 at the main path's shape: the starbench_voronoi grid (40000
    generators from seed 42, 2 Lloyd iterations, K = 25), a shell state,
    second and first order, against its plain version."""
    from cmacionize_torch.models import voronoi, voronoi_hydro

    geometry = GridGeometry((-1.256 * PC,) * 3, (2.512 * PC,) * 3, (32, 32, 32))
    grid = voronoi.build_voronoi_grid(geometry, np.random.default_rng(42).random((40000, 3)),
                                      num_lloyd=2)
    state, gen_vel, gamma = _voronoi_hydro_inputs(grid, 9, True, cuda)
    tables = voronoi_hydro.hydro_tables(grid, cuda)
    for second_order in (True, False):
        stats_k, stats_r = {}, {}
        out_k = voronoi_hydro.voronoi_flux_update(*tables, state, gen_vel, 4.3453e9, gamma,
                                                  second_order, stats=stats_k)
        out_r = voronoi_hydro.voronoi_flux_update_reference(*tables, state, gen_vel, 4.3453e9,
                                                            gamma, second_order, stats=stats_r)
        torch.cuda.synchronize()
        if second_order:
            assert torch.equal(stats_k["flag"], stats_r["flag"])
        for name, a, b in zip(out_r._fields, out_r, out_k):
            assert bool(torch.isfinite(b).all()), name
            assert float((a - b).abs().max() / a.abs().max()) <= 1e-5, name


# -- K13h in one launch, K8 in its order: the redesigns of K13h and K8 ---------------------------


def _histogram_case(cuda, n, nstep, weights, seed=0, one_lane=None):
    from cmacionize_torch.kernels import probe_deposit as pd

    rng = np.random.default_rng(seed)
    lidx = rng.integers(-300, 300, n) if one_lane is None else np.full(n, one_lane)
    dep = rng.integers(-3, 4, n) if weights == "integer" else rng.uniform(0.0, 1.0, n)
    dep = torch.tensor(dep.astype(np.float32), device=cuda)
    lidx = torch.tensor(lidx.astype(np.int32), device=cuda)
    kernels.LAUNCHES.clear()
    out = pd.shifted_histogram(dep, lidx, nstep)
    again = pd.shifted_histogram(dep, lidx, nstep)
    ref = pd.shifted_histogram_reference(dep, lidx, nstep)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["shifted_histogram"] == 2 and out.shape == (128,)
    # the ticket is reset: the second call sums the same rows in the same order
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    if weights == "integer" or nstep == 0 or n == 0:
        assert torch.equal(out, ref)
    else:
        assert float(((out.double() - ref.double()).abs() / ref.double().abs()).max()) <= 1e-5
    return out


@pytest.mark.parametrize("n", [0, 1, 33, 1000, 1025, 2**16 + 7])
@pytest.mark.parametrize("weights", ["integer", "random"])
def test_shifted_histogram_in_one_launch_on_ragged_packets(cuda, n, weights):
    out = _histogram_case(cuda, n, 7808, weights, seed=n)
    if n == 0:
        assert float(out.abs().max()) == 0.0


@pytest.mark.parametrize("nstep", [0, 31, 61, 7809, 10_000])
def test_shifted_histogram_in_one_launch_on_ragged_steps(cuda, nstep):
    # ranges of steps that do not divide into the blocks' (32 at the least)
    for weights in ("integer", "random"):
        _histogram_case(cuda, 1024, nstep, weights, seed=nstep)


@pytest.mark.parametrize("lane", [0, 127, -5])
def test_shifted_histogram_warp_on_one_lane(cuda, lane):
    # every lane of every warp in one group: one leader adds the group's sum
    for weights in ("integer", "random"):
        _histogram_case(cuda, 96, 7808, weights, seed=3, one_lane=lane)


def test_shifted_histogram_on_the_tools_inputs_and_from_a_side_stream(cuda):
    from cmacionize_torch.kernels import probe_deposit as pd
    from cmacionize_torch.tools import probe_deposit as tool

    dep, lidx = tool.sublane_inputs(cuda)
    ref = pd.shifted_histogram_reference(dep, lidx, tool.NSTEP)
    first = pd.shifted_histogram(dep, lidx, tool.NSTEP)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        second = pd.shifted_histogram(dep, lidx, tool.NSTEP)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(first, ref) and torch.equal(second, ref)


def test_shifted_histogram_on_two_streams_at_once(cuda):
    # each stream keeps its own scratch and ticket: calls left unordered
    # between the streams still give the plain version's bits
    from cmacionize_torch.kernels import probe_deposit as pd

    rng = np.random.default_rng(11)
    dep = torch.tensor(rng.integers(-3, 4, 2**16).astype(np.float32), device=cuda)
    lidx = torch.tensor(rng.integers(0, 128, 2**16).astype(np.int32), device=cuda)
    ref = pd.shifted_histogram_reference(dep, lidx, 7808)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = {0: [], 1: []}
    for _ in range(8):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[k].append(pd.shifted_histogram(dep, lidx, 7808))
    torch.cuda.synchronize()
    assert all(torch.equal(o, ref) for k in outs for o in outs[k])


def test_shifted_histogram_after_a_graph_capture_on_its_stream(cuda):
    # a scratch made in a capture is zeroed only by the graph: a call outside
    # the capture on that stream makes its own
    from cmacionize_torch.kernels import probe_deposit as pd

    rng = np.random.default_rng(12)
    dep = torch.tensor(rng.integers(-3, 4, 4096).astype(np.float32), device=cuda)
    lidx = torch.tensor(rng.integers(0, 128, 4096).astype(np.int32), device=cuda)
    ref = pd.shifted_histogram_reference(dep, lidx, 500)
    stream, graph = torch.cuda.Stream(), torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=stream):
        captured = pd.shifted_histogram(dep, lidx, 500)
    with torch.cuda.stream(stream):
        eager = pd.shifted_histogram(dep, lidx, 500)
    torch.cuda.synchronize()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(eager, ref) and torch.equal(captured, ref)


def _k8_plain(sim, pos, direction, weight, active, **kw):
    from cmacionize_torch.ops import peel_off

    npix = sim.view.pixels[0] * sim.view.pixels[1]
    ccd = torch.zeros(npix, device=pos.device)
    factor = peel_off.peel_off_factor(weight, direction, view=sim.view, **kw)
    tau, pix = peel_off.peel_off_deposit_reference(sim.chi, pos, factor, active, ccd,
                                                   view=sim.view)
    return tau, pix, ccd


def _k8_against_plain(sim, pos, direction, weight, active, **kw):
    from cmacionize_torch.kernels.peel_off import peel_off_cuda

    n = pos.shape[0]
    npix = sim.view.pixels[0] * sim.view.pixels[1]
    ccd = torch.zeros(npix, device=pos.device)
    tau = torch.full((n,), 7.0, device=pos.device)
    pix = torch.full((n,), 7, dtype=torch.int32, device=pos.device)
    peel_off_cuda(sim.chi, pos, direction, weight, active, ccd, view=sim.view, tau_out=tau,
                  pix_out=pix, **kw)
    tau_r, pix_r, ccd_r = _k8_plain(sim, pos, direction, weight, active, **kw)
    torch.cuda.synchronize()
    assert torch.equal(tau[active], tau_r[active]) and torch.equal(pix[active], pix_r[active])
    assert bool((tau[~active] == 0).all()) and bool((pix[~active] == -1).all())
    total = float(ccd_r.abs().sum())
    assert float((ccd - ccd_r).abs().sum()) <= 1e-5 * total
    return tau, pix, ccd


@pytest.mark.parametrize("view", sorted(DUST_VIEWS))
def test_peel_off_matches_plain_version(cuda, view):
    kw = dict(DUST_VIEWS[view])
    if view == "periodic":
        kpc = 3.086e19
        kw["geometry"] = GridGeometry((-12 * kpc, -16 * kpc, -10 * kpc),
                                      (24 * kpc, 32 * kpc, 20 * kpc), (24, 32, 20),
                                      (True, False, True))
    sim = _dust_sim(cuda, **kw)
    pos, d, _, stokes, active = _dust_events(sim, 11, 30_000, cuda)
    kernels.LAUNCHES.clear()
    for direction in (None, d):
        _k8_against_plain(sim, pos, direction, stokes[0], active, albedo=0.67, hgg=0.44)
    assert kernels.LAUNCHES["peel_off"] == 2


@pytest.mark.parametrize("n_active", [0, 1])
def test_peel_off_with_no_or_one_active_event(cuda, n_active):
    from cmacionize_torch.kernels.peel_off import peel_off_cuda

    sim = _dust_sim(cuda)
    pos, d, _, stokes, active = _dust_events(sim, 13, 5000, cuda)
    active = torch.zeros_like(active)
    active[4321:4321 + n_active] = True
    _, _, ccd = _k8_against_plain(sim, pos, d, stokes[0], active, albedo=0.67, hgg=0.44)
    assert int((ccd != 0).sum()) == n_active
    # the driver's call: no τ or pixel outputs
    npix = sim.view.pixels[0] * sim.view.pixels[1]
    ccd = torch.zeros(npix, device=cuda)
    kernels.LAUNCHES.clear()
    peel_off_cuda(sim.chi, pos, d, stokes[0], active, ccd, view=sim.view)
    assert kernels.LAUNCHES["peel_off"] == 1
    _, _, ccd_r = _k8_plain(sim, pos, d, stokes[0], active)
    torch.cuda.synchronize()
    assert float((ccd - ccd_r).abs().sum()) <= 1e-5 * max(float(ccd_r.abs().sum()), 1e-30)


def test_peel_off_events_on_walls_and_the_box_edge(cuda):
    sim = _dust_sim(cuda)
    shape = torch.tensor(sim.view.shape, dtype=torch.float32)
    rng = np.random.default_rng(17)
    n = 4096
    # on cell walls and corners, on the box's faces (0 and n), and just
    # inside and outside of walls
    cells = rng.integers(0, 41, (n, 3)).astype(np.float32)
    pos = torch.tensor(cells).clamp(max=shape)
    up, down = pos[n // 2: 3 * n // 4], pos[3 * n // 4:]
    pos[n // 2: 3 * n // 4] = torch.nextafter(up, torch.full_like(up, np.inf))
    pos[3 * n // 4:] = torch.nextafter(down, torch.full_like(down, -np.inf)).clamp(min=0.0)
    pos = pos.to(cuda)
    active = torch.ones(n, dtype=torch.bool, device=cuda)
    weight = torch.full((n,), 1.0 / n, device=cuda)
    _k8_against_plain(sim, pos, None, weight, active)


def test_peel_off_with_the_driver_counts_at_full_size(cuda):
    """dusty_galaxy at full size (201³, 5e5 photons): every K8 call of a run
    held to the plain version (τ and pixels bit for bit, the image within
    f32 round-off), and the driver's own call (no τ or pixel outputs) held
    to the plain image; K8p's first and last orders."""
    from cmacionize_torch.kernels.peel_off import peel_off_cuda
    from cmacionize_torch.kernels.peel_off_polarized import peel_off_polarized_cuda
    from cmacionize_torch.models import dust_simulation
    from cmacionize_torch.models.dusty_galaxy import DUSTY_GALAXY_PARAMS
    from cmacionize_torch.ops import peel_off

    config = dust_simulation.dust_config_from_params(ParameterFile(DUSTY_GALAXY_PARAMS))
    sim = dust_simulation.DustSimulation(config, device=cuda, seed=42)
    calls, pol_calls = [], []
    original, original_pol = peel_off.peel_off_deposit, peel_off.peel_off_deposit_polarized

    def keep(*args, **kw):
        calls.append((tuple(a.clone() for a in args[1:4]), dict(kw)))
        return original(*args, **kw)

    def keep_pol(*args, **kw):
        pol_calls.append((args, dict(kw)))
        return original_pol(*args, **kw)

    peel_off.peel_off_deposit, peel_off.peel_off_deposit_polarized = keep, keep_pol
    try:
        sim.run()
        pol_calls_run = sim.run_polarized()
    finally:
        peel_off.peel_off_deposit, peel_off.peel_off_deposit_polarized = original, original_pol
    assert pol_calls_run is not None and len(calls) >= 3
    view = sim.view
    for (pos, weight, active), kw in calls:
        kw = dict(kw)
        direction = kw.pop("direction", None)
        kw.pop("view")
        tau_r, pix_r, ccd_r = _k8_plain(sim, pos, direction, weight, active, **kw)
        tau = torch.empty(pos.shape[0], device=cuda)
        pix = torch.empty(pos.shape[0], dtype=torch.int32, device=cuda)
        ccd = torch.zeros(view.pixels[0] * view.pixels[1], device=cuda)
        ccd_driver = torch.zeros_like(ccd)
        peel_off_cuda(sim.chi, pos, direction, weight, active, ccd, view=view, tau_out=tau,
                      pix_out=pix, **kw)
        peel_off.peel_off_deposit(sim.chi, pos, weight, active, ccd_driver, view=view,
                                  direction=direction, **kw)
        torch.cuda.synchronize()
        assert torch.equal(tau[active], tau_r[active])
        assert torch.equal(pix[active], pix_r[active])
        for image in (ccd, ccd_driver):
            assert float((image - ccd_r).abs().sum()) <= 1e-5 * float(ccd_r.abs().sum())
    for args, kw in (pol_calls[0], pol_calls[-1]):
        chi, pos, d, nref, stokes, active, planes = args
        tau = torch.empty(pos.shape[0], device=cuda)
        pix = torch.empty(pos.shape[0], dtype=torch.int32, device=cuda)
        peel_off_polarized_cuda(chi, pos, d, nref, stokes, active,
                                tuple(torch.zeros_like(p) for p in planes), tau_out=tau,
                                pix_out=pix, **kw)
        tau_r = peel_off.peel_off_tau_reference(chi, pos, view=view)
        pix_r = peel_off.ccd_pixel_reference(pos, view=view)
        torch.cuda.synchronize()
        assert torch.equal(tau[active], tau_r[active])
        assert torch.equal(pix[active], pix_r[active])
