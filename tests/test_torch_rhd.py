"""cmacionize_torch RHD driver against the JAX driver, on the CPU.

``from_params`` on benchmarks/starbench.param must give the JAX driver's
configuration and initial f32 state; hydro-only stepping from one state
(carried over with ``load_reference_state``) and the production ``run`` loop
must track the JAX driver; a mirror of tests/test_rhd.py checks the physics
of the port's CPU path.  The Monte Carlo streams of the two packages differ,
so runs with radiation are compared with the analytic laws, not bit for bit.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch import constants
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.models.rhd_simulation import (
    RHDConfig,
    RHDSimulation,
    hosokawa_inutsuka_radius,
    spitzer_radius,
)
from cmacionize_torch.ops import hydro
from cmacionize_torch.utils.params import ParameterFile
from cmacionize_torch.utils.timeline import TimeLine
from cmacionize_tpu.models import rhd_simulation as jax_rhd
from cmacionize_tpu.models.grid import GridGeometry as JaxGridGeometry
from cmacionize_tpu.ops import hydro as jax_hydro
from cmacionize_tpu.utils.params import ParameterFile as JaxParameterFile
from cmacionize_tpu.utils.timeline import TimeLine as JaxTimeLine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCHMARKS = os.path.join(ROOT, "benchmarks")
PC = 3.086e16
STARBENCH_GAMMA = 1.0001


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def flush_denormals():
    """XLA runs its CPU programs with subnormals flushed to zero; torch keeps
    them.  In SI units the limiter's product of two density differences
    (~1e-19 kg m^-3 each) falls in the subnormal range, so without this
    the two would take different slopes in a few cells (8e-5 of ρ after one
    step, 2e-4 after 20).  With both flushing, they agree to 4e-7."""
    if not torch.set_flush_denormal(True):
        pytest.skip("this CPU cannot flush subnormals")
    yield
    torch.set_flush_denormal(False)


@pytest.fixture
def in_benchmarks():
    """from_params opens starbench.yml relative to the working directory."""
    prev = os.getcwd()
    os.chdir(BENCHMARKS)
    try:
        yield
    finally:
        os.chdir(prev)


def test_starbench_from_params_matches_jax(in_benchmarks):
    sim = RHDSimulation.from_params(ParameterFile("starbench.param"), device="cpu", seed=42)
    ref = jax_rhd.RHDSimulation.from_params(JaxParameterFile("starbench.param"), seed=42)
    port_cfg, ref_cfg = dataclasses.asdict(sim.config), dataclasses.asdict(ref.config)
    assert port_cfg.keys() == ref_cfg.keys()
    for key in ref_cfg:
        assert port_cfg[key] == ref_cfg[key], key
    assert sim.config.geometry.shape == (64, 64, 64)
    assert isinstance(sim.config.n_photons, int) and sim.config.nloop == 10
    # f64 numpy initial conditions cast to f32: the same state bit for bit
    for name, a, b in zip(ref.state._fields, ref.state, sim.state):
        assert b.dtype == torch.float32, name
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(ref.neutral_fraction), sim.neutral_fraction.numpy())
    assert sim._source_gpos == ref._source_gpos


@pytest.mark.parametrize(
    "key, value",
    [
        ("RadiationHydrodynamicsSimulation:use potential", True),
        ("RadiationHydrodynamicsSimulation:use self gravity", True),
        ("RadiationHydrodynamicsSimulation:use cooling", True),
        ("RadiationHydrodynamicsSimulation:use mask", True),
        ("HydroIntegrator:boundary x low", "bondi"),
        ("HydroIntegrator:polytropic index", 1.0),
        ("PhotonSourceDistribution:type", "AsciiFile"),
        ("DensityFunction:type", "DiscPatch"),
    ],
)
def test_from_params_refuses_what_is_not_ported(in_benchmarks, key, value):
    params = ParameterFile("starbench.param")
    section, name = key.split(":")
    params._tree.setdefault(section, {})[name] = value
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RHDSimulation.from_params(params, device="cpu")


def test_timeline_matches_jax_on_starbench_steps():
    params = ParameterFile(os.path.join(BENCHMARKS, "starbench.param"))
    total = params.get_physical_value("RadiationHydrodynamicsSimulation:total time", "time")
    dt = params.get_physical_value("RadiationHydrodynamicsSimulation:minimum timestep", "time")
    port, ref = TimeLine(0.0, total, dt, dt), JaxTimeLine(0.0, total, dt, dt)
    steps = 0
    while not ref.finished:
        assert port.set_timestep(dt) == ref.set_timestep(dt)
        assert port.advance() == ref.advance()
        assert port.current_time == ref.current_time
        steps += 1
    assert port.finished and steps == 2048
    assert port.current_time == pytest.approx(total, rel=1e-12)
    assert ref.current_timestep * 2048 == pytest.approx(total, rel=1e-12)


def _configs(shape, nloop, n_photons=2000, total_steps=20, dt=2e10):
    kwargs = dict(
        gamma=STARBENCH_GAMMA, timestep=dt, total_time=dt * total_steps,
        luminosity=1e49, source_position=(0.0, 0.0, 0.0), cross_section=6.3e-22,
        recombination_rate=2.7e-19, n_photons=n_photons, nloop=nloop,
        background_density=3.113e9, background_temperature=100.0,
        minimum_timestep=dt, maximum_timestep=dt,
    )
    box = dict(anchor=(-1.256 * PC,) * 3, sides=(2.512 * PC,) * 3, shape=shape)
    return (
        RHDConfig(geometry=GridGeometry(**box), **kwargs),
        jax_rhd.RHDConfig(geometry=JaxGridGeometry(**box), **kwargs),
    )


def _bubble_state(shape, seed=11):
    """An expanding HII region in SI: ionized hot gas inside, a dense shell
    moving outwards at 10 km/s, cold neutral gas outside."""
    rng = np.random.default_rng(seed)
    centre = np.asarray(shape, float) / 2.0
    offset = np.indices(shape) + 0.5 - centre[:, None, None, None]
    r = np.sqrt((offset**2).sum(0)) / shape[0]
    inside, shell = r < 0.2, (r >= 0.2) & (r < 0.3)
    nd = 3.113e9 * rng.uniform(0.98, 1.02, shape) * np.where(
        inside, 0.1, np.where(shell, 2.5, 1.0))
    T = np.where(inside, 1e4, 100.0)
    xh = np.where(inside, 1e-4, 1.0)
    radial = offset / np.maximum(np.sqrt((offset**2).sum(0)), 1e-9)
    vel = np.where(shell, 1e4, 0.0) * radial
    w = jax_hydro.Primitives(*(
        jnp.asarray(np.asarray(a, np.float32))
        for a in (nd * constants.PROTON_MASS, *vel, nd * constants.BOLTZMANN * T)
    ))
    u = jax_hydro.conserved_from_primitives(w, STARBENCH_GAMMA)
    arrays = {name: np.asarray(f) for name, f in zip(u._fields, u)}
    arrays["neutral_fraction"] = np.asarray(xh, np.float32)
    return arrays


def test_hydro_only_steps_from_one_state_match_jax(flush_denormals):
    shape = (14, 14, 14)
    config, jax_config = _configs(shape, nloop=0)
    state = _bubble_state(shape)
    ref = jax_rhd.RHDSimulation(jax_config, seed=1)
    ref.state = jax_hydro.HydroState(*(jnp.asarray(state[f]) for f in jax_hydro.HydroState._fields))
    ref.neutral_fraction = jnp.asarray(state["neutral_fraction"])
    sim = RHDSimulation(config, device="cpu", seed=1)
    sim.load_reference_state(state, time=0.0)
    ref.advance(20, log_every=10**9)
    sim.advance(20, log_every=10**9)
    assert sim.time == pytest.approx(ref.time, rel=1e-12)
    np.testing.assert_array_equal(sim.neutral_fraction.numpy(), state["neutral_fraction"])
    # 20 jitted XLA steps (FMA-contracted) against 20 plain torch steps:
    # 3.5e-7 of each field's largest magnitude measured, held to 1e-5
    for name, a, b in zip(ref.state._fields, ref.state, sim.state):
        a = np.asarray(a, np.float64)
        err = np.abs(a - b.numpy()).max() / np.abs(a).max()
        assert err <= 1e-5, (name, err)
    moved = np.abs(sim.state.rho.numpy() - state["rho"]).max() / state["rho"].max()
    assert moved > 1e-3  # the shell did move


def test_run_snapshots_and_state_match_jax(flush_denormals):
    shape = (10, 10, 10)
    config, jax_config = _configs(shape, nloop=0, total_steps=40)
    state = _bubble_state(shape, seed=12)
    ref = jax_rhd.RHDSimulation(jax_config, seed=1)
    ref.state = jax_hydro.HydroState(*(jnp.asarray(state[f]) for f in jax_hydro.HydroState._fields))
    sim = RHDSimulation(config, device="cpu", seed=1)
    sim.load_reference_state(state)
    port_snaps, ref_snaps = [], []
    sim.run(snapshot_callback=lambda s, i: port_snaps.append((i, s.time)))
    ref.run(snapshot_callback=lambda s, i: ref_snaps.append((i, s.time)))
    assert [i for i, _ in port_snaps] == list(range(1, 11))
    assert port_snaps == ref_snaps
    for name, a, b in zip(ref.state._fields, ref.state, sim.state):
        a = np.asarray(a, np.float64)
        assert np.abs(a - b.numpy()).max() <= 1e-5 * np.abs(a).max(), name


def test_starbench_early_expansion():
    """Mirror of tests/test_rhd.py::test_starbench_early_expansion on the
    port's CPU path (24³, 4000 photons, nloop 2, 100 steps)."""
    n_cells = 24
    geometry = GridGeometry(anchor=(-1.256 * PC,) * 3, sides=(2.512 * PC,) * 3,
                            shape=(n_cells,) * 3)
    dt, n_steps = 8.9e9, 100
    config = RHDConfig(
        geometry=geometry, gamma=STARBENCH_GAMMA, timestep=dt, total_time=dt * n_steps,
        luminosity=1e49, source_position=(0.0, 0.0, 0.0), cross_section=6.3e-22,
        recombination_rate=2.7e-19, n_photons=4000, nloop=2, blocks=[],
        background_density=3.113e9, background_temperature=100.0,
    )
    sim = RHDSimulation(config, device="cpu", seed=5)
    state, xH = sim.advance(n_steps, log_every=10**9)

    r_st = (3 * 1e49 / (4 * np.pi * (3.113e9) ** 2 * 2.7e-19)) ** (1 / 3)
    r_front = sim.ionization_front_radius()
    r_sp = spitzer_radius(sim.time, r_st)
    r_hi = hosokawa_inutsuka_radius(sim.time, r_st)
    # coarse grid + few photons: the envelope of the JAX test
    assert 0.7 * r_sp < r_front < 1.35 * r_hi, (r_front / PC, r_sp / PC, r_hi / PC)
    xH = xH.numpy()
    c = n_cells // 2
    assert xH[c, c, c] < 1e-3
    assert xH[0, 0, 0] > 0.99
    total_mass = float(state.rho.double().sum()) * geometry.cell_volume
    expected = 3.113e9 * constants.PROTON_MASS * geometry.cell_volume * n_cells**3
    assert abs(total_mass / expected - 1) < 1e-4
    w = hydro.primitives_from_conserved(state, config.gamma)
    assert float(w.p.min()) > 0
