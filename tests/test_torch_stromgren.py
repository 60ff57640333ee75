"""cmacionize_torch hydrogen-only driver against the JAX driver, on the CPU.

One iteration continued from the JAX simulation's state, on the same packets,
must reproduce the JAX march + balance; a whole mini Strömgren run must find
the analytic radius and agree with the JAX run within Monte Carlo noise (the
two packages' random streams differ).
"""

import dataclasses
import io
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.models.ionization_simulation import (
    HOnlyConfig,
    HOnlyIonizationSimulation,
)
from cmacionize_torch.ops import traversal
from cmacionize_torch.utils.logging import TerminalLog
from cmacionize_torch.utils.params import ParameterFile
from cmacionize_tpu.models import ionization_simulation as jax_sim
from cmacionize_tpu.models.grid import GridGeometry as JaxGridGeometry
from cmacionize_tpu.ops import ionization as jax_ionization
from cmacionize_tpu.ops import traversal as jax_traversal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PC = 3.086e16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mini_configs(shape, n_photons, n_iterations):
    """The same mini Strömgren setup (tests/test_ionization.py) in both
    packages."""
    kwargs = dict(
        number_density=1e8,
        temperature=8000.0,
        source_position=(0.0, 0.0, 0.0),
        luminosity=4.26e49,
        cross_section=6.3e-22,
        recombination_rate=4e-19,
        n_photons=n_photons,
        n_iterations=n_iterations,
    )
    box = dict(anchor=(-5 * PC,) * 3, sides=(10 * PC,) * 3, shape=shape)
    return (
        HOnlyConfig(geometry=GridGeometry(**box), **kwargs),
        jax_sim.HOnlyConfig(geometry=JaxGridGeometry(**box), **kwargs),
    )


def _ionized_radius(xH, geometry):
    v_ion = (np.asarray(xH) < 0.5).sum() * geometry.cell_volume
    return (3 * v_ion / (4 * np.pi)) ** (1 / 3)


def test_iteration_from_jax_state_matches_jax():
    shape = (16, 16, 16)
    config, jax_config = _mini_configs(shape, 6000, 2)
    # carry the JAX simulation's state after two iterations into the port
    ref = jax_sim.HOnlyIonizationSimulation(jax_config, seed=3)
    ref.run()
    state = {
        name: np.asarray(getattr(ref, name))
        for name in HOnlyIonizationSimulation.STATE_FIELDS
    }
    sim = HOnlyIonizationSimulation(config, device="cpu")
    sim.load_reference_state(state)
    assert sim.number_density.dtype == torch.float32
    assert (sim.neutral_fraction.numpy() == state["neutral_fraction"]).all()

    # the same packets from the source, made with numpy
    rng = np.random.default_rng(8)
    n = config.n_photons
    cos_t = rng.uniform(-1, 1, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    sin_t = np.sqrt(1 - cos_t**2)
    direction = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], 1)
    gpos = np.asarray(config.geometry.position_to_grid_coords(config.source_position))
    position = gpos + 1e-4 * direction
    tau = -np.log1p(-rng.uniform(0, 1, n))
    f32 = [np.asarray(a, np.float32) for a in (position, direction, tau, np.ones(n))]

    n_escaped = sim.step(traversal.make_packets(*map(torch.from_numpy, f32), shape))
    assert sim.iteration == 1

    dx = float(config.geometry.cell_size[0])
    sigma_dx = config.cross_section * dx
    jfac_scale = (
        config.luminosity * config.cross_section * dx
        / (config.n_photons * config.geometry.cell_volume)
    )
    nd = jnp.asarray(state["number_density"])
    chi = (nd * jnp.asarray(state["neutral_fraction"]) * sigma_dx).reshape(-1)
    tally, packets = jax_traversal.trace_packets(
        chi, jax_traversal.make_packets(*map(jnp.asarray, f32), shape),
        jnp.zeros(chi.shape, jnp.float32), shape=shape,
    )
    jH = tally.reshape(shape) * jfac_scale
    new_x = jax_ionization.hydrogen_neutral_fraction(jH, nd, config.recombination_rate)
    assert new_x.dtype == jnp.float32

    assert int(n_escaped) == int(jnp.sum(~packets.absorbed))
    assert 0 < int(n_escaped) < n
    np.testing.assert_allclose(sim.jH.numpy(), np.asarray(jH), rtol=1e-5)
    np.testing.assert_allclose(sim.neutral_fraction.numpy(), np.asarray(new_x), rtol=1e-5)


def test_mini_stromgren_radius_matches_analytic_and_jax():
    # 24^3 grid, 2e4 photons, 8 iterations (tests/test_ionization.py)
    config, jax_config = _mini_configs((24, 24, 24), 20000, 8)
    sim = HOnlyIonizationSimulation(config, device="cpu", seed=7)
    xH = sim.run().numpy()
    Rs = sim.stromgren_radius_analytic()
    r_port = _ionized_radius(xH, config.geometry)
    assert r_port == pytest.approx(Rs, rel=0.1)
    # center is highly ionized, corners neutral
    assert xH[12, 12, 12] < 1e-4
    assert xH[0, 0, 0] > 0.99
    assert xH.dtype == np.float32 and np.isfinite(xH).all()

    ref = jax_sim.HOnlyIonizationSimulation(jax_config, seed=7)
    r_jax = _ionized_radius(ref.run(), jax_config.geometry)
    assert Rs == pytest.approx(ref.stromgren_radius_analytic(), rel=1e-12)
    assert r_port == pytest.approx(r_jax, rel=0.05)


def test_stromgren_param_drives_the_port_at_reduced_size():
    params = ParameterFile(os.path.join(ROOT, "benchmarks", "stromgren.param"))
    config = HOnlyConfig.from_params(params)
    assert config.geometry.shape == (64, 64, 64) and config.n_photons == 1_000_000
    config = dataclasses.replace(
        config,
        geometry=dataclasses.replace(config.geometry, shape=(16, 16, 16)),
        n_photons=3000,
        n_iterations=3,
    )
    stream = io.StringIO()
    sim = HOnlyIonizationSimulation(config, device="cpu", log=TerminalLog(stream=stream))
    sim.run(2)
    assert sim.iteration == 2 and sim.n_escaped.shape == (2,)
    sim.advance(1)
    assert sim.iteration == 3 and sim.n_escaped.shape == (1,)
    assert sim.run() is sim.neutral_fraction  # nothing left to do
    assert sim.iteration == 3
    # one line per iteration, printed after each run's loop
    lines = stream.getvalue().splitlines()
    assert len(lines) == 3
    assert re.search(r"iteration 1/2: \d+ / 3000 photons escaped$", lines[0])
    assert lines[-1].endswith(f"iteration 3/3: {int(sim.n_escaped[0])} / 3000 photons escaped")
    assert sim.neutral_fraction.shape == (16, 16, 16)
    assert sim.jH.dtype == torch.float32 and float(sim.jH.max()) > 0


def test_driver_rejects_bad_geometry_and_state():
    config, _ = _mini_configs((8, 8, 8), 100, 1)
    skewed = dataclasses.replace(
        config, geometry=dataclasses.replace(config.geometry, shape=(8, 8, 4))
    )
    with pytest.raises(NotImplementedError, match="cubic"):
        HOnlyIonizationSimulation(skewed, device="cpu")
    sim = HOnlyIonizationSimulation(config, device="cpu")
    bad = {name: np.zeros((4, 4, 4)) for name in HOnlyIonizationSimulation.STATE_FIELDS}
    with pytest.raises(ValueError, match="shape"):
        sim.load_reference_state(bad)
