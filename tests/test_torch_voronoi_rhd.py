"""cmacionize_torch's Voronoi RHD driver (starbench_voronoi) against the JAX
driver, on the CPU.

The port takes the JAX driver's state and steps it alike; the coupling is
the JAX one; the reduced starbench_voronoi of
tests/test_voronoi_hydro.py::test_dtype_expansion_on_voronoi runs through
both packages on one tessellation.

The JAX driver runs here as production runs it, in f32: with
``jax_enable_x64`` on (as tests/conftest.py sets it) its least-squares
gradients add ``jnp.eye(3)``, an f64 array, so the update and from then on
the state turn f64 (ROADMAP.md, queue 3).  The port is f32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch.models import voronoi, voronoi_hydro
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.models.rhd_simulation import hosokawa_inutsuka_radius, spitzer_radius
from cmacionize_tpu.models import voronoi as jax_voronoi
from cmacionize_tpu.models import voronoi_hydro as jax_hydro
from cmacionize_tpu.models.grid import GridGeometry as JaxGridGeometry

PC = 3.086e16
MYR = 3.15576e13
MP = 1.672621898e-27
KB = 1.380649e-23
TABLES = ("generators", "volumes", "centroids", "neighbors", "normals", "offsets", "shifts",
          "areas", "face_centroids")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def flush_denormals():
    """XLA runs its CPU programs with subnormals flushed; torch keeps them."""
    if not torch.set_flush_denormal(True):
        pytest.skip("this CPU cannot flush subnormals")
    yield
    torch.set_flush_denormal(False)


def to_jax_grid(grid):
    g = grid.geometry
    return jax_voronoi.VoronoiGrid(
        geometry=JaxGridGeometry(g.anchor, g.sides, g.shape, g.periodic), scale=grid.scale,
        **{name: getattr(grid, name) for name in TABLES})


def _grid(n, seed, num_lloyd=1):
    rng = np.random.default_rng(seed)
    geometry = GridGeometry((-1.256 * PC,) * 3, (2.512 * PC,) * 3, (8, 8, 8))
    return voronoi.build_voronoi_grid(geometry, rng.random((n, 3)), num_lloyd=num_lloyd)


def _rhd_kwargs(n_steps, **extra):
    return dict(gamma=1.0001, timestep=0.141 * MYR / n_steps, luminosity=1e49,
                source_position=(0.0, 0.0, 0.0), cross_section=6.3e-22,
                recombination_rate=2.7e-19, number_density=3.113e9, temperature=100.0,
                **extra)


@pytest.mark.parametrize("mesh_motion", [False, True])
def test_rhd_driver_steps_jax_state_alike(flush_denormals, mesh_motion):
    """Hydro-only steps (no radiation) from the JAX driver's state: the same
    steps in both packages, on a static or a moving mesh."""
    grid = _grid(300, 10)
    rng = np.random.default_rng(11)
    r = np.sqrt(((grid.generators - 0.5) ** 2).sum(1))
    nd = np.where(r < 0.15, 0.02, np.where(r < 0.25, 3.0, 1.0)) * 3.113e9
    T = np.where(r < 0.15, 1e4, 100.0)
    v = rng.normal(size=(grid.n_cells, 3)) * 1e4
    kwargs = _rhd_kwargs(48, n_photons=1, nloop=0, mesh_motion=mesh_motion)
    with jax.enable_x64(False):
        ref = jax_hydro.VoronoiRHDSimulation(to_jax_grid(grid), seed=1, **kwargs)
        ref.state = jax_hydro.conserved_from_primitives(
            *(jnp.asarray(np.asarray(a, np.float32))
              for a in (nd * MP, v[:, 0], v[:, 1], v[:, 2], nd * KB * T)), None, 1.0001)
        sim = voronoi_hydro.VoronoiRHDSimulation(grid, device="cpu", seed=1, **kwargs)
        arrays = {name: np.asarray(f) for name, f in zip(ref.state._fields, ref.state)}
        sim.load_reference_state({**arrays, "neutral_fraction": np.asarray(ref.neutral_fraction)},
                                 time=ref.time)
        ref.run(3)
        sim.run(3)
        assert ref.state.rho.dtype == jnp.float32
        m_ref = jax_hydro.total_mass(ref.state, ref.grid.volumes)
    assert sim.time == pytest.approx(ref.time)
    if mesh_motion:  # the generators followed the same fluid
        np.testing.assert_allclose(sim.grid.generators, ref.grid.generators, rtol=0, atol=1e-7)
    for name, a, b in zip(sim.state._fields, ref.state, sim.state):
        err = float(np.abs(np.asarray(a) - b.numpy()).max() / np.abs(np.asarray(a)).max())
        assert err <= 1e-5, (name, err)
    assert voronoi_hydro.total_mass(sim.state, sim.grid.volumes) == pytest.approx(m_ref, rel=1e-6)


def test_couple_matches_jax():
    grid = _grid(200, 12, num_lloyd=0)
    kwargs = _rhd_kwargs(48, n_photons=1, nloop=1)
    xh = np.random.default_rng(13).uniform(0.0, 1.0, grid.n_cells).astype(np.float32)
    with jax.enable_x64(False):
        ref = jax_hydro.VoronoiRHDSimulation(to_jax_grid(grid), seed=1, **kwargs)
        want = ref._couple(ref.state, jnp.asarray(xh))
    sim = voronoi_hydro.VoronoiRHDSimulation(grid, device="cpu", seed=1, **kwargs)
    got = sim._couple(sim.state, torch.tensor(xh))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-7)
    with pytest.raises(NotImplementedError, match="mesh"):
        voronoi_hydro.VoronoiRHDSimulation(grid, device="cpu", mesh=object(), **kwargs)
    with pytest.raises(NotImplementedError, match="restart"):
        sim.load_restart("checkpoint")


def test_dtype_expansion_through_both_packages():
    """test_dtype_expansion_on_voronoi's reduced starbench_voronoi, cut further
    (1500 generators without Lloyd iterations, 32 steps of 2 × 10000 packets,
    against its 3000, one Lloyd iteration and 48 steps of 4 × 20000) through
    both packages on one tessellation: the D-type front expands beyond the
    Strömgren radius inside the band, and the two fronts agree within Monte
    Carlo noise."""
    rng = np.random.default_rng(31)
    geometry = GridGeometry((-1.256 * PC,) * 3, (2.512 * PC,) * 3, (16,) * 3)
    grid = voronoi.build_voronoi_grid(geometry, rng.random((1500, 3)), num_lloyd=0)
    n_steps = 32
    kwargs = _rhd_kwargs(n_steps, n_photons=10000, nloop=2, seed=31)
    sim = voronoi_hydro.VoronoiRHDSimulation(grid, device="cpu", **kwargs)
    m0 = voronoi_hydro.total_mass(sim.state, grid.volumes)
    sim.run(n_steps)
    with jax.enable_x64(False):
        ref = jax_hydro.VoronoiRHDSimulation(to_jax_grid(grid), **kwargs)
        ref.run(n_steps)
        r_ref = ref.ionization_front_radius()
    n_h = 3.113e9
    r_st = (3.0 * 1e49 / (4.0 * np.pi * n_h**2 * 2.7e-19)) ** (1.0 / 3.0)
    r_front = sim.ionization_front_radius()
    assert r_front > r_st
    assert (0.6 * spitzer_radius(sim.time, r_st) < r_front
            < 1.5 * hosokawa_inutsuka_radius(sim.time, r_st))
    assert r_front == pytest.approx(r_ref, rel=0.05)
    assert voronoi_hydro.total_mass(sim.state, grid.volumes) == pytest.approx(m0, rel=1e-5)
