"""cmacionize_torch's moving-mesh Voronoi hydrodynamics and the Voronoi RHD
driver against the JAX package, on the CPU.

The plain flux update (K7's twin) and the least-squares gradients must agree
with ``_voronoi_flux_update`` / ``_lsq_gradients`` after one step, with the
same trial flags; a re-tessellated grid must equal the JAX package's; the
mirrors of the eight tests of tests/test_voronoi_hydro.py check the port's
own physics (the D-type mirror runs through both packages in
test_torch_voronoi_rhd.py).

XLA runs its CPU programs with subnormals flushed to zero and torch keeps
them, so the SI comparisons flush subnormals in torch too.  One test pins
the JAX function's underflow: with w = 1/|d|² in m⁻² the product w·Δρ
underflows f32, so every density gradient of a starbench-like state is 0
(and, flushed, every pressure gradient).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch.models import voronoi, voronoi_hydro
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.ops import riemann
from cmacionize_tpu.models import voronoi as jax_voronoi
from cmacionize_tpu.models import voronoi_hydro as jax_hydro
from cmacionize_tpu.models.grid import GridGeometry as JaxGridGeometry

GAMMA = 5.0 / 3.0
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


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _uniform_state(grid, rho0, p0, v0):
    C = grid.n_cells
    return voronoi_hydro.conserved_from_primitives(
        torch.full((C,), rho0), torch.full((C,), v0[0]), torch.full((C,), v0[1]),
        torch.full((C,), v0[2]), torch.full((C,), p0), grid.volumes, GAMMA)


# ------------------------------------------ parity with the JAX functions


@functools.lru_cache(maxsize=None)
def _grid(n, periodic, si, seed, num_lloyd=1):
    """One tessellation per set of arguments for the whole module (the
    tests only read a grid)."""
    rng = np.random.default_rng(seed)
    geometry = (GridGeometry((-1.256 * PC,) * 3, (2.512 * PC,) * 3, (8, 8, 8), periodic)
                if si else GridGeometry((0.0,) * 3, (1.0,) * 3, (8, 8, 8), periodic))
    return voronoi.build_voronoi_grid(geometry, rng.random((n, 3)), num_lloyd=num_lloyd)


def _shell_state(grid, si, seed):
    """A dense shell around a hot rarefied interior in cold gas, with random
    velocities (~1e4 m/s in SI), made with numpy: (rho, v [C,3], p)."""
    rng = np.random.default_rng(seed)
    r = np.sqrt(((grid.generators - 0.5) ** 2).sum(1))
    nd = np.where(r < 0.15, 0.02, np.where(r < 0.25, 3.0, 1.0)) * rng.uniform(0.98, 1.02, r.shape)
    T = np.where(r < 0.15, 1e4, 100.0)
    v = rng.normal(size=(len(r), 3)) * (1e4 if si else 0.1)
    if si:
        return nd * 3.113e9 * MP, v, nd * 3.113e9 * KB * T
    return nd, v, nd * T / 100.0


def _both_states(grid, si, seed, gamma):
    rho, v, p = _shell_state(grid, si, seed)
    f32 = [np.asarray(a, np.float32) for a in (rho, v[:, 0], v[:, 1], v[:, 2], p)]
    js = jax_hydro.conserved_from_primitives(*(jnp.asarray(a) for a in f32), None, gamma)
    ts = voronoi_hydro.conserved_from_primitives(*(torch.tensor(a) for a in f32), None, gamma)
    return js, ts


@pytest.mark.parametrize("si, periodic, second_order, dt, moving", [
    (False, (False, False, False), True, 2e-3, False),
    (False, (False, False, False), False, 2e-3, False),
    (False, (True, True, True), True, 4e-3, True),
    (True, (False, False, False), True, 2e10, False),
    (True, (False, False, False), False, 2e10, True),
    (True, (True, False, True), True, 2e10, True),
    (True, (False, False, False), True, 1.6e11, False),
])
def test_flux_update_matches_jax(flush_denormals, si, periodic, second_order, dt, moving):
    gamma = 1.0001 if si else (1.4 if moving else GAMMA)
    grid = _grid(500, periodic, si, 0)
    js, ts = _both_states(grid, si, 1, gamma)
    for j, t in zip(js, ts):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    rng = np.random.default_rng(2)
    vel = (rng.normal(size=(grid.n_cells, 3)) * (3e3 if si else 0.03) if moving
           else np.zeros((grid.n_cells, 3))).astype(np.float32)
    ref = jax_hydro.voronoi_hydro_step(to_jax_grid(grid), js, vel, dt, gamma,
                                       second_order=second_order)
    stats = {}
    tables = voronoi_hydro.hydro_tables(grid, "cpu")
    out = voronoi_hydro.voronoi_flux_update(
        *tables, ts, _t(vel), dt, gamma, second_order, stats=stats)
    moved = float(np.abs(np.asarray(ref.energy) - np.asarray(js.energy)).max()
                  / np.abs(np.asarray(js.energy)).max())
    assert moved > 1e-2  # the step really moves the state
    for name, a, b in zip(out._fields, ref, out):
        err = float(np.abs(np.asarray(a) - b.numpy()).max() / np.abs(np.asarray(a)).max())
        assert err <= 1e-5, (name, err)
    if dt == 1.6e11:
        # flagged cells take first-order faces: a different flag would move
        # them by the gap between the two orders, far above 1e-5
        assert int(stats["flag"].sum()) > 0


def test_lsq_gradients_match_jax(flush_denormals):
    grid = _grid(400, (False, False, False), False, 3, num_lloyd=0)
    rng = np.random.default_rng(4)
    W = (grid.generators @ np.array([2.0, -1.0, 0.5]) + rng.normal(size=grid.n_cells) * 0.1)
    W = W.astype(np.float32)
    nbr = grid.neighbors
    rel = voronoi_hydro.neighbor_offsets(grid)
    dW = W[np.maximum(nbr, 0)] - W[:, None]
    ref = np.asarray(jax_hydro._lsq_gradients(
        jnp.asarray(W), jnp.asarray(rel), jnp.asarray(nbr >= 0), jnp.asarray(dW)))
    got = voronoi_hydro._lsq_gradients(
        torch.tensor(W), torch.tensor(rel), torch.tensor(nbr >= 0), torch.tensor(dW)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


def test_lu_solve_matches_numpy():
    rng = np.random.default_rng(5)
    G = rng.normal(size=(200, 3, 3)).astype(np.float32)
    G[:10, 0, 0] = 0.0  # pivoting needed
    b = rng.normal(size=(200, 3)).astype(np.float32)
    got = voronoi_hydro.lu_solve3(torch.tensor(G), torch.tensor(b)).numpy()
    ref = np.linalg.solve(G.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("flush", [True, False])
def test_si_density_gradient_underflows_as_in_jax(flush):
    """w·Δρ ~ 1e-49 is below f32's subnormals: zero density gradients in every
    cell of a starbench-like state, as in JAX; w·Δp ~ 1e-43 is subnormal, kept
    by torch and the card unless flushed (XLA's CPU runtime flushes)."""
    if flush and not torch.set_flush_denormal(True):
        pytest.skip("this CPU cannot flush subnormals")
    try:
        grid = _grid(500, (False, False, False), True, 0)
        _, ts = _both_states(grid, True, 7, 1.0001)
        stats = {}
        voronoi_hydro.voronoi_flux_update(
            *voronoi_hydro.hydro_tables(grid, "cpu"), ts, torch.zeros(grid.n_cells, 3), 2e10,
            1.0001, stats=stats)
    finally:
        torch.set_flush_denormal(False)
    grads = stats["gradients"].abs().sum(-1) > 0  # [5, C]
    assert not bool(grads[0].any())  # density
    assert float(grads[1].double().mean()) > 0.5  # velocities (limited to 0 at extrema)
    share_p = float(grads[4].double().mean())
    assert share_p == 0.0 if flush else share_p > 0.5


def test_evolved_grid_equals_jax():
    grid = _grid(300, (True, False, False), False, 8)
    vel = np.random.default_rng(9).normal(size=(grid.n_cells, 3)).astype(np.float32) * 0.5
    port = voronoi_hydro.evolve_voronoi_grid(grid, vel, 0.02)
    ref = jax_hydro.evolve_voronoi_grid(to_jax_grid(grid), vel, 0.02)
    for name in TABLES:
        assert np.array_equal(getattr(port, name), getattr(ref, name)), name
    for fn in ("neighbor_offsets", "face_arms"):
        np.testing.assert_array_equal(getattr(voronoi_hydro, fn)(port),
                                      getattr(jax_hydro, fn)(ref))


# ------------------------------- mirrors of tests/test_voronoi_hydro.py


def test_uniform_advection_invariance_moving_mesh():
    geometry = GridGeometry((0.0,) * 3, (1.0,) * 3, (8, 8, 8), periodic=(True, True, True))
    grid = voronoi.build_voronoi_grid(
        geometry, np.random.default_rng(21).random((300, 3)), num_lloyd=1)
    rho0, p0, v0 = 1.0, 1.0, (0.3, 0.1, -0.05)
    state = _uniform_state(grid, rho0, p0, v0)
    vel = np.tile(np.asarray(v0, np.float32), (grid.n_cells, 1))
    m0 = voronoi_hydro.total_mass(state, grid.volumes)
    dt = 0.02
    for _ in range(5):
        state = voronoi_hydro.voronoi_hydro_step(grid, state, vel, dt, GAMMA)
        old_volumes = grid.volumes
        grid = voronoi_hydro.evolve_voronoi_grid(grid, vel, dt)
        state = voronoi_hydro.remap_after_evolve(state, old_volumes, grid.volumes)
    rho, vx, vy, vz, p = voronoi_hydro.primitives_from_conserved(state, None, GAMMA)
    assert voronoi_hydro.total_mass(state, grid.volumes) == pytest.approx(m0, rel=1e-5)
    assert float(torch.std(rho)) < 2e-3 * rho0
    assert float(torch.std(p)) < 5e-3 * p0
    np.testing.assert_allclose(vx.numpy(), v0[0], atol=2e-3)


def test_static_mesh_conservation_reflective_box():
    geometry = GridGeometry((0.0,) * 3, (1.0,) * 3, (8, 8, 8))
    grid = voronoi.build_voronoi_grid(
        geometry, np.random.default_rng(22).random((400, 3)), num_lloyd=1)
    r = np.linalg.norm(grid.generators - 0.5, axis=1)
    C = grid.n_cells
    zeros = torch.zeros(C)
    state = voronoi_hydro.conserved_from_primitives(
        torch.ones(C), zeros, zeros, zeros, _t(np.where(r < 0.2, 10.0, 1.0)),
        grid.volumes, GAMMA)
    vel = np.zeros((C, 3), np.float32)
    m0 = voronoi_hydro.total_mass(state, grid.volumes)
    vols = np.asarray(grid.volumes, np.float64)
    e0 = float((state.energy.double().numpy() * vols).sum())
    tables = voronoi_hydro.hydro_tables(grid, "cpu")
    for _ in range(20):
        state = voronoi_hydro.voronoi_hydro_step(grid, state, vel, 0.005, GAMMA, tables=tables)
    assert voronoi_hydro.total_mass(state, grid.volumes) == pytest.approx(m0, rel=1e-5)
    assert float((state.energy.double().numpy() * vols).sum()) == pytest.approx(e0, rel=1e-4)
    assert bool(torch.isfinite(state.rho).all())
    inner = r < 0.2
    m_inner = float((state.rho.double().numpy()[inner] * vols[inner]).sum())
    assert m_inner < m0 * inner.mean()  # the blast pushed mass outward


def test_sod_tube_on_voronoi_matches_exact():
    """The JAX test's Sod tube on 32 × 8 × 8 perturbed generators without a
    Lloyd iteration (its 48 × 12 × 12 with one, cut) and steps of 0.004: the
    density within 0.05 in L1 of the exact solution (0.031 at this size)."""
    geometry = GridGeometry((0.0,) * 3, (1.0, 0.25, 0.25), (32, 8, 8))
    rng = np.random.default_rng(23)
    gens = voronoi.perturbed_cartesian_generators((32, 8, 8), 0.2, rng)
    grid = voronoi.build_voronoi_grid(geometry, gens, num_lloyd=0)
    x = grid.generators[:, 0] * grid.scale  # anchor is 0
    C = grid.n_cells
    left = x < 0.5
    zeros = torch.zeros(C)
    state = voronoi_hydro.conserved_from_primitives(
        _t(np.where(left, 1.0, 0.125)), zeros, zeros, zeros, _t(np.where(left, 1.0, 0.1)),
        grid.volumes, GAMMA)
    vel = torch.zeros(C, 3)
    tables = voronoi_hydro.hydro_tables(grid, "cpu")
    t_end, dt = 0.2, 0.004
    for _ in range(round(t_end / dt)):
        state = voronoi_hydro.voronoi_hydro_step(grid, state, vel, dt, GAMMA, tables=tables)
    rho = state.rho.numpy()
    one = [torch.tensor(v) for v in (1.0, 0.0, 1.0, 0.125, 0.0, 0.1)]
    rho_ex = riemann.exact_sample(*one, _t((x - 0.5) / t_end), gamma=GAMMA)[0].numpy()
    sel = (x > 0.05) & (x < 0.95)
    l1 = float(np.abs(rho[sel] - rho_ex[sel]).mean())
    assert l1 < 0.05, f"Sod-on-Voronoi L1 density error {l1}"


def test_face_areas_close_cells():
    geometry = GridGeometry((0.0,) * 3, (1.0,) * 3, (8, 8, 8))
    grid = voronoi.build_voronoi_grid(
        geometry, np.random.default_rng(24).random((200, 3)), num_lloyd=2)
    valid = grid.neighbors != -2
    closure = np.einsum("ck,ckd->cd", grid.areas * valid, grid.normals)
    assert np.abs(closure).max() / np.asarray(grid.areas).sum(1).mean() < 1e-3


def test_astronomical_scale_no_f32_overflow():
    geometry = GridGeometry((-1.256 * PC,) * 3, (2.512 * PC,) * 3, (8, 8, 8))
    grid = voronoi.build_voronoi_grid(
        geometry, np.random.default_rng(30).random((300, 3)), num_lloyd=1)
    C = grid.n_cells
    zeros = torch.zeros(C)
    state = voronoi_hydro.conserved_from_primitives(
        torch.full((C,), 3.113e9 * MP), zeros, zeros, zeros,
        torch.full((C,), 3.113e9 * KB * 100.0), grid.volumes, 1.0001)
    assert bool(torch.isfinite(state.energy).all())
    state = voronoi_hydro.voronoi_hydro_step(grid, state, np.zeros((C, 3), np.float32), 1e9,
                                             1.0001)
    assert bool(torch.isfinite(state.rho).all()) and bool(torch.isfinite(state.energy).all())
    np.testing.assert_allclose(state.rho.numpy() / MP, 3.113e9, rtol=1e-4)


def test_second_order_gradients_exact_on_linear_field():
    rng = np.random.default_rng(8)
    L = 1.0e16
    geom = GridGeometry((0.0,) * 3, (L, L, L), (1, 1, 1))
    grid = voronoi.build_voronoi_grid(geom, rng.uniform(0.05, 0.95, (400, 3)))
    g_si = np.asarray(grid.generators, np.float64) * grid.scale
    grad_true = np.array([2.0e-16, -1.0e-16, 5.0e-17])
    W = _t(g_si @ grad_true)
    nbr = torch.tensor(grid.neighbors)
    rel = torch.tensor(voronoi_hydro.neighbor_offsets(grid))
    dW = W[torch.clamp_min(nbr, 0).long()] - W[:, None]
    grads = voronoi_hydro._lsq_gradients(W, rel, nbr >= 0, dW).numpy()
    interior = ~np.any(grid.neighbors == -1, axis=1)
    assert interior.sum() > 50
    np.testing.assert_allclose(grads[interior], np.tile(grad_true, (int(interior.sum()), 1)),
                               rtol=2e-3, atol=2e-20)


def test_second_order_sharper_than_first_order_sod():
    rng = np.random.default_rng(4)
    geom = GridGeometry((0.0,) * 3, (1.0,) * 3, (1, 1, 1))
    nx = 16
    base = (np.indices((nx, 4, 4)).reshape(3, -1).T + 0.5) / np.array([nx, 4, 4])
    pts = base + rng.uniform(-0.1, 0.1, base.shape) / np.array([nx, 4, 4])
    grid = voronoi.build_voronoi_grid(geom, np.clip(pts, 0.02, 0.98))
    left = grid.generators[:, 0] * grid.scale < 0.5
    C = grid.n_cells
    zeros = torch.zeros(C)
    state0 = voronoi_hydro.conserved_from_primitives(
        _t(np.where(left, 1.0, 0.125)), zeros, zeros, zeros, _t(np.where(left, 1.0, 0.1)),
        grid.volumes, 1.4)
    tables = voronoi_hydro.hydro_tables(grid, "cpu")

    def run(second_order):
        s = state0
        for _ in range(40):
            s = voronoi_hydro.voronoi_hydro_step(grid, s, torch.zeros(C, 3), 0.002, 1.4,
                                                 second_order=second_order, tables=tables)
        return s

    s2, s1 = run(True), run(False)
    assert bool(torch.isfinite(s2.rho).all()) and float(s2.rho.min()) > 0

    def smeared_fraction(s):
        rho = s.rho.numpy()
        return np.mean((rho > 0.15) & (rho < 0.9))

    assert smeared_fraction(s2) <= smeared_fraction(s1) + 1e-9


def test_state_helpers_match_jax():
    grid = _grid(100, (False, False, False), True, 14, num_lloyd=0)
    js, ts = _both_states(grid, True, 15, 1.0001)
    for a, b in zip(jax_hydro.primitives_from_conserved(js, None, 1.0001),
                    voronoi_hydro.primitives_from_conserved(ts, None, 1.0001)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    new_volumes = grid.volumes * np.random.default_rng(16).uniform(0.9, 1.1, grid.n_cells)
    for a, b in zip(jax_hydro.remap_after_evolve(js, grid.volumes, new_volumes),
                    voronoi_hydro.remap_after_evolve(ts, grid.volumes, new_volumes)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(
        voronoi_hydro.grid_velocity_from_fluid(grid, ts, 1.0001),
        jax_hydro.grid_velocity_from_fluid(to_jax_grid(grid), js, 1.0001))
