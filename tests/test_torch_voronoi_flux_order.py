"""The premises of K7's redesign (``csrc/voronoi_flux.cu``), on the CPU.

K7 runs a thread per face slot and sums each cell's face products from face 0
in face order, as the plain version (``voronoi_flux_update_reference``) and
the JAX function (``_voronoi_flux_update``) do.  Two choices rest on what
these tests show on small grids:

- the update keeps the trial's sums on every row with no first-order face:
  on the faces that touch no flagged cell, the plain update's second-order
  products equal the trial's bit for bit (the same arithmetic on the same
  inputs), while the faces that touch a flagged cell take first-order ones;
- K7 keeps the padding slots: summed only to each row's last real face
  (``VoronoiTables.face_count``) the sums keep their bits on these grids,
  but not in general: a padding product is flux * +0, and +0.0 added to a
  -0.0 sum makes it +0.0, which a -0.0 state then shows.

The plain update is also held to JAX's after the same step, so the products
are the function's and not only the port's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch.models import voronoi, voronoi_hydro
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_tpu.models import voronoi as jax_voronoi
from cmacionize_tpu.models import voronoi_hydro as jax_hydro
from cmacionize_tpu.models.grid import GridGeometry as JaxGridGeometry

PC = 3.086e16
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


@functools.lru_cache(maxsize=None)
def _grid(si):
    rng = np.random.default_rng(0)
    geometry = (GridGeometry((-1.256 * PC,) * 3, (2.512 * PC,) * 3, (8, 8, 8))
                if si else GridGeometry((0.0,) * 3, (1.0,) * 3, (8, 8, 8)))
    return voronoi.build_voronoi_grid(geometry, rng.random((500, 3)), num_lloyd=1)


def _state(grid, kind, si):
    """A dense shell round a hot rarefied interior with random velocities
    (~1e4 m/s in SI), or uniform gas at rest; f32 arrays (rho, vx, vy, vz,
    p) made with numpy."""
    C = grid.n_cells
    if kind == "rest":
        rho, v, T = np.ones(C), np.zeros((C, 3)), np.full(C, 100.0)
    else:
        rng = np.random.default_rng(1)
        r = np.sqrt(((grid.generators - 0.5) ** 2).sum(1))
        rho = np.where(r < 0.15, 0.02, np.where(r < 0.25, 3.0, 1.0)) * rng.uniform(0.98, 1.02, C)
        T = np.where(r < 0.15, 1e4, 100.0)
        v = rng.normal(size=(C, 3)) * (1e4 if si else 0.1)
    p = rho * 3.113e9 * KB * T if si else rho * T / 100.0
    rho = rho * 3.113e9 * MP if si else rho
    return [np.asarray(a, np.float32) for a in (rho, v[:, 0], v[:, 1], v[:, 2], p)]


def _update(grid, kind, si, dt, second_order=True):
    gamma = 1.0001 if si else 5.0 / 3.0
    state = voronoi_hydro.conserved_from_primitives(
        *(torch.tensor(a) for a in _state(grid, kind, si)), None, gamma)
    tables = voronoi_hydro.hydro_tables(grid, "cpu")
    stats = {}
    out = voronoi_hydro.voronoi_flux_update_reference(
        *tables, state, torch.zeros((grid.n_cells, 3)), dt, gamma, second_order, stats=stats)
    return tables, state, out, stats


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("dt", [1.6e11, 1.6e12])
def test_update_keeps_the_trial_products_on_faces_that_touch_no_flagged_cell(dt):
    grid = _grid(True)
    tables, _, _, stats = _update(grid, "shell", True, dt)
    flag, nbr = stats["flag"], tables.neighbors
    assert int(flag.sum()) > 0  # some rows take first-order faces
    first_order = flag[:, None] | ((nbr >= 0) & flag[nbr.clamp_min(0).long()])
    trial, final = stats["trial_products"], stats["products"]
    assert torch.equal(_bits(trial[~first_order]), _bits(final[~first_order]))
    assert not torch.equal(_bits(trial[first_order]), _bits(final[first_order]))
    # a row with no first-order face: its sums, and so its new state, are the trial's
    clean = ~first_order.any(1)
    assert 0 < int(clean.sum()) < grid.n_cells
    for q in range(5):
        acc_trial, acc_final = trial[:, 0, q], final[:, 0, q]
        for k in range(1, nbr.shape[1]):
            acc_trial, acc_final = acc_trial + trial[:, k, q], acc_final + final[:, k, q]
        assert torch.equal(_bits(acc_trial[clean]), _bits(acc_final[clean]))


def test_the_plain_update_is_jax_s_on_that_step():
    """The products above are the function's: the plain update of the same
    state equals JAX's _voronoi_flux_update within f32 round-off, with the
    same trial flags (JAX in f32, subnormals flushed as XLA's CPU runtime
    does)."""
    grid = _grid(True)
    gamma, dt = 1.0001, 1.6e12
    arrays = _state(grid, "shell", True)
    js = jax_hydro.conserved_from_primitives(*(jnp.asarray(a) for a in arrays), None, gamma)
    g = grid.geometry
    jgrid = jax_voronoi.VoronoiGrid(
        geometry=JaxGridGeometry(g.anchor, g.sides, g.shape, g.periodic), scale=grid.scale,
        **{name: getattr(grid, name) for name in TABLES})
    with jax.enable_x64(False):
        ref = jax_hydro.voronoi_hydro_step(jgrid, js, np.zeros((grid.n_cells, 3), np.float32),
                                           dt, gamma)
    if not torch.set_flush_denormal(True):
        pytest.skip("this CPU cannot flush subnormals")
    try:
        _, _, out, stats = _update(grid, "shell", True, dt)
    finally:
        torch.set_flush_denormal(False)
    assert int(stats["flag"].sum()) > 0
    for a, b in zip(ref, out):
        a = np.asarray(a, np.float64)
        assert np.abs(a - b.double().numpy()).max() <= 1e-5 * np.abs(a).max()


@pytest.mark.parametrize("si, kind, dt, second_order", [
    (True, "shell", 2e10, True), (True, "shell", 1.6e12, True), (True, "shell", 2e10, False),
    (False, "shell", 2e-3, True), (False, "rest", 2e-3, True), (True, "rest", 2e10, False),
])
def test_sums_to_the_face_count_keep_their_bits_on_these_grids(si, kind, dt, second_order):
    grid = _grid(si)
    tables, state, out, stats = _update(grid, kind, si, dt, second_order)
    count = torch.tensor(voronoi.packed_faces(grid.neighbors, grid.normals, grid.offsets)[1],
                         dtype=torch.int64)
    real = tables.neighbors != -2
    assert bool((real.sum(1) == count).all())  # the padding is trailing on these rows
    x = stats["products"]
    every, to_count = x[:, 0], x[:, 0].clone()
    for k in range(1, x.shape[1]):
        every = every + x[:, k]
        to_count = torch.where((k < count)[:, None], to_count + x[:, k], to_count)
    assert torch.equal(_bits(every), _bits(to_count))
    # the padding's products are signed zeros, and the sums are the update's
    assert bool((x[~real] == 0).all())
    assert torch.equal(_bits(state.rho + -every[:, 0]), _bits(out.rho))
    assert torch.equal(_bits(state.energy + -every[:, 4]), _bits(out.energy))


def test_a_padding_product_can_change_the_bits_of_a_sum():
    """Why K7 keeps the padding: on a row whose real products are -0.0 (a
    momentum flux of a cell at rest can be), the plain sum over all K slots
    adds the padding's +0.0 and ends at +0.0; stopped at the count it stays
    -0.0, and a momentum of -0.0 then updates to +0.0 or to -0.0."""
    products = torch.tensor([[-0.0, -0.0, -0.0, 0.0, 0.0]])  # 3 real faces, 2 padding slots
    every = voronoi_hydro._ksum(products)
    to_count = voronoi_hydro._ksum(products[:, :3])
    momentum = torch.tensor([-0.0])
    assert _bits(every).item() == 0 and _bits(to_count).item() == -2**31
    assert _bits(momentum + -every).item() == -2**31
    assert _bits(momentum + -to_count).item() == 0
