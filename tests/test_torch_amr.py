"""cmacionize_torch's AMR grids, octree marches and AMR drivers against the
JAX package, on the CPU.

The host construction must give the JAX package's hierarchy and octree
tables; the plain octree marches and the leaf descent must repeat the JAX
functions bit for bit on shared packets; ``trace_amr`` / ``trace_amr_spectral``
must agree with JAX on both the dense and the octree path; one driver
iteration from the JAX driver's state must agree with JAX given the same
tally; mirrors of tests/test_amr.py and of TestMultiFreqAMR
(tests/test_multifreq_grids.py) check the port's own physics.  The Monte
Carlo streams of the two packages differ, so those runs are checked against
analytic volumes or structure, not against JAX runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cmacionize_torch.models import amr
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.ops import amr_traversal, traversal
from cmacionize_torch.utils.params import ParameterFile
from cmacionize_tpu.models import amr as jax_amr
from cmacionize_tpu.models.grid import GridGeometry as JaxGridGeometry
from cmacionize_tpu.ops import amr_traversal as jax_amr_traversal
from cmacionize_tpu.ops import traversal as jax_traversal

BOX = 1.0e17  # m
PC = 3.086e16
ABUND = {"He": 0.1, "C": 2.2e-4, "N": 4e-5, "O": 3.3e-4, "Ne": 5e-5, "S": 9e-6}
FIELDS = ("levels", "centers", "volumes", "owner")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _geom(n=8):
    return GridGeometry((0.0, 0.0, 0.0), (BOX, BOX, BOX), (n, n, n))


def _uniform_density(value):
    return lambda pos: np.full(len(pos), value)


def _jax_scheme(scheme):
    """The JAX package's refinement scheme of the same type and fields."""
    if scheme is None or not dataclasses.is_dataclass(scheme):
        return scheme
    return getattr(jax_amr, type(scheme).__name__)(**dataclasses.asdict(scheme))


def _both_grids(n, scheme, density_fn, max_level, fractions_fn=None):
    port = amr.build_amr_grid(_geom(n), scheme, density_fn, max_level=max_level,
                              fractions_fn=fractions_fn)
    ref = jax_amr.build_amr_grid(
        JaxGridGeometry((0.0, 0.0, 0.0), (BOX,) * 3, (n, n, n)), _jax_scheme(scheme),
        density_fn, max_level=max_level, fractions_fn=fractions_fn)
    return port, ref


def _refined_grid(n=8, max_level=2):
    scheme = amr.SpatialRefinement(
        zone_anchor=(0.0, 0.0, 0.0), zone_sides=(BOX / 2,) * 3, max_level=max_level)
    return amr.build_amr_grid(_geom(n), scheme, _uniform_density(1.0e8), max_level=max_level)


def _jax_grid(grid):
    """The JAX package's AMRGrid holding the port grid's fields."""
    g = grid.geometry
    fields = {f.name: getattr(grid, f.name) for f in dataclasses.fields(grid)}
    fields["geometry"] = JaxGridGeometry(g.anchor, g.sides, g.shape, g.periodic)
    return jax_amr.AMRGrid(**fields)


# ---------------------------------------------------------- construction


def _fracs_oi(pos):
    on = (pos[:, 0] > BOX / 2).astype(float) * 0.5 + 0.25
    return {"O_n": on, "O_p1": 1.0 - on}


class _FarCornerChain:
    """Refine only the cell touching the far box corner at each level: a
    depth-10 chain with O(levels) leaves (tests/test_amr.py)."""

    max_level = 10

    def refine(self, level, centers, volume, nd, fractions):
        if level >= self.max_level:
            return np.zeros(len(centers), bool)
        size = BOX / 16 / (2**level)
        return np.all(centers > BOX - size, axis=1)


CONSTRUCTION_CASES = {
    "none": (4, None, _uniform_density(1.0e8), 2, None),
    "spatial": (4, amr.SpatialRefinement((0.0,) * 3, (BOX / 2,) * 3, 1),
                _uniform_density(1.0e8), 1, None),
    "mass": (2, amr.MassRefinement(target_npart=(BOX / 2) ** 3 / 100.0, max_level=2),
             _uniform_density(1.0), 2, None),
    "spatial-slab": (4, amr.SpatialRefinement((0.0,) * 3, (BOX / 4, BOX, BOX), 2),
                     _uniform_density(1.0), 2, None),
    "opacity-ionized": (2, amr.OpacityRefinement(target_opacity=1e-18, max_level=1),
                        _uniform_density(1.0e10), 1,
                        lambda pos: {"H_n": np.zeros(len(pos))}),
    "opacity-neutral": (2, amr.OpacityRefinement(target_opacity=1e-18, max_level=1),
                        _uniform_density(1.0e10), 1, None),
    "oi": (4, amr.OIRefinement(target_n_oi=1.0, max_level=1), _uniform_density(1.0e8), 1,
           _fracs_oi),
    "cmacionize": (2, amr.CMacIonizeRefinement(max_level=1),
                   lambda pos: np.where(pos[:, 0] < BOX / 2, -1.0, 1.0e8), 1, None),
    "deep-level5": (16, amr.SpatialRefinement((0.0,) * 3, (BOX / 16,) * 3, 5),
                    _uniform_density(1.0e8), 5, None),
    "far-corner-level10": (16, _FarCornerChain(), _uniform_density(1.0), 10, None),
}


@pytest.mark.parametrize("case", sorted(CONSTRUCTION_CASES))
def test_hierarchy_and_octree_equal_jax(case):
    n, scheme, density_fn, max_level, fractions_fn = CONSTRUCTION_CASES[case]
    port, ref = _both_grids(n, scheme, density_fn, max_level, fractions_fn)
    assert (port.n_cells, port.max_level) == (ref.n_cells, ref.max_level)
    for name in FIELDS:
        a, b = getattr(port, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("leaf_coords", "refined_coords"):
        for a, b in zip(getattr(port, name), getattr(ref, name), strict=True):
            assert np.array_equal(a, b), name
    for a, b in zip(port.octree(), ref.octree(), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_allclose(port.volumes.sum(), BOX**3, rtol=1e-9)


def test_construction_mirrors():
    """tests/test_amr.py::TestConstruction on the port's grids."""
    g = amr.build_amr_grid(_geom(4), *CONSTRUCTION_CASES["spatial"][1:3], max_level=1)
    assert g.n_cells == (4**3 - 2**3) + 2**3 * 8
    in_zone = np.all(g.centers < BOX / 2, axis=1)
    assert (g.levels[in_zone] == 1).all() and (g.levels[~in_zone] == 0).all()
    g = amr.build_amr_grid(_geom(4), *CONSTRUCTION_CASES["spatial-slab"][1:3], max_level=2)
    counts = np.bincount(g.owner.ravel(), minlength=g.n_cells)
    np.testing.assert_array_equal(counts, (4 // 2 ** g.levels.astype(int)) ** 3)
    root, children = _refined_grid().octree()
    enc = np.concatenate([root, children.ravel()])
    assert sorted((-(enc[enc < 0]) - 1).tolist()) == list(range(_refined_grid().n_cells))


@pytest.mark.parametrize("stype, cls", [
    ("Mass", amr.MassRefinement), ("Opacity", amr.OpacityRefinement),
    ("Spatial", amr.SpatialRefinement), ("OI", amr.OIRefinement),
    ("CMacIonize", amr.CMacIonizeRefinement), ("None", type(None)),
])
def test_all_reference_type_strings(stype, cls, tmp_path):
    yml = tmp_path / "p.yml"
    yml.write_text(
        "DensityGrid:\n  AMRRefinementScheme:\n"
        f"    type: {stype}\n"
        "    zone anchor: [0. m, 0. m, 0. m]\n"
        "    zone sides: [1. m, 2. m, 3. m]\n"
        "    maximum refinement level: 3\n")
    scheme = amr.refinement_scheme_from_params(ParameterFile(str(yml)))
    assert isinstance(scheme, cls)
    if stype == "Spatial":
        assert scheme == amr.SpatialRefinement((0.0, 0.0, 0.0), (1.0, 2.0, 3.0), 3)


# --------------------------------------------------- marches against JAX


def _march_inputs(grid, seed, P=20000, spectral=False, n_bins=6):
    """χ per coarse unit per leaf and packets in coarse units, a quarter of
    them on walls of the finest lattice, made with numpy."""
    rng = np.random.default_rng(seed)
    n = grid.geometry.shape[0]
    C = grid.n_cells
    d = rng.normal(size=(P, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    pos = rng.uniform(0.5, n - 0.5, (P, 3)).astype(np.float32)
    pos[: P // 4] = np.round(pos[: P // 4] * 4) / 4
    tau = (-np.log1p(-rng.random(P)) * 3).astype(np.float32)
    w = rng.uniform(0.5, 1.5, P).astype(np.float32)
    cols = [pos[:, 0], pos[:, 1], pos[:, 2], *([np.zeros(P, np.int32)] * 3),
            d[:, 0], d[:, 1], d[:, 2], tau, w]
    if not spectral:
        chi = (10 ** rng.uniform(-1.5, 0.5, C)).astype(np.float32)
        return (chi,), cols + [np.ones(P, bool), np.zeros(P, bool)]
    chi_h = (10 ** rng.uniform(20.5, 22.5, C)).astype(np.float32)
    chi_he = (10 ** rng.uniform(19.5, 21.5, C)).astype(np.float32)
    cols += [rng.uniform(0.5e-22, 6.3e-22, P).astype(np.float32),
             rng.uniform(0.0, 7e-22, P).astype(np.float32),
             rng.integers(0, n_bins, P).astype(np.int32),
             np.arange(P) % 5 != 0, np.zeros(P, bool)]  # a re-emission mask
    return (chi_h, chi_he), cols


def _assert_batches_equal(out_t, out_j):
    for name in ("px", "py", "pz", "tau_left", "active", "absorbed"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                      np.asarray(getattr(out_j, name)), err_msg=name)


@pytest.mark.parametrize("n, max_level", [(8, 2), (16, 3)])
def test_octree_march_matches_jax_bit_for_bit(n, max_level):
    grid = _refined_grid(n, max_level)
    root, children = grid.octree()
    (chi,), cols = _march_inputs(grid, n, P=20000 if n == 8 else 6000)
    shape, C = grid.geometry.shape, grid.n_cells
    tally_j, out_j = jax_amr_traversal.trace_packets_octree(
        jnp.asarray(root), jnp.asarray(children), jnp.asarray(chi),
        jax_traversal.PacketBatch(*(jnp.asarray(c) for c in cols)),
        jnp.zeros(C, jnp.float32), coarse_shape=shape, max_level=max_level)
    stats = {}
    tally_t, out_t = amr_traversal.trace_packets_octree_reference(
        torch.tensor(root), torch.tensor(children), torch.tensor(chi),
        traversal.PacketBatch(*(torch.tensor(c) for c in cols)), torch.zeros(C),
        coarse_shape=shape, max_level=max_level, stats=stats)
    n_abs = int(np.asarray(out_j.absorbed).sum())
    assert 0 < n_abs < len(cols[0])
    _assert_batches_equal(out_t, out_j)
    np.testing.assert_array_equal(tally_t.numpy(), np.asarray(tally_j))
    assert int(stats["packet_steps"]) > len(cols[0]) and int(stats["descent_levels"]) > 0


def test_spectral_octree_march_matches_jax_bit_for_bit():
    grid = _refined_grid()
    root, children = grid.octree()
    n_bins = 6
    (chi_h, chi_he), cols = _march_inputs(grid, 3, spectral=True, n_bins=n_bins)
    shape, C = grid.geometry.shape, grid.n_cells
    tally_j, out_j = jax_amr_traversal.trace_packets_octree_spectral(
        jnp.asarray(root), jnp.asarray(children), jnp.asarray(chi_h), jnp.asarray(chi_he),
        jax_traversal.SpectralPacketBatch(*(jnp.asarray(c) for c in cols)),
        jnp.zeros(n_bins * C, jnp.float32), coarse_shape=shape, max_level=2, n_bins=n_bins)
    batch = traversal.SpectralPacketBatch(*(torch.tensor(c) for c in cols))
    tally_t, out_t = amr_traversal.trace_packets_octree_spectral(
        torch.tensor(root), torch.tensor(children), torch.tensor(chi_h), torch.tensor(chi_he),
        batch, torch.zeros(n_bins * C), coarse_shape=shape, max_level=2, n_bins=n_bins)
    assert int(np.asarray(out_j.absorbed).sum()) > 0
    _assert_batches_equal(out_t, out_j)
    np.testing.assert_array_equal(tally_t.numpy(), np.asarray(tally_j))
    frozen = ~batch.active
    assert torch.equal(out_t.px[frozen], batch.px[frozen])


def test_leaf_of_positions_matches_jax():
    grid = _refined_grid()
    root, children = grid.octree()
    rng = np.random.default_rng(4)
    q = rng.uniform(-0.2, 8.2, (20000, 3)).astype(np.float32)
    q[:5000] = np.round(q[:5000] * 8) / 8  # on walls of the finest lattice
    ref = jax_amr_traversal.leaf_of_positions(
        jnp.asarray(root), jnp.asarray(children), *(jnp.asarray(q[:, i]) for i in range(3)),
        coarse_shape=(8, 8, 8), max_level=2)
    stats = {}
    leaf = amr_traversal.leaf_of_positions_reference(
        torch.tensor(root), torch.tensor(children), *(torch.tensor(q[:, i]) for i in range(3)),
        coarse_shape=(8, 8, 8), max_level=2, stats=stats)
    assert leaf.dtype == torch.int32
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref))
    assert torch.equal(leaf, amr_traversal.leaf_of_positions(
        torch.tensor(root), torch.tensor(children), *(torch.tensor(q[:, i]) for i in range(3)),
        coarse_shape=(8, 8, 8), max_level=2))
    assert 0 < int(stats["descent_levels"]) <= 2 * len(q)


def test_nudge_rounding_matches_jax():
    """Inputs on which a fused and an unfused nudge p + eps·d round apart:
    a packet on the wall x = 1 moving back at a grazing angle (the unfused
    nudge stays on the wall, and JAX stalls the packet there), and one whose
    inside test at y = 8 - 2⁻²¹ keeps it in the box only if fused.  The plain
    version must follow JAX in both."""
    grid = _refined_grid()
    root, children = grid.octree()
    eps = np.float32(amr_traversal.wall_eps((8, 8, 8), 2))
    assert eps == np.float32(2.5e-4)
    # dx·eps lies just beyond -2⁻²⁵, dy·eps just below 2⁻²²: found by exact
    # rational search, so that 1 + dx·eps and 8 - 2⁻²¹ + dy·eps round apart
    dx, dy = np.float32(-0.00011920929), np.float32(0.00095367426)
    pos = np.array([[1.0, 6.3, 6.55], [3.0 - 1e-3, 7.9999986, 6.55]], np.float32)
    d = np.array([[dx, 1.0, 0.0], [1.0, dy, 0.0]], np.float32)
    cols = [pos[:, 0], pos[:, 1], pos[:, 2], *([np.zeros(2, np.int32)] * 3),
            d[:, 0], d[:, 1], d[:, 2], np.full(2, 1e3, np.float32), np.ones(2, np.float32),
            np.ones(2, bool), np.zeros(2, bool)]
    chi = np.full(grid.n_cells, 1e-3, np.float32)
    _, out_j = jax_amr_traversal.trace_packets_octree(
        jnp.asarray(root), jnp.asarray(children), jnp.asarray(chi),
        jax_traversal.PacketBatch(*(jnp.asarray(c) for c in cols)),
        jnp.zeros(grid.n_cells, jnp.float32), coarse_shape=(8, 8, 8), max_level=2,
        max_steps=2)
    _, out_t = amr_traversal.trace_packets_octree(
        torch.tensor(root), torch.tensor(children), torch.tensor(chi),
        traversal.PacketBatch(*(torch.tensor(c) for c in cols)), torch.zeros(grid.n_cells),
        coarse_shape=(8, 8, 8), max_level=2, max_steps=2)
    _assert_batches_equal(out_t, out_j)
    assert out_t.active.tolist() == [True, False]
    assert out_t.px[0] == 1.0 and out_t.py[1] == np.float32(8.0) - np.float32(2.0**-21)


def test_deep_level10_walls_do_not_stall():
    """tests/test_amr.py::test_deep_level10_walls_do_not_stall on the plain
    octree march: every packet of the far-corner chain terminates well
    inside the step cap."""
    g = amr.build_amr_grid(_geom(16), _FarCornerChain(), _uniform_density(1.0), max_level=10)
    assert int(g.levels.max()) == 10
    root, children = g.octree()
    rng = np.random.default_rng(1)
    n = 2048
    d = rng.normal(size=(n, 3))
    d = torch.tensor((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    pos = torch.full((n, 3), 15.95) + 1e-4 * d  # inside the deep-refined far corner
    tau = torch.tensor((-np.log1p(-rng.random(n))).astype(np.float32))
    pk = traversal.make_packets(pos, d, tau, torch.ones(n), (16, 16, 16))
    _, out = amr_traversal.trace_packets_octree(
        torch.tensor(root), torch.tensor(children), torch.full((g.n_cells,), 0.05), pk,
        torch.zeros(g.n_cells), coarse_shape=(16, 16, 16), max_level=10, max_steps=4000)
    assert int(out.active.sum()) == 0
    assert 0 < int(out.absorbed.sum()) < n


# ------------------------------------------- trace_amr(_spectral) vs JAX


def _fine_packets(grid, seed, n, spectral=False, n_bins=6):
    """Packets from 0.6·BOX in finest-lattice units (numpy), as
    ``(port batch, JAX batch)``."""
    rng = np.random.default_rng(seed)
    gpos = (np.full(3, 0.6 * BOX) - np.asarray(grid.geometry.anchor)) / grid.fine_cell_size
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    pos = (gpos[None, :] + 1e-4 * d).astype(np.float32)
    tau = (-np.log1p(-rng.random(n))).astype(np.float32)
    w = np.ones(n, np.float32)
    if not spectral:
        return (traversal.make_packets(*(torch.tensor(a) for a in (pos, d, tau, w)),
                                       grid.fine_shape),
                jax_traversal.make_packets(*(jnp.asarray(a) for a in (pos, d, tau, w)),
                                           grid.fine_shape))
    fbin = rng.integers(0, n_bins, n).astype(np.int32)
    sig_h = (6.3e-22 * (1.0 + 0.2 * fbin)).astype(np.float32)
    sig_he = (7.0e-22 * (1.0 - 0.1 * fbin)).astype(np.float32)
    arrays = (pos, d, tau, w, sig_h, sig_he, fbin)
    return (traversal.make_spectral_packets(*(torch.tensor(a) for a in arrays), grid.fine_shape),
            jax_traversal.make_spectral_packets(*(jnp.asarray(a) for a in arrays),
                                                grid.fine_shape))


@pytest.mark.parametrize("deep", [False, True])
def test_trace_amr_matches_jax(deep):
    grid = _refined_grid()
    if deep:
        grid = dataclasses.replace(grid, owner=None)  # force the octree path
    chi_si = (10 ** np.random.default_rng(5).uniform(-17.5, -16.5, grid.n_cells)).astype(
        np.float32)
    pk_t, pk_j = _fine_packets(grid, 9, 20000)
    tally_j, esc_j = jax_amr.trace_amr(_jax_grid(grid), jnp.asarray(chi_si), pk_j)
    tally_t, esc_t = amr.trace_amr(grid, torch.tensor(chi_si), pk_t)
    assert int(esc_t) == int(esc_j) and 0 < int(esc_t) < 20000
    if deep:
        np.testing.assert_array_equal(tally_t.numpy(), np.asarray(tally_j))
    else:  # JAX marches the fine lattice in its blocked layout
        np.testing.assert_allclose(tally_t.numpy(), np.asarray(tally_j), rtol=1e-5,
                                   atol=1e-6 * float(np.asarray(tally_j).max()))


@pytest.mark.parametrize("deep", [False, True])
def test_trace_amr_spectral_matches_jax(deep):
    grid = _refined_grid()
    if deep:
        grid = dataclasses.replace(grid, owner=None)
    rng = np.random.default_rng(7)
    chi_h = (10 ** rng.uniform(4.5, 5.5, grid.n_cells)).astype(np.float32)
    chi_he = (10 ** rng.uniform(3.5, 4.5, grid.n_cells)).astype(np.float32)
    pk_t, pk_j = _fine_packets(grid, 9, 20000, spectral=True)
    tally_j, out_j = jax_amr.trace_amr_spectral(
        _jax_grid(grid), jnp.asarray(chi_h), jnp.asarray(chi_he), pk_j, n_bins=6)
    tally_t, out_t = amr.trace_amr_spectral(
        grid, torch.tensor(chi_h), torch.tensor(chi_he), pk_t, n_bins=6)
    assert tuple(tally_t.shape) == (6, grid.n_cells)
    np.testing.assert_array_equal(out_t.absorbed.numpy(), np.asarray(out_j.absorbed))
    if deep:
        _assert_batches_equal(out_t, out_j)
        np.testing.assert_array_equal(tally_t.numpy(), np.asarray(tally_j))
    else:
        np.testing.assert_allclose(tally_t.numpy(), np.asarray(tally_j), rtol=1e-5,
                                   atol=1e-6 * float(np.asarray(tally_j).max()))


# --------------------------------------- mirrors of tests/test_amr.py


def test_unrefined_amr_matches_uniform_trace():
    geom = _geom(8)
    g = amr.build_amr_grid(geom, None, _uniform_density(1.0e8), max_level=0)
    chi_si = torch.full((g.n_cells,), 1.0e8 * 6.3e-22)
    pk, _ = _fine_packets(g, 0, 512)
    leaf_tally, _ = amr.trace_amr(g, chi_si, pk)
    dx_m = float(geom.cell_size[0])
    tally, _ = traversal.trace_packets(chi_si * dx_m, pk, torch.zeros(g.n_cells),
                                       shape=geom.shape)
    np.testing.assert_allclose(leaf_tally.numpy(), tally.numpy() * dx_m, rtol=2e-5)


def test_octree_matches_dense_path():
    """The port's octree march against its own dense-expand march: per-leaf
    tallies within rtol 2e-3 (the leaf path is split into fine segments
    there, marched whole here), escaped counts within 0.2%."""
    g = _refined_grid()
    chi_si = torch.tensor((10 ** np.random.default_rng(5).uniform(
        -17.5, -16.5, g.n_cells)).astype(np.float32))
    pk, _ = _fine_packets(g, 9, 20000)
    dense, dense_esc = amr.trace_amr(g, chi_si, pk)
    octree, oct_esc = amr.trace_amr(dataclasses.replace(g, owner=None), chi_si, pk)
    np.testing.assert_allclose(octree.numpy(), dense.numpy(), rtol=2e-3,
                               atol=1e-4 * float(dense.max()))
    assert int(oct_esc) == pytest.approx(int(dense_esc), abs=max(2, int(0.002 * 20000)))


def test_octree_spectral_matches_dense_path():
    g = _refined_grid()
    rng = np.random.default_rng(7)
    chi_h = torch.tensor((10 ** rng.uniform(4.5, 5.5, g.n_cells)).astype(np.float32))
    chi_he = torch.tensor((10 ** rng.uniform(3.5, 4.5, g.n_cells)).astype(np.float32))
    pk, _ = _fine_packets(g, 9, 20000, spectral=True)
    dense, dense_pk = amr.trace_amr_spectral(g, chi_h, chi_he, pk, n_bins=6)
    octree, oct_pk = amr.trace_amr_spectral(
        dataclasses.replace(g, owner=None), chi_h, chi_he, pk, n_bins=6)
    np.testing.assert_allclose(octree.numpy(), dense.numpy(), rtol=2e-3,
                               atol=1e-4 * float(dense.max()))
    assert int(oct_pk.absorbed.sum()) == pytest.approx(int(dense_pk.absorbed.sum()), abs=40)
    np.testing.assert_allclose(float(torch.where(oct_pk.absorbed, oct_pk.px, 0.0).sum()),
                               float(torch.where(dense_pk.absorbed, dense_pk.px, 0.0).sum()),
                               rtol=5e-3)


def test_refined_transport_conserves_path_length():
    scheme = amr.SpatialRefinement((0.0,) * 3, (BOX, BOX, BOX / 2), 2)
    g = amr.build_amr_grid(_geom(4), scheme, _uniform_density(1.0), max_level=2)
    rng = np.random.default_rng(1)
    n = 256
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    pos = torch.full((n, 3), 8.0) + 1e-4 * torch.tensor(d)
    for grid in (g, dataclasses.replace(g, owner=None)):
        pk = traversal.make_packets(pos, torch.tensor(d), torch.full((n,), 1e30),
                                    torch.ones(n), grid.fine_shape)
        tally, escaped = amr.trace_amr(grid, torch.full((grid.n_cells,), 1e-30), pk)
        assert int(escaped) == n
        p0 = np.full(3, 0.5 * BOX)
        with np.errstate(divide="ignore"):
            t = np.min(np.where(d > 0, (BOX - p0) / d, np.where(d < 0, -p0 / d, np.inf)), 1)
        np.testing.assert_allclose(float(tally.double().sum()), t.sum(), rtol=1e-4)


def test_resample_roundtrip_and_mass():
    geom = _geom(4)
    g1 = amr.build_amr_grid(geom, amr.SpatialRefinement((0, 0, 0), (BOX / 2, BOX, BOX), 1),
                            _uniform_density(1.0), max_level=1)
    g2 = amr.build_amr_grid(geom, amr.SpatialRefinement((BOX / 2, 0, 0), (BOX / 2, BOX, BOX),
                                                        1), _uniform_density(1.0), max_level=1)
    out = amr.resample_leaf_values(g1, g2, torch.full((g1.n_cells,), 0.37))
    np.testing.assert_allclose(out.numpy(), 0.37, rtol=1e-6)
    g1 = amr.build_amr_grid(geom, amr.SpatialRefinement((0, 0, 0), (BOX / 2, BOX, BOX), 2),
                            _uniform_density(1.0), max_level=2)
    g0 = amr.build_amr_grid(geom, None, _uniform_density(1.0), max_level=0)
    dens = np.random.default_rng(3).random(g1.n_cells).astype(np.float32)
    for new, old in ((g0, g1), (g1, g0)):
        vals = dens if old is g1 else dens[: g0.n_cells]
        out = amr.resample_leaf_values(old, new, torch.tensor(vals)).double().numpy()
        ref = np.asarray(jax_amr.resample_leaf_values(_jax_grid(old), _jax_grid(new),
                                                      jnp.asarray(vals)))
        np.testing.assert_allclose(out, ref, rtol=1e-6)
        np.testing.assert_allclose(float(np.sum(out * new.volumes)),
                                   float(np.sum(vals.astype(np.float64) * old.volumes)),
                                   rtol=1e-5)


def test_refinement_beats_coarse_on_stromgren():
    nH, sigma, alpha, L = 1.0e8, 6.3e-22, 2.7e-19, 1.0e48
    r_s = (3.0 * L / (4.0 * np.pi * alpha * nH * nH)) ** (1.0 / 3.0)
    box = 6.0 * r_s
    geom = GridGeometry((0.0, 0.0, 0.0), (box, box, box), (8, 8, 8))
    v_exact = 4.0 / 3.0 * np.pi * r_s**3

    def run(scheme, max_level):
        sim = amr.AMRIonizationSimulation(
            geom, scheme, _uniform_density(nH), device="cpu", source_position=(box / 2,) * 3,
            luminosity=L, cross_section=sigma, recombination_rate=alpha, n_photons=1 << 14,
            max_level=max_level, seed=7)
        sim.run(10)
        assert tuple(sim.n_escaped.shape) == (10,)
        return sim.ionized_volume()

    err_coarse = abs(run(None, 0) - v_exact) / v_exact
    scheme = amr.OpacityRefinement(target_opacity=0.1 / float(geom.cell_size[0]), max_level=2)
    err_amr = abs(run(scheme, 2) - v_exact) / v_exact
    assert err_amr < err_coarse / 2.0 and err_amr < 0.15


def test_deep_level5_without_dense_lattice():
    scheme = amr.SpatialRefinement((0.0,) * 3, (BOX / 16,) * 3, max_level=5)
    sim = amr.AMRIonizationSimulation(
        _geom(16), scheme, _uniform_density(1.0e8), device="cpu",
        source_position=(0.05 * BOX,) * 3, luminosity=4.26e49, cross_section=6.3e-22,
        recombination_rate=4e-19, n_photons=20000, max_level=5, seed=3)
    g = sim.grid
    assert g.max_level == 5 and g.owner is None and int(g.levels.max()) == 5
    assert g.n_cells < 60000
    xn = sim.run(2).numpy()
    assert xn.min() < 1e-2 and sim.ionized_volume() > 0


def test_regrid_shallow_and_deep():
    """Re-refinement runs on a shallow grid (the criterion reads the neutral
    fraction); on a deep grid it raises where the JAX driver fails."""
    kwargs = dict(device="cpu", source_position=(0.5 * BOX,) * 3, luminosity=4.26e49,
                  cross_section=6.3e-22, recombination_rate=4e-19, n_photons=4096,
                  refinement_interval=2, seed=5)
    sim = amr.AMRIonizationSimulation(
        _geom(8), amr.OpacityRefinement(target_opacity=5e-14, max_level=2),
        _uniform_density(1.0e8), max_level=2, **kwargs)
    n0 = sim.grid.n_cells
    sim.run(3)
    assert sim.grid.n_cells < n0  # the ionized core is no longer refined
    assert sim.neutral_fraction.shape == (sim.grid.n_cells,)
    deep = amr.AMRIonizationSimulation(
        _geom(16), amr.SpatialRefinement((0.0,) * 3, (BOX / 16,) * 3, 5),
        _uniform_density(1.0e8), max_level=5, **{**kwargs, "n_photons": 512})
    with pytest.raises(NotImplementedError, match="deep grid"):
        deep.run(3)
    with pytest.raises(NotImplementedError, match="restart"):
        sim.run(1, restart_manager=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        amr.AMRIonizationSimulation(_geom(4), None, _uniform_density(1.0), mesh=object(),
                                    **kwargs)


# ------------------------------------------------ drivers against JAX


def test_honly_iteration_from_jax_state(monkeypatch):
    """From the same neutral fraction, one iteration of each driver given the
    same tally: the same opacity handed to the march and the same new
    neutral fraction."""
    scheme = amr.SpatialRefinement((0.0,) * 3, (BOX / 2,) * 3, 1)
    kwargs = dict(source_position=(0.3 * BOX,) * 3, luminosity=4.26e49, cross_section=6.3e-22,
                  recombination_rate=4e-19, n_photons=1000, max_level=1, seed=2)
    ref = jax_amr.AMRIonizationSimulation(
        JaxGridGeometry((0.0,) * 3, (BOX,) * 3, (8, 8, 8)), _jax_scheme(scheme),
        _uniform_density(1.0e8), **kwargs)
    sim = amr.AMRIonizationSimulation(_geom(8), scheme, _uniform_density(1.0e8), device="cpu",
                                      **kwargs)
    C = sim.grid.n_cells
    rng = np.random.default_rng(6)
    xn = rng.uniform(1e-4, 1.0, C).astype(np.float32)
    tally = (10 ** rng.uniform(-2, 4, C)).astype(np.float32) * np.float32(BOX / 8)
    ref.neutral_fraction = jnp.asarray(xn)
    sim.load_reference_state({"neutral_fraction": xn})
    seen = {}
    monkeypatch.setattr(jax_amr, "trace_amr", lambda g, chi, pk: (
        seen.setdefault("jax", np.asarray(chi)), (jnp.asarray(tally), 0))[1])
    monkeypatch.setattr(amr, "trace_amr", lambda g, chi, pk: (
        seen.setdefault("port", chi.numpy()), (torch.tensor(tally), torch.tensor(0)))[1])
    ref.run(1)
    sim.run(1)
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=1e-6)
    np.testing.assert_allclose(sim.neutral_fraction.numpy(), np.asarray(ref.neutral_fraction),
                               rtol=1e-5)
    assert sim.ionized_volume() == pytest.approx(ref.ionized_volume(), rel=1e-5)


def test_multifreq_iteration_from_jax_state(monkeypatch):
    """From the JAX driver's state, one iteration of each driver given the
    same binned tally (no temperature balance): the same ionization state."""
    from cmacionize_torch.models import ions

    grid = amr.build_amr_grid(
        GridGeometry((-5 * PC,) * 3, (10 * PC,) * 3, (8, 8, 8)),
        amr.SpatialRefinement((-1.5 * PC,) * 3, (3.0 * PC,) * 3, 1), _uniform_density(1e8),
        max_level=1)
    kwargs = dict(source_position=(0.0, 0.0, 0.0), luminosity=4.26e49, n_photons=5000,
                  abundances=ABUND, do_temperature=False, diffuse_field=False, n_bins=16,
                  seed=15)
    ref = jax_amr.MultiFreqAMRSimulation(_jax_grid(grid), _uniform_density(1e8), **kwargs)
    sim = amr.MultiFreqAMRSimulation(grid, _uniform_density(1e8), device="cpu", **kwargs)
    rng = np.random.default_rng(8)
    C = grid.n_cells
    xion = {name: rng.uniform(1e-5, 1.0, C) for name in ions.ION_NAMES}
    temperature = rng.uniform(6000.0, 9000.0, C)
    ref.xion = {k: jnp.asarray(v) for k, v in xion.items()}
    ref.temperature = jnp.asarray(temperature)
    sim.load_reference_state(xion, temperature)
    scale = (grid.volumes ** (1.0 / 3.0)).astype(np.float32)
    tally = (10 ** rng.uniform(-3, 1, (16, C))).astype(np.float32) * scale
    monkeypatch.setattr(jax_amr, "trace_amr_spectral",
                        lambda g, h, he, pk, n_bins: (jnp.asarray(tally), pk))
    monkeypatch.setattr(amr, "trace_amr_spectral",
                        lambda g, h, he, pk, n_bins: (torch.tensor(tally), pk))
    xion_j, T_j = ref.run(1)
    xion_t, T_t = sim.run(1)
    np.testing.assert_array_equal(T_t.numpy(), np.asarray(T_j))
    for name in ions.ION_NAMES:
        np.testing.assert_allclose(xion_t[name].numpy(), np.asarray(xion_j[name]), rtol=1e-5,
                                   atol=1e-12, err_msg=name)
    assert len(sim.phase_seconds) == 1 and sim.reemitted[0].numel() == 0


# -------------------------- mirrors of TestMultiFreqAMR and the deep smoke


def _geometry16():
    return GridGeometry((-5 * PC,) * 3, (10 * PC,) * 3, (16, 16, 16))


def _density_fn(pos):
    return np.full(len(np.atleast_2d(pos)), 1e8)  # 100 cm^-3


def _check_structure(r, xH, xHe, label):
    """tests/test_multifreq_grids.py's structure assertions."""
    assert np.median(xH[r < 2.0 * PC]) < 0.05, f"{label}: core not ionized"
    assert np.median(xH[r > 4.6 * PC]) > 0.5, f"{label}: exterior not neutral"
    vol_h, vol_he = (xH < 0.5).sum(), (xHe < 0.5).sum()
    assert 0 < vol_he <= vol_h * 1.1, f"{label}: He front ({vol_he}) outside H front ({vol_h})"


class TestMultiFreqAMR:
    def test_multi_element_structure(self):
        scheme = amr.SpatialRefinement((-1.5 * PC,) * 3, (3.0 * PC,) * 3, max_level=1)
        grid = amr.build_amr_grid(_geometry16(), scheme, _density_fn, max_level=1)
        assert grid.n_cells > 16**3
        sim = amr.MultiFreqAMRSimulation(
            grid, _density_fn, device="cpu", source_position=(0.0, 0.0, 0.0),
            luminosity=4.26e49, n_photons=20000, abundances=ABUND, do_temperature=True,
            diffuse_field=False, n_bins=32, seed=8)
        xion, T = sim.run(4)
        assert T.dtype == torch.float64 and len(sim.sweeps) == 1
        r = np.sqrt((grid.centers**2).sum(-1))
        xH = np.clip(xion["H_n"].numpy(), 0, 1)
        _check_structure(r, xH, np.clip(xion["He_n"].numpy(), 0, 1), "AMR")
        assert 4000.0 < np.median(T.numpy()[r < 2.0 * PC]) < 25000.0
        assert np.median(xion["O_n"].numpy()[r < 2.0 * PC]) < 0.5

    def test_diffuse_field_grows_ionized_volume(self):
        grid = amr.build_amr_grid(_geometry16(), None, _density_fn, max_level=1)
        kwargs = dict(source_position=(0.0, 0.0, 0.0), luminosity=4.26e49, n_photons=20000,
                      abundances=ABUND, do_temperature=False, n_bins=32,
                      n_reemission_rounds=3, seed=9)
        xion_d, _ = amr.MultiFreqAMRSimulation(
            grid, _density_fn, device="cpu", diffuse_field=True, **kwargs).run(4)
        xion_n, _ = amr.MultiFreqAMRSimulation(
            grid, _density_fn, device="cpu", diffuse_field=False, **kwargs).run(4)
        v_d = float(((xion_d["H_n"].numpy() < 0.5) * grid.volumes).sum())
        v_n = float(((xion_n["H_n"].numpy() < 0.5) * grid.volumes).sum())
        assert v_d >= v_n


def test_deep_multifreq_smoke():
    """Multi-element + diffuse re-emission on a level-5 hierarchy whose dense
    finest lattice (512³) is above the dense budget: the octree marches and
    the leaf descent of the re-emission sites."""
    scheme = amr.SpatialRefinement((0.0,) * 3, (BOX / 16,) * 3, max_level=5)
    grid = amr.build_amr_grid(_geom(16), scheme, _uniform_density(1.0e8), max_level=5)
    assert grid.owner is None
    sim = amr.MultiFreqAMRSimulation(
        grid, _uniform_density(1.0e8), device="cpu", source_position=(0.05 * BOX,) * 3,
        luminosity=4.26e49, n_photons=16384, abundances=ABUND, do_temperature=False,
        diffuse_field=True, n_bins=16, n_reemission_rounds=2, seed=4)
    xion, _ = sim.run(3)
    xH = xion["H_n"].numpy()
    assert np.all(np.isfinite(xH)) and xH.min() < 1e-2 and xH.max() > 0.9
    xHe = xion["He_n"].numpy()
    assert np.all(np.isfinite(xHe)) and xHe.min() < 0.5
    assert all(len(c) == 2 for c in sim.reemitted) and int(sim.reemitted[-1][0]) > 0
    with pytest.raises(NotImplementedError, match="restart"):
        sim.write_restart(None)
