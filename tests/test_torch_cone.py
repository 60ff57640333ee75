"""The port's cone march and stratified emission against the JAX tools, on
the CPU.

``tools/experimental_cone_kernel.py`` and ``tools/experimental_emission_octa.py``
are imported by path.  The Pallas cone kernel runs in interpret mode on
JAX-CPU with x64 off (under x64 its lag-lane sums promote the cell indices to
int64 and the kernel does not trace); the port's ``trace_packets_cone`` on
CPU tensors runs its plain version.  Both get the same numpy inputs.

Tolerances: the plain version repeats the kernel's per-cell arithmetic,
with the two advance sums p + d·t and q + ds·t rounded once (XLA fuses them
into FMAs on the CPU: without that, 125-204 of 1024 positions differ in the
last bits, with it 4-12, all from τ), but the slab's optical depth is a
512-term sum whose order XLA and PyTorch choose differently, so τ and the
absorption points of later phases differ at f32 round-off: states and cells
identical, positions and τ within 1e-5, tally relative L1 ≤ 1e-6.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch.ops import traversal
from cmacionize_torch.tools import experimental_cone_kernel as cone
from cmacionize_torch.tools import experimental_emission_octa as octa

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import experimental_cone_kernel as jax_cone  # noqa: E402
import experimental_emission_octa as jax_octa  # noqa: E402

SHAPE = (16, 16, 16)
SKEW_SHAPE = (16, 12, 10)
N = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stratified_packets(seed, n, source):
    """JAX's stratified emission from ``source`` as numpy arrays."""
    with jax.enable_x64(False):
        out = jax_octa.emit_point_source_stratified(jax.random.PRNGKey(seed), n, source)
    return tuple(np.asarray(a) for a in out)


def _incoherent_packets(seed, n, shape):
    """Random positions and isotropic directions anywhere in the box."""
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(0.0, 1.0, (n, 3)) * np.asarray(shape)).astype(np.float32)
    v = rng.normal(size=(n, 3))
    d = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    tau = (-np.log(rng.uniform(1e-10, 1.0, n))).astype(np.float32)
    return pos, d, tau, np.ones(n, np.float32)


def _both(chi, packets, shape, max_phases=128):
    """(JAX interpret, port) outputs of the cone march as numpy arrays."""
    pos, d, tau, w = packets
    with jax.enable_x64(False):
        pf, pi = jax_cone.pack_packets(*(jnp.asarray(a) for a in packets), shape)
        out_j = jax_cone.trace_packets_cone(
            jnp.asarray(chi), pf, pi, shape=shape, max_phases=max_phases, interpret=True)
    pf_t, pi_t = cone.pack_packets(*(torch.tensor(a) for a in packets), shape)
    out_t = cone.trace_packets_cone(torch.tensor(chi), pf_t, pi_t, shape=shape,
                                    max_phases=max_phases)
    return [np.asarray(a) for a in out_j], [a.numpy() for a in out_t]


def _assert_cone_close(out_j, out_t):
    (tally_j, pf_j, pi_j), (tally_t, pf_t, pi_t) = out_j, out_t
    np.testing.assert_array_equal(pi_t, pi_j)  # cells and states
    np.testing.assert_allclose(pf_t[:, :3], pf_j[:, :3], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pf_t[:, 3:6], pf_j[:, 3:6])
    np.testing.assert_allclose(pf_t[:, 6], pf_j[:, 6], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pf_t[:, 7], pf_j[:, 7])
    rel_l1 = np.abs(tally_t - tally_j).sum() / max(np.abs(tally_j).sum(), 1e-30)
    assert rel_l1 <= 1e-6, rel_l1


# -- the stratified emission -------------------------------------------------


@pytest.mark.parametrize("n", [1024, 2**14])
def test_lane_table_matches_jax(n):
    octant, cell_a, cell_b, ga, gb = octa.lane_table(n)
    j_octant, j_cell_a, j_cell_b, j_ga, j_gb = jax_octa.lane_table(n)
    assert (ga, gb) == (j_ga, j_gb)
    for mine, theirs in ((octant, j_octant), (cell_a, j_cell_a), (cell_b, j_cell_b)):
        theirs = np.asarray(theirs)
        assert mine.dtype == theirs.dtype == np.int32
        np.testing.assert_array_equal(mine, theirs)
    assert octa.lane_table(n) is octa.lane_table(n)  # cached


@pytest.mark.parametrize("n", [1000, 2048])
def test_lane_table_errors_match_jax(n):
    with pytest.raises(ValueError) as theirs:
        jax_octa.lane_table(n)
    with pytest.raises(ValueError) as mine:
        octa.lane_table(n)
    assert str(mine.value) == str(theirs.value)


def test_direction_map_matches_jax_from_shared_jitter():
    n = 2**14
    key = jax.random.PRNGKey(7)
    with jax.enable_x64(False):
        k1, k2 = jax.random.split(key)
        ja = np.asarray(jax.random.uniform(k1, (n,), jnp.float32))
        jb = np.asarray(jax.random.uniform(k2, (n,), jnp.float32))
        d_jax = np.asarray(jax_octa.stratified_directions(key, n))
    d = octa.directions_from_jitter(torch.tensor(ja), torch.tensor(jb)).numpy()
    # 4 ulp of a unit vector's scale (cos/sin/sqrt of XLA and PyTorch differ
    # in the last bit, and near phi = pi/2 a component is a tiny difference)
    ulp = np.spacing(np.float32(1.0))
    assert np.abs(d - d_jax).max() <= 4 * ulp
    np.testing.assert_allclose(np.linalg.norm(d.astype(np.float64), axis=1), 1.0, atol=1e-6)


def test_chunks_are_sign_pure_and_isotropic():
    n = 2**16
    generator = torch.Generator().manual_seed(3)
    d = octa.stratified_directions(generator, n).numpy()
    octant = np.arange(n) // (n // 8)
    np.testing.assert_array_equal(d > 0, octa._OCT_SIGNS[octant] > 0)
    # every chunk of 512 lanes has one sign triplet
    signs = (d > 0).reshape(n // 512, 512, 3)
    assert (signs == signs[:, :1]).all()
    assert np.abs(d.mean(axis=0)).max() < 1e-2
    second = (d.astype(np.float64) ** 2).mean(axis=0)
    np.testing.assert_allclose(second, 1.0 / 3.0, atol=1e-2)


def test_emit_point_source_stratified_on_cpu():
    generator = torch.Generator().manual_seed(5)
    pos, d, tau, w = octa.emit_point_source_stratified(generator, N, (8.0, 8.0, 8.0),
                                                       device="cpu")
    assert pos.shape == d.shape == (N, 3) and tau.shape == w.shape == (N,)
    assert (pos == 8.0).all() and (tau > 0).all() and torch.isfinite(tau).all()
    assert (w == 1.0).all() and d.device.type == "cpu"


def test_pack_packets_matches_jax():
    packets = _incoherent_packets(11, N, SKEW_SHAPE)
    with jax.enable_x64(False):
        pf_j, pi_j = jax_cone.pack_packets(*(jnp.asarray(a) for a in packets), SKEW_SHAPE)
    pf, pi = cone.pack_packets(*(torch.tensor(a) for a in packets), SKEW_SHAPE)
    assert pf.dtype == torch.float32 and pi.dtype == torch.int32
    np.testing.assert_array_equal(pf.numpy(), np.asarray(pf_j))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(pi_j))


# -- the cone march ----------------------------------------------------------


def test_cone_matches_jax_on_stratified_packets():
    chi = np.random.default_rng(1).uniform(0.0, 0.5, SHAPE).astype(np.float32)
    out_j, out_t = _both(chi, _stratified_packets(0, N, (8.0, 8.0, 8.0)), SHAPE)
    _assert_cone_close(out_j, out_t)
    states = np.bincount(out_j[2][:, 3], minlength=3)
    assert states[0] == 0 and states[1] > 0 and states[2] > 0, states


@pytest.mark.parametrize("max_phases", [128, 4])
def test_cone_matches_jax_on_incoherent_packets(max_phases):
    chi = np.random.default_rng(2).uniform(0.0, 0.5, SKEW_SHAPE).astype(np.float32)
    out_j, out_t = _both(chi, _incoherent_packets(3, N, SKEW_SHAPE), SKEW_SHAPE,
                         max_phases=max_phases)
    _assert_cone_close(out_j, out_t)
    in_flight = int((out_j[2][:, 3] == 0).sum())
    assert (in_flight > 0) == (max_phases == 4), in_flight


@pytest.mark.parametrize("chi_value, state", [(0.0, 2), (1e4, 1)])
def test_cone_matches_jax_transparent_and_opaque(chi_value, state):
    chi = np.full(SHAPE, chi_value, np.float32)
    out_j, out_t = _both(chi, _stratified_packets(4, N, (8.0, 8.0, 8.0)), SHAPE)
    _assert_cone_close(out_j, out_t)
    assert (out_t[2][:, 3] == state).all()


@pytest.mark.parametrize("case", ["stratified", "incoherent"])
def test_cone_then_k1_matches_k1_alone(case):
    if case == "stratified":
        shape, max_phases = SHAPE, 2
        chi = np.random.default_rng(1).uniform(0.0, 0.5, shape).astype(np.float32)
        packets = _stratified_packets(0, N, (8.0, 8.0, 8.0))
    else:
        shape, max_phases = SKEW_SHAPE, 4
        chi = np.random.default_rng(2).uniform(0.0, 0.5, shape).astype(np.float32)
        packets = _incoherent_packets(3, N, shape)
    pos, d, tau, w = (torch.tensor(a) for a in packets)
    chi_t = torch.tensor(chi)

    alone = traversal.make_packets(pos, d, tau, w, shape)
    tally_k1, out_k1 = traversal.trace_packets_reference(
        chi_t.reshape(-1), alone, torch.zeros(chi.size), shape=shape)

    pf, pi = cone.pack_packets(pos, d, tau, w, shape)
    tally, pf, pi = cone.trace_packets_cone(chi_t, pf, pi, shape=shape, max_phases=max_phases)
    left = pi[:, 3] == 0
    assert int(left.sum()) > 0
    stragglers = traversal.make_packets(pf[:, :3], pf[:, 3:6], pf[:, 6], pf[:, 7], shape)
    stragglers = stragglers._replace(active=left)
    tally = tally.reshape(-1)
    tally, finished = traversal.trace_packets_reference(chi_t.reshape(-1), stragglers, tally,
                                                        shape=shape)
    rel_l1 = float((tally - tally_k1).abs().sum() / tally_k1.abs().sum())
    assert rel_l1 <= 1e-5, rel_l1
    absorbed = int((pi[:, 3] == 1).sum()) + int((finished.absorbed & left).sum())
    assert abs(absorbed - int(out_k1.absorbed.sum())) <= 1


def test_value_errors_match_jax():
    pf = torch.zeros((N + 8, 8))
    pi = torch.zeros((N + 8, 8), dtype=torch.int32)
    for shape, rows in ((SHAPE, N + 8), ((16, 7, 16), N)):
        with jax.enable_x64(False), pytest.raises(ValueError) as theirs:
            jax_cone.trace_packets_cone(jnp.zeros(shape, jnp.float32), jnp.zeros((rows, 8)),
                                        jnp.zeros((rows, 8), jnp.int32), shape=shape,
                                        interpret=True)
        with pytest.raises(ValueError) as mine:
            cone.trace_packets_cone(torch.zeros(shape), pf[:rows], pi[:rows], shape=shape)
        assert str(mine.value) == str(theirs.value)
