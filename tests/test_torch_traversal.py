"""cmacionize_torch packet march against the JAX package's, on the CPU.

The port's ``trace_packets`` on CPU tensors runs its plain PyTorch version
(``trace_packets_reference``); the same numpy inputs go through
``cmacionize_tpu.ops.traversal.trace_packets`` pinned to f32.  The geometry
tests mirror tests/test_traversal.py against the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch.kernels.trace_packets import trace_packets_cuda
from cmacionize_torch.ops import traversal
from cmacionize_tpu.ops import traversal as jax_traversal


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trace_single(shape, chi_value, pos, direction, tau, periodic=(False, False, False)):
    ncell = int(np.prod(shape))
    chi = torch.full((ncell,), chi_value, dtype=torch.float32)
    dirn = torch.tensor([direction], dtype=torch.float32)
    dirn = dirn / torch.linalg.norm(dirn)
    packets = traversal.make_packets(
        torch.tensor([pos], dtype=torch.float32), dirn,
        torch.tensor([tau], dtype=torch.float32), torch.ones(1), shape,
    )
    tally = torch.zeros(ncell)
    tally, packets = traversal.trace_packets(
        chi, packets, tally, shape=shape, periodic=periodic
    )
    return tally.numpy().reshape(shape), packets


# -- mirrors of tests/test_traversal.py:33-100 -------------------------------


def test_axis_ray_path_lengths():
    # transparent medium: ray along +x from cell center deposits 0.5 in its
    # starting cell and 1.0 in every other cell it crosses
    shape = (8, 4, 4)
    tally, packets = _trace_single(shape, 1e-20, (0.5, 1.5, 1.5), (1, 0, 0), 1e10)
    assert tally[0, 1, 1] == pytest.approx(0.5, rel=1e-5)
    for i in range(1, 8):
        assert tally[i, 1, 1] == pytest.approx(1.0, rel=1e-5)
    assert not bool(packets.absorbed[0])
    assert not bool(packets.active[0])  # escaped
    assert int(packets.cx[0]) == 8  # left through the +x face


def test_diagonal_ray_total_path():
    # body diagonal of a cube grid: total path = sqrt(3) * n
    shape = (4, 4, 4)
    tally, _ = _trace_single(shape, 1e-20, (0.01, 0.01, 0.01), (1, 1, 1), 1e10)
    assert tally.sum() == pytest.approx(np.sqrt(3) * (4 - 0.01), rel=1e-3)


def test_absorption_at_target_tau():
    # chi = 2 per cell: a packet with tau=3 travels 1.5 cells then stops
    shape = (8, 4, 4)
    tally, packets = _trace_single(shape, 2.0, (0.0 + 1e-6, 1.5, 1.5), (1, 0, 0), 3.0)
    assert bool(packets.absorbed[0])
    assert tally[0, 1, 1] == pytest.approx(1.0, rel=1e-4)
    assert tally[1, 1, 1] == pytest.approx(0.5, rel=1e-4)
    assert tally[2, 1, 1] == pytest.approx(0.0, abs=1e-7)
    # absorption point is at x = 1.5
    assert float(packets.px[0]) == pytest.approx(1.5, rel=1e-4)
    assert float(packets.tau_left[0]) == 0.0


def test_periodic_wrap():
    shape = (4, 4, 4)
    tally, packets = _trace_single(
        shape, 0.5, (0.5, 1.5, 1.5), (1, 0, 0), 4.0,
        periodic=(True, True, True),
    )
    # tau target 4.0 at chi 0.5 -> total path 8 cells: wraps around once
    assert bool(packets.absorbed[0])
    assert tally.sum() == pytest.approx(8.0, rel=1e-4)
    # each x-column cell crossed twice (plus the half start / final segment)
    assert tally[2, 1, 1] == pytest.approx(2.0, rel=1e-4)


def test_many_packets_conserve_path():
    # isotropic packets from the center of a transparent cube must all escape
    from cmacionize_torch.models import sources

    shape = (16, 16, 16)
    n = 512
    gen = torch.Generator().manual_seed(0)
    px, py, pz, dx, dy, dz, _, w = sources.emit_point_source(gen, n, (8.0, 8.0, 8.0))
    packets = traversal.make_packets(
        torch.stack([px, py, pz], 1), torch.stack([dx, dy, dz], 1),
        torch.full((n,), 1e10), w, shape,
    )
    chi = torch.full((16**3,), 1e-20)
    tally, packets = traversal.trace_packets(chi, packets, torch.zeros(16**3), shape=shape)
    assert not bool(torch.any(packets.active))
    assert not bool(torch.any(packets.absorbed))
    # every packet's path length is at least the inradius (8) and at most
    # the half-diagonal
    total = float(tally.sum())
    assert total >= 8.0 * n
    assert total <= np.sqrt(3) * 8 * n


# -- the same packets through both packages ---------------------------------


def _point_source_setup(seed, shape, n, chi_neutral):
    """A Strömgren-like opacity (ionized sphere, fully ionized cone along +z,
    neutral outside) and isotropic packets from the grid centre, in numpy."""
    rng = np.random.default_rng(seed)
    centre = np.asarray(shape, np.float64) / 2.0
    offset = np.indices(shape) + 0.5 - centre[:, None, None, None]
    r = np.sqrt((offset**2).sum(0))
    x = np.where(r < 0.7 * centre.min(), rng.uniform(1.5e-3, 4.5e-3, shape), 1.0)
    x = np.where(offset[2] > r * np.cos(np.radians(25.0)), 1e-5, x)
    chi = (chi_neutral * x).astype(np.float32).reshape(-1)
    cos_t = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    sin_t = np.sqrt(1.0 - cos_t**2)
    direction = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], 1)
    position = centre[None, :] + 1e-4 * direction
    tau = -np.log1p(-rng.uniform(0.0, 1.0, n))
    weight = rng.uniform(0.5, 1.5, n)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return chi, f32(position), f32(direction), f32(tau), f32(weight)


def _run_both(chi, position, direction, tau, weight, shape, periodic, max_steps=0):
    pj = jax_traversal.make_packets(
        jnp.asarray(position), jnp.asarray(direction), jnp.asarray(tau),
        jnp.asarray(weight), shape,
    )
    tally_j, out_j = jax_traversal.trace_packets(
        jnp.asarray(chi), pj, jnp.zeros(chi.size, jnp.float32),
        shape=shape, periodic=periodic, max_steps=max_steps,
    )
    pt = traversal.make_packets(
        torch.from_numpy(position), torch.from_numpy(direction),
        torch.from_numpy(tau), torch.from_numpy(weight), shape,
    )
    tally_t, out_t = traversal.trace_packets(
        torch.from_numpy(chi), pt, torch.zeros(chi.size),
        shape=shape, periodic=periodic, max_steps=max_steps,
    )
    assert tally_j.dtype == jnp.float32
    return (np.asarray(tally_j), out_j), (tally_t.numpy(), out_t)


@pytest.mark.parametrize(
    "shape, periodic, chi_neutral, seed",
    [
        ((24, 24, 24), (False, False, False), 30.0, 0),
        ((16, 20, 24), (False, False, False), 30.0, 1),
        ((16, 16, 16), (True, True, True), 0.3, 2),
        ((24, 16, 20), (True, False, True), 0.3, 3),
    ],
)
def test_trace_packets_matches_jax(shape, periodic, chi_neutral, seed):
    n = 10_000
    inputs = _point_source_setup(seed, shape, n, chi_neutral)
    (tally_j, out_j), (tally_t, out_t) = _run_both(*inputs, shape, periodic)

    absorbed = out_t.absorbed.numpy()
    assert 0 < absorbed.sum() <= n
    np.testing.assert_array_equal(absorbed, np.asarray(out_j.absorbed))
    np.testing.assert_array_equal(out_t.active.numpy(), np.asarray(out_j.active))
    for f in ("cx", "cy", "cz"):
        np.testing.assert_array_equal(getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f)))
    for f in ("px", "py", "pz"):
        np.testing.assert_allclose(
            getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f)), rtol=0, atol=5e-4
        )
    # scatter-add order may differ: f32 round-off only
    big = tally_j >= 1e-3 * tally_j.max()
    np.testing.assert_allclose(tally_t[big], tally_j[big], rtol=1e-5)
    assert np.abs(tally_t - tally_j).sum() / np.abs(tally_j).sum() <= 1e-5


def test_max_steps_cutoff_matches_jax():
    # packets cut off by max_steps stay active, frozen where the cut fell
    shape = (16, 16, 16)
    inputs = _point_source_setup(4, shape, 4000, 0.3)
    (tally_j, out_j), (tally_t, out_t) = _run_both(*inputs, shape, (False,) * 3, max_steps=5)
    assert out_t.active.numpy().sum() > 0
    np.testing.assert_array_equal(out_t.active.numpy(), np.asarray(out_j.active))
    np.testing.assert_array_equal(out_t.absorbed.numpy(), np.asarray(out_j.absorbed))
    np.testing.assert_allclose(out_t.tau_left.numpy(), np.asarray(out_j.tau_left), rtol=1e-5)
    np.testing.assert_allclose(tally_t, tally_j, rtol=1e-5, atol=1e-6)


def test_make_packets_matches_jax():
    rng = np.random.default_rng(5)
    shape = (8, 6, 4)
    # includes positions on and beyond the box faces: cells are clipped
    position = (rng.uniform(-0.5, 1.5, (64, 3)) * np.asarray(shape)).astype(np.float32)
    direction = rng.normal(size=(64, 3)).astype(np.float32)
    tau = rng.uniform(0, 3, 64).astype(np.float32)
    w = np.ones(64, np.float32)
    pj = jax_traversal.make_packets(
        jnp.asarray(position), jnp.asarray(direction), jnp.asarray(tau), jnp.asarray(w), shape
    )
    pt = traversal.make_packets(
        torch.from_numpy(position), torch.from_numpy(direction),
        torch.from_numpy(tau), torch.from_numpy(w), shape,
    )
    for f in traversal.PacketBatch._fields:
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)))
    assert pt.cx.dtype == torch.int32 and pt.active.dtype == torch.bool
    assert all(getattr(pt, f).is_contiguous() for f in ("px", "dz"))


def test_trace_packets_leaves_input_batch_unchanged():
    shape = (8, 8, 8)
    chi, position, direction, tau, weight = _point_source_setup(6, shape, 256, 3.0)
    packets = traversal.make_packets(
        torch.from_numpy(position), torch.from_numpy(direction),
        torch.from_numpy(tau), torch.from_numpy(weight), shape,
    )
    before = [getattr(packets, f).clone() for f in traversal.PacketBatch._fields]
    tally = torch.zeros(chi.size)
    out_tally, out = traversal.trace_packets(torch.from_numpy(chi), packets, tally, shape=shape)
    assert out_tally is tally  # the tally is accumulated in place
    assert float(tally.sum()) > 0
    for f, old in zip(traversal.PacketBatch._fields, before):
        assert torch.equal(getattr(packets, f), old), f
    assert not bool(out.active.any())


def test_inactive_and_outside_packets_are_frozen():
    # inactive packets keep their state; an active packet outside the grid
    # counts as escaped without moving
    shape = (4, 4, 4)
    packets = traversal.make_packets(
        torch.tensor([[1.5, 1.5, 1.5], [2.5, 2.5, 2.5]]),
        torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
        torch.tensor([0.5, 0.5]), torch.ones(2), shape,
    )
    packets = packets._replace(
        active=torch.tensor([False, True]), cx=torch.tensor([1, 7], dtype=torch.int32)
    )
    tally, out = traversal.trace_packets(
        torch.full((64,), 1.0), packets, torch.zeros(64), shape=shape
    )
    assert float(tally.sum()) == 0.0
    assert not bool(out.active.any()) and not bool(out.absorbed.any())
    assert torch.equal(out.px, packets.px) and torch.equal(out.cx, packets.cx)


def test_cuda_wrapper_rejects_cpu_tensors():
    # the kernel's wrapper never falls back to the plain version
    shape = (4, 4, 4)
    packets = traversal.make_packets(
        torch.full((1, 3), 1.5), torch.tensor([[1.0, 0.0, 0.0]]),
        torch.ones(1), torch.ones(1), shape,
    )
    with pytest.raises(ValueError, match="CUDA"):
        trace_packets_cuda(
            torch.ones(64), torch.zeros(64), packets._asdict(),
            shape=shape, periodic=(False,) * 3, max_steps=48,
        )


def _round_f32(x):
    """The f32 nearest to the rational ``x``, ties to even (normal range)."""
    from fractions import Fraction

    f = np.float32(float(x))
    candidates = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(candidates, key=lambda v: (abs(Fraction(float(v)) - x),
                                         int(np.array(v).view(np.int32)) & 1))


def test_fma_rounds_once():
    """``_fma`` is the correctly rounded a·b + c, as ``__fmaf_rn`` and XLA's
    fused advance are, also where the f64 sum lands halfway between two f32
    values (there a plain f64 sum rounded to f32 picks the even neighbour)."""
    from fractions import Fraction

    a = torch.tensor([8 * (1 + 2**-23)], dtype=torch.float32)
    b = torch.tensor([8 * (1 - 2**-23)], dtype=torch.float32)
    c = torch.tensor([2.0**30 + 128], dtype=torch.float32)
    assert float((a.double() * b.double() + c.double()).float()) == 2.0**30 + 256
    assert float(traversal._fma(a, b, c)) == 2.0**30 + 128
    rng = np.random.default_rng(3)
    A, B, C = ((rng.standard_normal(2000) * 10 ** rng.uniform(-3, 3, 2000)).astype(np.float32)
               for _ in range(3))
    got = traversal._fma(torch.tensor(A), torch.tensor(B), torch.tensor(C)).numpy()
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
            for x, y, z in zip(A, B, C)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))
