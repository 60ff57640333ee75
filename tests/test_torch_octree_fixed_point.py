"""The premise of K5's fixed-point exit, held against the JAX octree march on
the CPU.

The JAX march's nudge quirk (cmacionize_torch/ops/amr_traversal.py) leaves
a packet that crosses a wall against a tiny direction component on that
wall, active, until ``max_steps``.  Its state stops changing there: the step
is a pure function of position, ``tau_left`` and the flags, so once a step
leaves them bit for bit as they were, with a deposit of +0.0, every later
step repeats it.  K5 (csrc/trace_octree.cu) ends such a packet at that step.
Here, on a small deep grid with seeded packets and packets made to stall at
different steps:

- JAX's ``trace_packets_octree`` gives bit-identical final states and tally
  at ``max_steps = k``, the first step after which every packet has ended or
  is at a fixed point, and at the default ``max_steps``;
- the plain version agrees with JAX at both;
- its count of no-op steps is (default - fixed-point step) summed over the
  packets that stall, and those are the packets still active at the cap.

Beside it, the host parts of K5's wrapper and of ``tools/octree_study.py``:
the direction order the wrapper hands the kernel, the wrapper's checks, and
the study's reading of the plain march's statistics.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cmacionize_torch.kernels import trace_octree as k5
from cmacionize_torch.models import amr
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.ops import amr_traversal, traversal
from cmacionize_torch.tools import octree_study
from cmacionize_tpu.ops import amr_traversal as jax_amr_traversal
from cmacionize_tpu.ops import traversal as jax_traversal

BOX = 1.0e17  # m
N, LEVEL = 8, 4  # coarse cells a side; the corner cell refined to level 4
FIELDS = ("px", "py", "pz", "tau_left", "active", "absorbed")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def march():
    """The grid's tables, χ, the packets' columns and the default step cap."""
    scheme = amr.SpatialRefinement((0.0,) * 3, (BOX / N,) * 3, LEVEL)
    grid = amr.build_amr_grid(GridGeometry((0.0,) * 3, (BOX,) * 3, (N,) * 3), scheme,
                              lambda p: np.ones(len(p)), max_level=LEVEL)
    assert int(grid.levels.max()) == LEVEL
    root, children = grid.octree()
    rng = np.random.default_rng(15)
    chi = (10 ** rng.uniform(-1.5, 0.5, grid.n_cells)).astype(np.float32)
    cols = _packets(rng)
    return root, children, chi, cols, amr_traversal.default_max_steps((N,) * 3, LEVEL)


def _packets(rng, n_seeded=1500, n_grazing=300):
    """Seeded packets over the box (a quarter on walls of the level-4
    lattice) and grazing ones in the deep corner: |dx| = 1e-4 toward -x,
    just past x = 0.5, so that each crosses 0-3 walls of y or z before it
    lands on x = 0.5, where the nudge rounds away (an equal-resolution wall)
    and the packet stalls; and the two of tests/test_torch_amr.py's nudge
    test moved to the coarse wall x = 2."""
    d = rng.normal(size=(n_seeded, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = rng.uniform(0.02, N - 0.02, (n_seeded, 3))
    pos[: n_seeded // 3] = rng.uniform(0.01, 0.99, (n_seeded // 3, 3))  # the deep corner
    pos[: n_seeded // 4] = np.round(pos[: n_seeded // 4] * 16) / 16
    tau = -np.log1p(-rng.random(n_seeded)) * 3

    phi = rng.uniform(0.0, 2.0 * np.pi, n_grazing)
    dx = np.full(n_grazing, -1e-4)
    side = np.sqrt(1.0 - dx**2)
    dg = np.stack([dx, side * np.cos(phi), side * np.sin(phi)], 1)
    offset = 10 ** rng.uniform(-7.0, -5.0, n_grazing)
    pg = np.stack([0.5 + offset, *rng.uniform(0.05, 0.95, (2, n_grazing))], 1)
    dn = np.array([[-0.00011920929, 1.0, 0.0], [-0.00011920929, -1.0, 0.0]])
    pn = np.array([[2.0, 6.3, 6.55], [2.0 + 1e-6, 5.7, 3.25]])

    d = np.concatenate([d, dg, dn]).astype(np.float32)
    pos = np.concatenate([pos, pg, pn]).astype(np.float32)
    tau = np.concatenate([tau, np.full(n_grazing + 2, 1e3)]).astype(np.float32)
    P = len(pos)
    w = rng.uniform(0.5, 1.5, P).astype(np.float32)
    return [pos[:, 0], pos[:, 1], pos[:, 2], *([np.zeros(P, np.int32)] * 3),
            d[:, 0], d[:, 1], d[:, 2], tau, w, np.ones(P, bool), np.zeros(P, bool)]


def _jax(root, children, chi, cols, max_steps):
    tally, out = jax_amr_traversal.trace_packets_octree(
        jnp.asarray(root), jnp.asarray(children), jnp.asarray(chi),
        jax_traversal.PacketBatch(*(jnp.asarray(c) for c in cols)),
        jnp.zeros(len(chi), jnp.float32), coarse_shape=(N,) * 3, max_level=LEVEL,
        max_steps=max_steps)
    return np.asarray(tally), {f: np.asarray(getattr(out, f)) for f in FIELDS}


def _plain(root, children, chi, cols, max_steps, stats=None):
    tally, out = amr_traversal.trace_packets_octree_reference(
        torch.tensor(root), torch.tensor(children), torch.tensor(chi),
        traversal.PacketBatch(*(torch.tensor(c) for c in cols)), torch.zeros(len(chi)),
        coarse_shape=(N,) * 3, max_level=LEVEL, max_steps=max_steps, stats=stats)
    return tally.numpy(), {f: getattr(out, f).numpy() for f in FIELDS}


def _assert_same(a, b):
    tally_a, out_a = a
    tally_b, out_b = b
    for f in FIELDS:
        np.testing.assert_array_equal(out_a[f].view(np.uint8), out_b[f].view(np.uint8),
                                      err_msg=f)
    np.testing.assert_array_equal(tally_a.view(np.int32), tally_b.view(np.int32))


def test_jax_ends_at_the_fixed_point_as_at_the_cap(march):
    root, children, chi, cols, default = march
    stats = {}
    plain_default = _plain(root, children, chi, cols, 0, stats)
    steps = stats["steps"].numpy()
    fixed = stats["fixed_point_step"].numpy()
    stalled = fixed >= 0
    n_grazing = 300
    assert stalled.sum() >= n_grazing and stalled[-n_grazing - 2:].all()
    assert len(set(fixed[stalled].tolist())) >= 3  # packets stall at several steps
    # after k steps every packet has ended or sits at its fixed point
    k = int(max(steps[~stalled].max(), fixed[stalled].max()))
    assert 0 < k < default // 4
    jax_default = _jax(root, children, chi, cols, default)
    jax_k = _jax(root, children, chi, cols, k)
    _assert_same(jax_k, jax_default)
    _assert_same(plain_default, jax_default)
    _assert_same(_plain(root, children, chi, cols, k), jax_k)
    # the stalled packets are those active at the cap, absorbed never
    active = plain_default[1]["active"]
    np.testing.assert_array_equal(active, stalled)
    assert not plain_default[1]["absorbed"][stalled].any()
    assert (steps[stalled] == default).all()


def test_noop_steps_count_the_steps_after_each_fixed_point(march):
    root, children, chi, cols, default = march
    stats = {}
    _plain(root, children, chi, cols, 0, stats)
    fixed = stats["fixed_point_step"].numpy()
    stalled = fixed >= 0
    assert int(stats["fixed_points"]) == int(stalled.sum())
    assert int(stats["noop_steps"]) == int((default - fixed[stalled]).sum())
    assert int(stats["packet_steps"]) == int(stats["steps"].numpy().sum())
    # a stalled packet's descents end at the same leaf: its no-op steps
    # cross as many levels each, 0-4 on this grid
    levels = int(stats["noop_descent_levels"])
    assert 0 < levels <= LEVEL * int(stats["noop_steps"])
    assert levels < int(stats["descent_levels"])
    # a cap below a packet's fixed point counts no no-op step for it
    few = {}
    _plain(root, children, chi, cols, 1, few)
    assert int(few["noop_steps"]) == int((fixed == 0).sum())
    assert int(few["packet_steps"]) == len(cols[0])


def test_direction_order_sorts_the_packets_by_direction_cell():
    rng = np.random.default_rng(3)
    d = rng.normal(size=(50_000, 3))
    d = torch.tensor((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    d[:4] = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
    order = k5.direction_order(d[:, 0], d[:, 1], d[:, 2])
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order.long()).values, torch.arange(len(d)))
    side = k5.DIRECTION_BUCKETS
    cells = torch.clamp(((d + 1.0) * (side / 2)).long(), 0, side - 1)[order.long()]
    key = (cells[:, 0] * side + cells[:, 1]) * side + cells[:, 2]
    assert bool((key[1:] >= key[:-1]).all())
    assert int(cells[0, 0]) == 0 and int(cells[-1, 0]) == side - 1  # -x first, +x last


def test_march_study_reads_the_plain_statistics(march):
    root, children, chi, cols, default = march
    stats = {}
    _plain(root, children, chi, cols, 0, stats)
    record = octree_study.march_study(stats, default, "the fixed-point grid")
    fixed = stats["fixed_point_step"].numpy()
    steps = stats["steps"].numpy()
    assert record["at_cap"] == record["fixed_points"] == int((fixed >= 0).sum())
    assert record["longest_ended"] == int(steps[fixed < 0].max())
    assert record["noop_steps"] == int(stats["noop_steps"])
    for width, name in ((32, "warp"), (256, "block")):
        m = len(steps) // width * width
        held = (steps[:m] >= default).reshape(-1, width).any(1).mean()
        assert record[f"{name}s_with_a_capped_lane"] == pytest.approx(held)
        assert 0.0 < record[f"{name}_lane_use"] <= 1.0


@pytest.mark.parametrize("case", ["flat children", "max_level 31", "cpu tensors"])
def test_k5_wrapper_refuses_what_the_kernel_does_not_take(march, case):
    # the wrapper's checks run before it loads the kernel's library
    root, children, chi, cols, default = march
    root, children, chi = torch.tensor(root), torch.tensor(children), torch.tensor(chi)
    shape = (N,) * 3
    assert k5.check_octree(k5.NAME, root, children, shape, LEVEL) == (N, N, N, len(children))
    if case == "flat children":
        with pytest.raises(ValueError, match=r"children must be \[n_internal, 8\]"):
            k5.check_octree(k5.NAME, root, children.reshape(-1), shape, LEVEL)
    elif case == "max_level 31":
        with pytest.raises(ValueError, match=r"max_level must be in \[0, 30\], got 31"):
            k5.check_octree(k5.NAME, root, children, shape, 31)
    else:
        fields = dict(zip(traversal.PacketBatch._fields, (torch.tensor(c) for c in cols)))
        with pytest.raises(ValueError, match="trace_octree_cuda needs CUDA tensors, got cpu"):
            k5.trace_octree_cuda(root, children, chi, torch.zeros_like(chi), fields,
                                 coarse_shape=shape, max_level=LEVEL,
                                 eps=amr_traversal.wall_eps(shape, LEVEL), max_steps=default)
