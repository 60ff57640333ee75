"""K5s's redesign and K9p's one-launch wrapper, held on the CPU.

K5s (csrc/trace_octree_spectral.cu) takes K5's three pieces: it ends a packet
at a fixed point of its step, sums each run of a warp's deposits into one
slot before its atomic, and marches the active packets in the order of a key
sort made by its wrapper, the inactive ones left out.  The first and the last
rest on two properties of the spectral march, held here against JAX's
``trace_packets_octree_spectral`` and the port's plain version on a small
deep grid with seeded packets and packets made to stall on a wall:

- JAX's march gives bit-identical final states and tally at ``max_steps =
  k``, the first step after which every packet has ended or sits at its
  fixed point, and at the default ``max_steps``; the plain version agrees
  with JAX at both;
- the plain march of permuted packets gives the permuted final states bit
  for bit (the tally is the same sum in another order).

Beside them, the host parts that the card does not need: K5s's order
(a permutation, the active lanes first, by direction), the wrappers'
refusals, and their binding and arguments on a stand-in library in the
style of tests/test_torch_launch.py; K9p's views of its one output buffer.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cmacionize_torch import kernels
from cmacionize_torch.kernels import compact, launch
from cmacionize_torch.kernels import trace_octree_spectral as k5s
from cmacionize_torch.models import amr
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.ops import amr_traversal, traversal
from cmacionize_tpu.ops import amr_traversal as jax_amr_traversal
from cmacionize_tpu.ops import traversal as jax_traversal

BOX = 1.0e17  # m
N, LEVEL, BINS = 8, 4, 6  # coarse cells a side; the corner cell refined to level 4
FIELDS = ("px", "py", "pz", "tau_left", "active", "absorbed")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def march():
    """The grid's tables, χ_H and χ_He, the packets' columns and the default
    step cap."""
    scheme = amr.SpatialRefinement((0.0,) * 3, (BOX / N,) * 3, LEVEL)
    grid = amr.build_amr_grid(GridGeometry((0.0,) * 3, (BOX,) * 3, (N,) * 3), scheme,
                              lambda p: np.ones(len(p)), max_level=LEVEL)
    root, children = grid.octree()
    rng = np.random.default_rng(18)
    chi_h = (10 ** rng.uniform(-1.5, 0.3, grid.n_cells)).astype(np.float32)
    chi_he = (0.1 * 10 ** rng.uniform(-1.5, 0.3, grid.n_cells)).astype(np.float32)
    return root, children, chi_h, chi_he, _packets(rng), amr_traversal.default_max_steps(
        (N,) * 3, LEVEL)


def _packets(rng, n_seeded=1200, n_grazing=240):
    """Seeded packets over the box (a quarter on walls of the level-4
    lattice, a third in the deep corner) and grazing ones in the deep corner
    that land on x = 0.5 against |dx| = 1e-4 and stall there, as in
    tests/test_torch_octree_fixed_point.py; per packet σ_H, σ_He and a bin."""
    d = rng.normal(size=(n_seeded, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = rng.uniform(0.02, N - 0.02, (n_seeded, 3))
    pos[: n_seeded // 3] = rng.uniform(0.01, 0.99, (n_seeded // 3, 3))
    pos[: n_seeded // 4] = np.round(pos[: n_seeded // 4] * 16) / 16
    tau = -np.log1p(-rng.random(n_seeded)) * 3
    phi = rng.uniform(0.0, 2.0 * np.pi, n_grazing)
    dx = np.full(n_grazing, -1e-4)
    side = np.sqrt(1.0 - dx**2)
    dg = np.stack([dx, side * np.cos(phi), side * np.sin(phi)], 1)
    pg = np.stack([0.5 + 10 ** rng.uniform(-7.0, -5.0, n_grazing),
                   *rng.uniform(0.05, 0.95, (2, n_grazing))], 1)
    d = np.concatenate([d, dg]).astype(np.float32)
    pos = np.concatenate([pos, pg]).astype(np.float32)
    tau = np.concatenate([tau, np.full(n_grazing, 1e3)]).astype(np.float32)
    P = len(pos)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return [pos[:, 0], pos[:, 1], pos[:, 2], *([np.zeros(P, np.int32)] * 3),
            d[:, 0], d[:, 1], d[:, 2], tau, f32(rng.uniform(0.5, 1.5, P)),
            f32(rng.uniform(0.5, 2.0, P)), f32(rng.uniform(0.0, 1.5, P)),
            rng.integers(0, BINS, P).astype(np.int32), np.ones(P, bool), np.zeros(P, bool)]


def _jax(root, children, chi_h, chi_he, cols, max_steps):
    tally, out = jax_amr_traversal.trace_packets_octree_spectral(
        jnp.asarray(root), jnp.asarray(children), jnp.asarray(chi_h), jnp.asarray(chi_he),
        jax_traversal.SpectralPacketBatch(*(jnp.asarray(c) for c in cols)),
        jnp.zeros(BINS * len(chi_h), jnp.float32), coarse_shape=(N,) * 3, max_level=LEVEL,
        n_bins=BINS, max_steps=max_steps)
    return np.asarray(tally), {f: np.asarray(getattr(out, f)) for f in FIELDS}


def _plain(root, children, chi_h, chi_he, cols, max_steps, stats=None):
    tally, out = amr_traversal.trace_packets_octree_spectral_reference(
        torch.tensor(root), torch.tensor(children), torch.tensor(chi_h), torch.tensor(chi_he),
        traversal.SpectralPacketBatch(*(torch.tensor(c) for c in cols)),
        torch.zeros(BINS * len(chi_h)), coarse_shape=(N,) * 3, max_level=LEVEL, n_bins=BINS,
        max_steps=max_steps, stats=stats)
    return tally.numpy(), {f: getattr(out, f).numpy() for f in FIELDS}


def _assert_same(a, b, tally=True):
    for f in FIELDS:
        np.testing.assert_array_equal(a[1][f].view(np.uint8), b[1][f].view(np.uint8),
                                      err_msg=f)
    if tally:
        np.testing.assert_array_equal(a[0].view(np.int32), b[0].view(np.int32))


def test_jax_spectral_march_ends_at_the_fixed_point_as_at_the_cap(march):
    root, children, chi_h, chi_he, cols, default = march
    stats = {}
    plain_default = _plain(root, children, chi_h, chi_he, cols, 0, stats)
    steps = stats["steps"].numpy()
    fixed = stats["fixed_point_step"].numpy()
    stalled = fixed >= 0
    assert stalled[-240:].all() and len(set(fixed[stalled].tolist())) >= 3
    k = int(max(steps[~stalled].max(), fixed[stalled].max()))
    assert 0 < k < default // 4
    jax_default = _jax(root, children, chi_h, chi_he, cols, default)
    jax_k = _jax(root, children, chi_h, chi_he, cols, k)
    _assert_same(jax_k, jax_default)
    _assert_same(plain_default, jax_default)
    _assert_same(_plain(root, children, chi_h, chi_he, cols, k), jax_k)
    # the stalled packets are those left active at the cap, every one at the
    # cap, none absorbed; the no-op steps are the steps after their fixed points
    np.testing.assert_array_equal(plain_default[1]["active"], stalled)
    assert not plain_default[1]["absorbed"][stalled].any()
    assert (steps[stalled] == default).all()
    assert int(stats["noop_steps"]) == int((default - fixed[stalled]).sum())


def test_plain_spectral_march_of_permuted_packets_is_the_permuted_state(march):
    root, children, chi_h, chi_he, cols, _ = march
    perm = np.random.default_rng(4).permutation(len(cols[0]))
    k = 40  # a cap that stops packets in flight: each one's state at it is its own
    tally, out = _plain(root, children, chi_h, chi_he, cols, k)
    tally_p, out_p = _plain(root, children, chi_h, chi_he, [c[perm] for c in cols], k)
    _assert_same((tally, {f: v[perm] for f, v in out.items()}), (tally_p, out_p), tally=False)
    np.testing.assert_allclose(tally_p, tally, rtol=1e-5, atol=1e-6 * float(tally.max()))
    assert 0 < int(out["absorbed"].sum()) < len(perm)


@pytest.mark.parametrize("share", [1.0, 0.3, 0.0])
def test_packet_order_puts_the_active_packets_first_by_bin_and_direction(share):
    rng = np.random.default_rng(8)
    n, n_bins = 20_000, 64
    d = rng.normal(size=(n, 3))
    d = torch.tensor((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    fields = {"dx": d[:, 0], "dy": d[:, 1], "dz": d[:, 2],
              "fbin": torch.tensor(rng.integers(0, n_bins, n), dtype=torch.int32),
              "active": torch.tensor(rng.uniform(size=n) < share)}
    order, n_active = k5s.packet_order(fields, n_bins)
    assert order.dtype == torch.int32 and n_active.dtype == torch.int64 and n_active.dim() == 0
    assert int(n_active) == int(fields["active"].sum())
    order = order.long()
    assert torch.equal(torch.sort(order).values, torch.arange(n))  # a permutation
    head, tail = order[:int(n_active)], order[int(n_active):]
    assert bool(fields["active"][head].all()) and not bool(fields["active"][tail].any())
    key = k5s.bin_direction_key(fields["dx"], fields["dy"], fields["dz"], fields["fbin"], n_bins)
    assert bool((key[head][1:] >= key[head][:-1]).all())
    # bins first, each bin's directions in a 256^3 cube, x major
    assert torch.equal(key >> 24, fields["fbin"])
    side = 256
    cells = torch.clamp(((d + 1.0) * (side / 2)).long(), 0, side - 1)
    assert torch.equal(key & (2**24 - 1), ((cells[:, 0] * side + cells[:, 1]) * side
                                           + cells[:, 2]).int())


@pytest.mark.parametrize("n_bins", [1, 64, 128, 2**20])
def test_bin_direction_key_stays_below_the_inactive_key(n_bins):
    corners = torch.tensor([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0], [0.999, -1.0, 1.0]])
    fbin = torch.tensor([0, n_bins - 1, n_bins // 2], dtype=torch.int32)
    key = k5s.bin_direction_key(*corners.unbind(1), fbin, n_bins)
    assert int(key.min()) >= 0 and int(key.max()) < 2**k5s.KEY_BITS < k5s.INACTIVE_KEY
    assert int(key[1]) == int(key.max())  # the last bin and the +x, +y, +z corner


def test_packet_order_of_no_packets():
    empty = torch.zeros(0)
    fields = {"dx": empty, "dy": empty, "dz": empty, "fbin": torch.zeros(0, dtype=torch.int32),
              "active": torch.zeros(0, dtype=torch.bool)}
    order, n_active = k5s.packet_order(fields, 8)
    assert order.numel() == 0 and int(n_active) == 0


def _spectral_fields(march, n=None):
    cols = march[4]
    fields = dict(zip(traversal.SpectralPacketBatch._fields, (torch.tensor(c) for c in cols)))
    return {k: v[:n] for k, v in fields.items()} if n is not None else fields


@pytest.mark.parametrize("case", ["cpu tensors", "int32 slots", "negative max_steps"])
def test_k5s_wrapper_refuses_what_the_kernel_does_not_take(march, case):
    root, children, chi_h, chi_he, _, default = march
    root, children = torch.tensor(root), torch.tensor(children)
    chi_h, chi_he = torch.tensor(chi_h), torch.tensor(chi_he)
    kw = dict(coarse_shape=(N,) * 3, max_level=LEVEL, eps=amr_traversal.wall_eps((N,) * 3, LEVEL))
    fields = _spectral_fields(march)
    C = chi_h.numel()
    if case == "cpu tensors":
        args, kw = (torch.zeros(BINS * C), fields), dict(kw, n_bins=BINS, max_steps=default)
        match = "trace_octree_spectral_cuda needs CUDA tensors, got cpu"
    elif case == "int32 slots":
        args, kw = (torch.zeros(1), fields), dict(kw, n_bins=2**31 // C + 1, max_steps=default)
        match = "n and n_bins \\* C must fit int32"
    else:
        args, kw = (torch.zeros(BINS * C), fields), dict(kw, n_bins=BINS, max_steps=-1)
        match = "max_steps >= 0"
    kernels.LAUNCHES.clear()
    with pytest.raises(ValueError, match=match):
        k5s.trace_octree_spectral_cuda(root, children, chi_h, chi_he, *args, **kw)
    assert kernels.LAUNCHES[k5s.NAME] == 0


class _Function:
    """A stand-in for a library's launcher: records its calls, returns 0."""

    def __init__(self):
        self.calls, self.argtypes, self.restype = [], None, None

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    """Device 0 current, raw stream 1000 + index; every library's symbols
    are stand-ins (the CPU has neither a card nor nvcc).  Returns the
    functions by symbol."""
    functions = {}

    class Library:
        def __getattr__(self, symbol):
            return functions.setdefault(symbol, _Function())

    monkeypatch.setattr(launch, "load_library", lambda name: Library())
    monkeypatch.setattr(launch, "raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(launch, "current_device", lambda: index_seen[0])
    monkeypatch.setattr(launch.torch.cuda, "device", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(k5s._LAUNCH, "function", None)
    monkeypatch.setattr(compact._PARTITION, "function", None)
    index_seen = [-1]  # the CPU's device index stands in for the card's
    return functions


def test_k5s_binds_once_and_passes_its_arguments(march, monkeypatch, stand_in):
    # the checks pass CUDA tensors only: here they are the CPU's, so the
    # device check is left out and the rest of the wrapper runs as on the card
    root, children, chi_h, chi_he, _, default = march
    root, children = torch.tensor(root), torch.tensor(children)
    chi_h, chi_he = torch.tensor(chi_h), torch.tensor(chi_he)
    monkeypatch.setattr(k5s, "check_tensors", lambda *args: None)
    fields = _spectral_fields(march, 500)
    tally = torch.zeros(BINS * chi_h.numel())
    eps = amr_traversal.wall_eps((N,) * 3, LEVEL)
    kernels.LAUNCHES.clear()
    for _ in range(2):
        k5s.trace_octree_spectral_cuda(root, children, chi_h, chi_he, tally, fields,
                                       coarse_shape=(N,) * 3, max_level=LEVEL, n_bins=BINS,
                                       eps=eps, max_steps=default)
    function = stand_in["cmi_trace_octree_spectral"]
    assert k5s._LAUNCH.function is function and function.argtypes == k5s._LAUNCH.argtypes
    assert kernels.LAUNCHES[k5s.NAME] == 2 and len(function.calls) == 2
    args = function.calls[0]
    arrays = {"root": root, "children": children, "chi_h": chi_h, "chi_he": chi_he,
              "tally": tally, **fields}
    assert list(args[:18]) == [arrays[f].data_ptr() for f in k5s._POINTER_ORDER]
    assert args[20:] == (500, N, N, N, chi_h.numel(), LEVEL, default, eps, 1000 - 1)
    # no packet: no launch
    k5s.trace_octree_spectral_cuda(root, children, chi_h, chi_he, tally,
                                   _spectral_fields(march, 0), coarse_shape=(N,) * 3,
                                   max_level=LEVEL, n_bins=BINS, eps=eps, max_steps=default)
    assert len(function.calls) == 2 and kernels.LAUNCHES[k5s.NAME] == 2


def _partition_args(n=3000, n_fields=8, seed=2):
    rng = np.random.default_rng(seed)
    fields = tuple(torch.tensor(rng.standard_normal(n).astype(np.float32))
                   for _ in range(n_fields))
    codes = torch.tensor(rng.choice([-1, 0, 1], size=n).astype(np.int8))
    return fields, codes


@pytest.mark.parametrize("case, match", [
    ("cpu tensors", "partition_cuda needs CUDA tensors, got cpu"),
    ("one bucket", "two buckets: two capacities and two shifts"),
    ("nine fields", "1 to 8 fields, got 9"),
])
def test_k9p_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    fields, codes = _partition_args()
    caps = (100, 100)
    if case == "one bucket":
        caps = (100,)
    elif case == "nine fields":
        fields = fields + fields[:1]
    kernels.LAUNCHES.clear()
    with pytest.raises(ValueError, match=match):
        compact.partition_cuda(fields, codes, caps)
    assert kernels.LAUNCHES[compact.PARTITION] == 0


def _cpu_as_card(monkeypatch):
    """K9p's checks and its occupancy query on the CPU (the device check and
    the query need a card): 2 blocks a SM on 132 SMs."""
    def check(label, fields, codes, code_dtype):
        if codes.dtype != code_dtype:
            raise ValueError(f"{label}: codes must be {code_dtype}")
        return tuple(fields), codes.device, codes.numel()

    monkeypatch.setattr(compact, "_check", check)
    monkeypatch.setattr(compact, "occupancy",
                        lambda device: {"registers": 40, "blocks_per_sm": 2, "sms": 132})
    monkeypatch.setattr(compact, "raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(compact, "_SCRATCH", {})
    monkeypatch.setattr(compact, "_RESIDENT", {})


@pytest.mark.parametrize("capacities", [(-1, 5), (5, 2**31)])
def test_k9p_wrapper_refuses_capacities_past_int32(monkeypatch, stand_in, capacities):
    _cpu_as_card(monkeypatch)
    fields, codes = _partition_args()
    with pytest.raises(ValueError, match="capacities must be in"):
        compact.partition_cuda(fields, codes, capacities)


@pytest.mark.parametrize("n_fields, capacities, shifts", [
    (8, (531_250, 531_250), (16.0, -16.0)),
    (3, (700, 4000), (None, 0.1)),
    (1, (0, 0), (None, None)),
])
def test_k9p_binds_once_and_passes_one_buffer(monkeypatch, stand_in, n_fields, capacities,
                                              shifts):
    _cpu_as_card(monkeypatch)
    fields, codes = _partition_args(n_fields=n_fields)
    kernels.LAUNCHES.clear()
    out = compact.partition_cuda(fields, codes, capacities, shifts)
    again = compact.partition_cuda(fields, codes, capacities, shifts)
    function = stand_in["cmi_partition"]
    assert compact._PARTITION.function is function and len(function.calls) == 2
    assert kernels.LAUNCHES[compact.PARTITION] == 2
    args = function.calls[0]
    c0, c1 = capacities
    assert list(args[:8]) == [f.data_ptr() for f in fields] + [0] * (8 - n_fields)
    assert args[8] == codes.data_ptr()
    buffer = out[0][1].untyped_storage()
    assert args[9] == buffer.data_ptr() and buffer.nbytes() == 32 + (4 * n_fields + 1) * (c0 + c1)
    assert args[10] == function.calls[1][10]  # the scratch, kept for this device and stream
    assert args[11:] == (3000, n_fields, c0, c1, shifts[0] is not None, shifts[1] is not None,
                         264, 0.0 if shifts[0] is None else shifts[0],
                         0.0 if shifts[1] is None else shifts[1], 1000 - 1)
    scratch = compact._SCRATCH[(-1, 999)]
    n_tiles = -(-max(3000, c0, c1) // 256)
    assert scratch.dtype == torch.int32 and scratch.numel() == 2 + 2 * 264 + 16 * n_tiles
    assert not bool(scratch.any())
    for (f, r, o), cap in zip(out, capacities):
        assert len(f) == n_fields and all(t.shape == (cap,) and t.dtype == torch.float32
                                          for t in f)
        assert r.shape == (cap,) and r.dtype == torch.bool
        assert o.dim() == 0 and o.dtype == torch.int64
        assert all(t.untyped_storage().data_ptr() == buffer.data_ptr() for t in (*f, r, o))
    assert again[0][1].untyped_storage().data_ptr() != buffer.data_ptr()  # a buffer a call


@pytest.mark.parametrize("capacities", [(5, 5), (3, 7), (0, 4)])
def test_partition_views_read_the_kernels_layout(capacities):
    # the layout cmi_partition writes: 32 B of counts, bucket 0's fields,
    # bucket 1's, then in_range of bucket 0 and of bucket 1
    c0, c1 = capacities
    n_fields = 3
    counts = np.array([11, 12, 13, 14], np.int64)
    floats = np.arange(n_fields * (c0 + c1), dtype=np.float32)
    flags = np.arange(c0 + c1) % 3 == 0
    raw = np.concatenate([counts.view(np.uint8), floats.view(np.uint8), flags.view(np.uint8)])
    (f0, r0, o0), (f1, r1, o1) = compact.partition_views(torch.tensor(raw), n_fields,
                                                         capacities)
    rows0 = floats[:n_fields * c0].reshape(n_fields, c0)
    rows1 = floats[n_fields * c0:].reshape(n_fields, c1)
    for got, rows in ((f0, rows0), (f1, rows1)):
        assert len(got) == n_fields
        for t, row in zip(got, rows):
            np.testing.assert_array_equal(t.numpy(), row)
    np.testing.assert_array_equal(r0.numpy(), flags[:c0])
    np.testing.assert_array_equal(r1.numpy(), flags[c0:])
    assert (int(o0), int(o1)) == (12, 14)
