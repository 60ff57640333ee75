"""K9c on segments and K9p's one view a bucket, on the CPU.

K9c compacts the concatenation of one to three segments (the copy phase's
one, the slab merge's two received buffers, the 3D exchange's kept lanes and
two received buffers) without forming it.  Its plain form,
``compact_segments_reference``, places every lane where the kernel places it
(a member at its rank among the members, any other lane g at count + g -
rank); it must equal ``compact_reference`` of the concatenation and JAX's
``_compact`` of the ``jnp.concatenate`` bit for bit, as the merges of
``cmacionize_tpu/parallel/domain.py`` and ``domain3d.py`` form them.

The wrappers of K9c and K9p (``kernels/compact.py``) and K7
(``kernels/voronoi_flux.py``) run here on a stand-in library (the CPU has
neither a card nor nvcc): their refusals, their binding, the arguments they
pass and the views they hand back of their one output buffer.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch import kernels
from cmacionize_torch.kernels import compact, launch, voronoi_flux
from cmacionize_torch.parallel import domain
from cmacionize_tpu.parallel import domain as jax_domain


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _segment(rng, n, members, shift=None):
    """8 fields of ``n`` lanes (-0.0 in field 0 of a tenth) and a mask:
    "none", "all" or a share; with ``shift``, the lanes past the members
    hold K9p's padding (zeros, field 0 at 0 + shift)."""
    fields = rng.standard_normal((8, n)).astype(np.float32)
    fields[0, : n // 10] = -0.0
    share = {"none": 0.0, "all": 1.0}.get(members, members)
    mask = rng.uniform(size=n) < share
    if shift is not None:  # a K9p bucket: members first, then its shifted padding
        count = int(mask.sum())
        mask = np.arange(n) < count
        fields[:, count:] = 0.0
        fields[0, count:] = np.float32(0.0) + np.float32(shift)
    return fields, mask


CASES = {
    "one": [(1000, 0.3)],
    "one, none": [(700, "none")],
    "one, all": [(700, "all")],
    "two merges": [(500, 0.05), (500, 0.2)],
    "two, empty first": [(0, "all"), (800, 0.4)],
    "two K9p buckets": [(600, 0.1, 16.0), (600, 0.3, -16.0)],
    "three": [(400, 0.5), (300, "none"), (350, "all")],
    "three, empty middle": [(250, 0.3), (0, 0.3), (333, 0.6)],
    "three, 3D exchange": [(900, 0.2), (200, 0.4, None), (200, 0.1, None)],
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("capacity", ["below", "equal", "above"])
def test_segmented_plain_form_equals_compact_reference_and_jax(case, capacity):
    rng = np.random.default_rng(len(case) * 7 + len(capacity))
    parts = [_segment(rng, *spec) for spec in CASES[case]]
    n = sum(m.shape[0] for _, m in parts)
    capacity = {"below": n // 3, "equal": n, "above": n + 123}[capacity]
    segments = [(torch.from_numpy(f), torch.from_numpy(m)) for f, m in parts]
    out, in_range, over = domain.compact_segments_reference(segments, capacity)
    whole_fields = np.concatenate([f for f, _ in parts], axis=1)
    whole_mask = np.concatenate([m for _, m in parts])
    ref, ref_range, ref_over = domain.compact_reference(
        tuple(torch.from_numpy(f) for f in whole_fields), torch.from_numpy(whole_mask), capacity)
    jax_out, jax_range, jax_over = jax_domain._compact(
        tuple(jnp.concatenate([jnp.asarray(f[k]) for f, _ in parts]) for k in range(8)),
        jnp.concatenate([jnp.asarray(m) for _, m in parts]), capacity)
    assert out.shape == (8, capacity)
    for got, plain, want in zip(out, ref, jax_out):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(plain.numpy()))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(in_range.numpy(), ref_range.numpy())
    np.testing.assert_array_equal(in_range.numpy(), np.asarray(jax_range))
    assert int(over) == int(ref_over) == int(jax_over) == max(int(whole_mask.sum()) - capacity, 0)
    # the CPU path of compact_segments: the same, stacked, from tuples or rows
    for form in (lambda f: f, lambda f: tuple(f)):
        got, got_range, got_over = domain.compact_segments(
            [(form(f), m) for f, m in segments], capacity)
        assert torch.equal(got.view(torch.int32), out.view(torch.int32))
        assert torch.equal(got_range, in_range) and int(got_over) == int(over)


def test_merges_take_the_received_buffers_as_segments():
    """The slab merge's segments are K9p's two buckets as ``partition``
    gives them ([8, capacity] each); compacting them equals JAX's merge
    (concatenate, then _compact) bit for bit, the shifted padding included."""
    rng = np.random.default_rng(3)
    n = 3000
    fields = rng.standard_normal((8, n)).astype(np.float32)
    bucket = rng.choice([-1, 0, 1], size=n, p=[0.8, 0.1, 0.1]).astype(np.int8)
    sends = domain.partition(torch.from_numpy(fields), torch.from_numpy(bucket), (700, 700),
                             (16.0, -16.0))
    assert all(f.shape == (8, 700) for f, _, _ in sends)
    segments = [(f, m) for f, m, _ in sends]
    for capacity in (600, 1400, 2000):
        out, in_range, over = domain.compact_segments(segments, capacity)
        ref = jax_domain._compact(
            tuple(jnp.concatenate([jnp.asarray(f[k].numpy()) for f, _ in segments])
                  for k in range(8)),
            jnp.concatenate([jnp.asarray(m.numpy()) for _, m in segments]), capacity)
        for got, want in zip(out, ref[0]):
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        np.testing.assert_array_equal(in_range.numpy(), np.asarray(ref[1]))
        assert int(over) == int(ref[2])


# ------------------------------------------------------- the wrappers, stand-in


class _Function:
    """A stand-in for a library's launcher: records its calls (a segment
    table's values as they were at the call), returns 0."""

    def __init__(self):
        self.calls, self.argtypes, self.restype = [], None, None

    def __call__(self, *args):
        self.calls.append(tuple(list(a) if hasattr(a, "_length_") else a for a in args))
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    """Device -1 current (the CPU's index), raw stream 1000 + index; every
    library's symbols are stand-ins.  Returns the functions by symbol."""
    functions = {}

    class Library:
        def __getattr__(self, symbol):
            return functions.setdefault(symbol, _Function())

    monkeypatch.setattr(launch, "load_library", lambda name: Library())
    monkeypatch.setattr(launch, "raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(launch, "current_device", lambda: -1)
    monkeypatch.setattr(launch.torch.cuda, "device", lambda index: contextlib.nullcontext())
    for launcher in (compact._COMPACT, compact._PARTITION, voronoi_flux._LAUNCH):
        monkeypatch.setattr(launcher, "function", None)
    return functions


def _cpu_as_card(monkeypatch):
    """K9c's and K9p's checks on the CPU (the device check needs a card) and
    their occupancy queries: 2 blocks a SM on 132 SMs for K9p, 3 for K9c."""
    original = compact._check

    def check(label, fields, codes, code_dtype):
        two_d = isinstance(fields, torch.Tensor)
        if not two_d and not 1 <= len(tuple(fields)) <= compact.MAX_FIELDS:
            return original(label, fields, codes, code_dtype)
        if codes.dtype != code_dtype:
            raise ValueError(f"{label}: codes must be {code_dtype}")
        return (fields if two_d else tuple(fields)), codes.device, codes.numel()

    monkeypatch.setattr(compact, "_check", check)
    monkeypatch.setattr(compact, "occupancy", lambda device, kernel=compact.PARTITION: {
        "registers": 40, "blocks_per_sm": 3 if kernel == compact.COMPACT else 2, "sms": 132})
    monkeypatch.setattr(compact, "raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(compact, "_SCRATCH", {})
    monkeypatch.setattr(compact, "_RESIDENT", {})


@pytest.mark.parametrize("segments, match", [
    ([], "1 to 3 segments"),
    ([(torch.zeros(4), torch.zeros(4, dtype=torch.bool))] * 4, "1 to 3 segments"),
    ([((torch.zeros(4),) * 9, torch.zeros(4, dtype=torch.bool))], "1 to 8 fields, got 9"),
    ([(torch.zeros(9, 4), torch.zeros(4, dtype=torch.bool))], "1 to 8 fields, got 9"),
    ([((torch.zeros(4),), torch.zeros(4, dtype=torch.bool))], "needs CUDA tensors, got cpu"),
])
def test_k9c_wrapper_refuses_what_the_kernel_does_not_take(segments, match):
    kernels.LAUNCHES.clear()
    with pytest.raises(ValueError, match=match):
        compact.compact_segments_cuda(segments, 4)
    with pytest.raises(ValueError, match="CUDA"):
        compact.compact_cuda((torch.zeros(4),), torch.zeros(4, dtype=torch.bool), 4)
    assert kernels.LAUNCHES[compact.COMPACT] == 0


def _stand_in_segments(sizes, seed=5):
    rng = np.random.default_rng(seed)
    wide = torch.tensor(rng.standard_normal((8, sum(sizes) + 50)).astype(np.float32))
    out, start = [], 3
    for i, n in enumerate(sizes):
        rows = wide[:, start:start + n]  # rows strided by the wide tensor's width
        fields = tuple(r.clone() for r in rows) if i == 1 else rows
        out.append((fields, torch.tensor(rng.uniform(size=n) < 0.3)))
        start += n
    return out


@pytest.mark.parametrize("sizes, capacity", [
    ((1000,), 1_000_000), ((531_250 // 100, 531_250 // 100), 10_000), ((700, 80, 0), 500),
])
def test_k9c_binds_once_and_passes_its_segment_table(monkeypatch, stand_in, sizes, capacity):
    _cpu_as_card(monkeypatch)
    segments = _stand_in_segments(sizes)
    kernels.LAUNCHES.clear()
    fields, in_range, over = compact.compact_segments_cuda(segments, capacity)
    again = compact.compact_segments_cuda(segments, capacity)
    function = stand_in["cmi_compact"]
    assert compact._COMPACT.function is function and len(function.calls) == 2
    assert function.argtypes == compact._COMPACT.argtypes
    assert kernels.LAUNCHES[compact.COMPACT] == 2
    table, out, scratch, n_segments, n_fields, cap, resident, stream = function.calls[0]
    assert (n_segments, n_fields, cap, resident, stream) == (len(sizes), 8, capacity, 396, 999)
    expected = []
    for f, m in segments:
        rows = [t.data_ptr() for t in f] if isinstance(f, tuple) else [
            f.data_ptr() + 4 * f.stride(0) * k for k in range(8)]
        expected += [m.data_ptr(), m.numel(), *rows]
    assert table[:len(expected)] == expected and len(table) == 30
    buffer = fields.untyped_storage()
    assert out == buffer.data_ptr() and buffer.nbytes() == 16 + 33 * capacity
    assert scratch == function.calls[1][2] == compact._SCRATCH[(-1, 999)].data_ptr()
    n_tiles = -(-max(sum(sizes), capacity) // 256)
    assert compact._SCRATCH[(-1, 999)].numel() == 2 + 2 * 396 + 16 * n_tiles
    # one view a part: fields [8, capacity] from byte 16, in_range after, the
    # overflow the second int64 of the counts
    assert fields.shape == (8, capacity) and fields.dtype == torch.float32
    assert fields.data_ptr() == out + 16 and fields.is_contiguous()
    assert in_range.shape == (capacity,) and in_range.dtype == torch.bool
    assert in_range.data_ptr() == out + 16 + 32 * capacity
    assert over.dim() == 0 and over.dtype == torch.int64 and over.data_ptr() == out + 8
    assert again[0].untyped_storage().data_ptr() != buffer.data_ptr()  # a buffer a call


def test_k9c_refuses_segments_that_differ(monkeypatch, stand_in):
    _cpu_as_card(monkeypatch)
    (f, m), _ = _stand_in_segments((40, 30))
    with pytest.raises(ValueError, match="every segment must hold 8 fields"):
        compact.compact_segments_cuda([(f, m), (f[:3], m)], 10)
    with pytest.raises(ValueError, match="capacity must be in"):
        compact.compact_segments_cuda([(f, m)], 2**31)
    assert "cmi_compact" not in stand_in or not stand_in["cmi_compact"].calls


@pytest.mark.parametrize("capacities", [(5, 5), (3, 7), (0, 4)])
def test_partition_views_give_one_view_a_bucket(capacities):
    # the layout cmi_partition writes: 32 B of counts, bucket 0's fields,
    # bucket 1's, then in_range of bucket 0 and of bucket 1
    c0, c1 = capacities
    n_fields = 3
    counts = np.array([11, 12, 13, 14], np.int64)
    floats = np.arange(n_fields * (c0 + c1), dtype=np.float32)
    flags = np.arange(c0 + c1) % 3 == 0
    raw = torch.tensor(np.concatenate([counts.view(np.uint8), floats.view(np.uint8),
                                       flags.view(np.uint8)]))
    (f0, r0, o0), (f1, r1, o1) = compact.partition_views(raw, n_fields, capacities)
    assert f0.shape == (n_fields, c0) and f1.shape == (n_fields, c1)
    np.testing.assert_array_equal(f0.numpy(), floats[:n_fields * c0].reshape(n_fields, c0))
    np.testing.assert_array_equal(f1.numpy(), floats[n_fields * c0:].reshape(n_fields, c1))
    assert c0 == 0 or f0.data_ptr() == raw.data_ptr() + 32  # an empty view has no address
    assert f1.data_ptr() == raw.data_ptr() + 32 + 4 * n_fields * c0
    np.testing.assert_array_equal(r0.numpy(), flags[:c0])
    np.testing.assert_array_equal(r1.numpy(), flags[c0:])
    assert (int(o0), int(o1)) == (12, 14)
    # K9c's layout: 16 B of counts, the fields, in_range
    k9c = compact.compact_views(raw[16:], n_fields, c0)
    assert k9c[0].shape == (n_fields, c0)
    assert c0 == 0 or k9c[0].data_ptr() == raw.data_ptr() + 32
    assert int(k9c[2]) == 14


def test_k9p_takes_the_rows_of_one_tensor(monkeypatch, stand_in):
    _cpu_as_card(monkeypatch)
    rng = np.random.default_rng(6)
    wide = torch.tensor(rng.standard_normal((8, 3100)).astype(np.float32))
    rows = wide[:, 40:3040]
    codes = torch.tensor(rng.choice([-1, 0, 1], size=3000).astype(np.int8))
    compact.partition_cuda(rows, codes, (900, 900), (16.0, -16.0))
    args = stand_in["cmi_partition"].calls[0]
    assert list(args[:8]) == [rows.data_ptr() + 4 * 3100 * k for k in range(8)]
    assert args[11:15] == (3000, 8, 900, 900)


# ---------------------------------------------------------------------- K7


def _k7_tables(C=50, K=12, seed=7):
    rng = np.random.default_rng(seed)
    nbr = torch.tensor(rng.integers(-2, C, (C, K)).astype(np.int32))
    f = lambda *shape: torch.tensor(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    return (nbr, f(C, K, 3), f(C, K), f(C, K, 3), f(C, K, 3)), tuple(f(C) for _ in range(5)), \
        f(C, 3)


@pytest.mark.parametrize("case, match", [
    ("four fields", "state must hold 5 fields"),
    ("flat rows", "neighbors must be"),
    ("257 slots", "at most 256 face slots a row, got K = 257"),
    ("cpu tensors", "needs CUDA tensors, got cpu"),
])
def test_k7_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    tables, state, gen_vel = _k7_tables(K=257 if case == "257 slots" else 12)
    if case == "four fields":
        state = state[:4]
    elif case == "flat rows":
        tables = (tables[0].reshape(-1),) + tables[1:]
    kernels.LAUNCHES.clear()
    with pytest.raises(ValueError, match=match):
        voronoi_flux.voronoi_flux_update_cuda(*tables, state, gen_vel, 1e10, gamma=5.0 / 3.0)
    assert kernels.LAUNCHES[voronoi_flux.NAME] == 0


@pytest.mark.parametrize("second_order", [True, False])
def test_k7_binds_once_and_passes_its_arguments(monkeypatch, stand_in, second_order):
    tables, state, gen_vel = _k7_tables()
    C, K = tables[0].shape
    monkeypatch.setattr(voronoi_flux, "_check", lambda *args: (C, K))
    monkeypatch.setattr(voronoi_flux, "raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(voronoi_flux, "_SCRATCH", {})
    kernels.LAUNCHES.clear()
    stats = {}
    out = voronoi_flux.voronoi_flux_update_cuda(*tables, state, gen_vel, 2e10, gamma=1.0001,
                                                second_order=second_order, stats=stats)
    voronoi_flux.voronoi_flux_update_cuda(*tables, state, gen_vel, 2e10, gamma=1.0001,
                                          second_order=second_order)
    function = stand_in["cmi_voronoi_flux"]
    assert voronoi_flux._LAUNCH.function is function and len(function.calls) == 2
    assert function.argtypes == voronoi_flux._LAUNCH.argtypes
    assert kernels.LAUNCHES[voronoi_flux.NAME] == 2
    args = function.calls[0]
    record, flag = voronoi_flux._SCRATCH[(-1, 999)]
    assert record.numel() == 32 * C and record.data_ptr() % 16 == 0  # float4 loads
    assert flag.numel() == 52 + 4  # the 50 flags padded to 52, then the int count
    assert list(args[:5]) == [f.data_ptr() for f in state]
    assert args[5] == out[0].data_ptr() and all(o.shape == (C,) for o in out)
    assert [out[q].data_ptr() - out[0].data_ptr() for q in range(5)] == [4 * C * q
                                                                         for q in range(5)]
    assert list(args[6:12]) == [t.data_ptr() for t in (*tables, gen_vel)]
    assert list(args[12:15]) == [record.data_ptr(), flag.data_ptr(), flag.data_ptr() + 52]
    assert args[15:18] == (C, K, int(second_order))
    consts = voronoi_flux.kernel_constants(1.0001, 2e10, 0.5)
    assert args[18:24] == tuple(float(v) for v in consts) and args[24] == 999
    assert function.calls[1][12] == record.data_ptr()  # kept for this device and stream
    assert set(stats) == ({"flag", "gradients"} if second_order else set())
    if second_order:  # the gradients are the records' floats [13, 28) as [5, C, 3]
        rows = record.view(C, 32)
        assert stats["gradients"].shape == (5, C, 3)
        assert torch.equal(stats["gradients"][2, 7], rows[7, 19:22])
