"""The launch path of K11r, K12s, K12t, K12r, K13f and K14c
(``cmacionize_torch/kernels/launch.py``) on the CPU.

The CPU has no card and no ``nvcc``, so what is held here is what a wrapper
does around its launch: the module imports, builds and binds nothing until a
kernel launches; a :class:`Launcher` types its function once, launches on
the raw stream, enters the device's context only when the device is not the
current one and raises RuntimeError on a failed launch (a stand-in library
on the CPU); :func:`check_pair`, :func:`check_one` and the wrappers' checks
raise ValueError on each wrong argument the CPU can show (a dtype, a
dimension count, a contiguity, a tensor off the card, a shape, an alignment,
a size past int32); the wrappers run their plain versions on CPU tensors and
refuse any other non-CUDA tensor; every launcher names an ``extern "C"``
function of its source with the arguments it passes.  The kernels themselves, on the card,
on a side stream and in a CUDA graph, are in tests/test_torch_cuda.py; their
plain versions against the JAX Pallas bodies in
tests/test_torch_probe_pallas_gather.py.
"""

import contextlib
import ctypes
import importlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from cmacionize_torch import kernels
from cmacionize_torch.kernels import build, gather, launch, probe_cohort, probe_deposit, probe_gather

F32, I32 = torch.float32, torch.int32


def test_import_builds_and_binds_nothing():
    code = (
        "import sys\n"
        "from cmacionize_torch.kernels import build, launch, probe_gather\n"
        "assert not build._LIBRARIES\n"
        "assert probe_gather._SUBLANE_GATHER.function is None\n"
        "assert probe_gather._TAKE_ALONG_LANES.function is None\n"
        "assert 'jax' not in sys.modules\n"
    )
    env = {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent"}  # no nvcc
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=build.CSRC_DIR.parent.parent, check=False)
    assert proc.returncode == 0, proc.stderr


class _Function:
    """A stand-in for a library's launcher: records its calls, returns
    ``code``."""

    def __init__(self, code=0):
        self.code, self.calls, self.argtypes, self.restype = code, [], None, None

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


@pytest.fixture
def fake_card(monkeypatch):
    """Device 0 current, raw stream 1000 + index, ``torch.cuda.device``
    recording the indices it enters; the library of any name holds one
    :class:`_Function` per symbol.  Returns (loads, functions, entered)."""
    loads, functions, entered = [], {}, []

    class Library:
        def __getattr__(self, symbol):
            return functions.setdefault(symbol, _Function())

    def load_library(name):
        loads.append(name)
        return Library()

    @contextlib.contextmanager
    def device(index):
        entered.append(index)
        yield

    monkeypatch.setattr(launch, "load_library", load_library)
    monkeypatch.setattr(launch, "raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(launch, "current_device", lambda: 0)
    monkeypatch.setattr(launch.torch.cuda, "device", device)
    return loads, functions, entered


def test_launcher_binds_on_first_call_only(fake_card):
    loads, functions, entered = fake_card
    launcher = launch.Launcher("probe_gather", "cmi_sublane_gather", 3, 2)
    assert (launcher.library, launcher.symbol, launcher.function) == (
        "probe_gather", "cmi_sublane_gather", None)
    assert launcher.argtypes == [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    launcher(0, 1, 2, 3, 4, 5)  # binds, then launches
    function = functions["cmi_sublane_gather"]
    assert launcher.function is function and loads == ["probe_gather"]
    assert function.argtypes == launcher.argtypes and function.restype is ctypes.c_int
    launcher(0, 6, 7, 8, 9, 10)
    assert loads == ["probe_gather"]  # bound once
    assert function.calls == [(1, 2, 3, 4, 5, 1000), (6, 7, 8, 9, 10, 1000)]
    assert entered == []  # device 0 is the current one


def test_launcher_enters_another_device_only(fake_card):
    _, functions, entered = fake_card
    launcher = launch.Launcher("probe_gather", "cmi_take_along_lanes", 3, 2)
    launcher(1, 1, 2, 3, 4, 5)
    launcher(0, 1, 2, 3, 4, 5)
    launcher(2, 1, 2, 3, 4, 5)
    assert entered == [1, 2]
    assert [call[-1] for call in functions["cmi_take_along_lanes"].calls] == [1001, 1000, 1002]


@pytest.mark.parametrize("index", [0, 1])
def test_launcher_raises_on_a_failed_launch(fake_card, index):
    _, functions, _ = fake_card
    functions["cmi_sublane_gather"] = _Function(code=700)
    launcher = launch.Launcher("probe_gather", "cmi_sublane_gather", 3, 2)
    with pytest.raises(RuntimeError, match="cmi_sublane_gather: CUDA error 700 at launch"):
        launcher(index, 1, 2, 3, 4, 5)


def _pair(a_shape=(4, 8), b_shape=(2, 8), a_dtype=F32, b_dtype=I32, device="meta"):
    return (torch.empty(a_shape, dtype=a_dtype, device=device),
            torch.empty(b_shape, dtype=b_dtype, device=device))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_check_pair_refuses_tensors_off_the_card(device):
    a, b = _pair(device=device)
    with pytest.raises(ValueError, match=r"k: tab must be a 2D torch.float32 tensor on a CUDA "
                                         rf"device; got 2D torch.float32 on {device}"):
        launch.check_pair("k", "tab", a, F32, 2, "idx", b, I32, 2)


def _wrong(which):
    """(tab, idx) with one thing wrong: the dtype, the dimension count or the
    contiguity of one of them."""
    tab, idx = torch.zeros((16, 8)), torch.zeros((4, 8), dtype=I32)
    changes = {
        "tab dtype": lambda: (tab.double(), idx),
        "idx dtype": lambda: (tab, idx.long()),
        "tab dim": lambda: (tab.reshape(-1), idx),
        "idx dim": lambda: (tab, idx.reshape(2, 2, 8)),
        "tab contiguity": lambda: (tab.t().contiguous().t(), idx),
        "idx contiguity": lambda: (tab, torch.stack([idx, idx], -1)[..., 0]),
    }
    return changes[which]()


WRONG = {
    "tab dtype": "tab must be a 2D torch.float32 tensor on cpu; got 2D torch.float64 on cpu",
    "idx dtype": "idx must be a 2D torch.int32 tensor on cpu; got 2D torch.int64 on cpu",
    "tab dim": "tab must be a 2D torch.float32 tensor on cpu; got 1D torch.float32 on cpu",
    "idx dim": "idx must be a 2D torch.int32 tensor on cpu; got 3D torch.int32 on cpu",
    "tab contiguity": "tab must be contiguous",
    "idx contiguity": "idx must be contiguous",
}


@pytest.mark.parametrize("which", sorted(WRONG))
def test_each_wrong_argument_is_named(which):
    # the message names the first wrong argument (the CPU standing in for
    # the card's device); check_pair raises on the same tensors, first for
    # their device
    tab, idx = _wrong(which)
    tensors = (("tab", tab, F32, 2), ("idx", idx, I32, 2))
    assert launch._first_wrong("k", torch.device("cpu"), tensors) == f"k: {WRONG[which]}"
    with pytest.raises(ValueError, match="k: tab must be .* on a CUDA device"):
        launch.check_pair("k", "tab", tab, F32, 2, "idx", idx, I32, 2)


def test_stream_and_device_lookups_are_absent_without_cuda():
    # this torch is built for the CPU only: the wrappers never reach a launch
    cuda = hasattr(torch._C, "_cuda_getCurrentRawStream")
    assert (launch.raw_stream is None) == (launch.current_device is None) == (not cuda)


@pytest.mark.parametrize("name, make", [
    ("sublane_gather", lambda rng: (rng.normal(size=(2048, 128)).astype(np.float32),
                                    rng.integers(0, 2048, (8, 128)).astype(np.int32))),
    ("take_along_lanes", lambda rng: (rng.normal(size=(512, 128)).astype(np.float32),
                                      rng.integers(0, 128, (512, 1)).astype(np.int32))),
])
def test_wrappers_run_the_plain_version_on_cpu_tensors(name, make):
    table, idx = make(np.random.default_rng(3))
    kernels.LAUNCHES.clear()
    out = getattr(probe_gather, name)(torch.from_numpy(table), torch.from_numpy(idx))
    lanes = np.arange(table.shape[1])
    expected = (table[idx, lanes] if name == "sublane_gather"
                else np.take_along_axis(table, idx, 1))
    np.testing.assert_array_equal(out.numpy(), expected)
    assert kernels.LAUNCHES[name] == 0
    assert probe_gather._SUBLANE_GATHER.function is None
    assert probe_gather._TAKE_ALONG_LANES.function is None


@pytest.mark.parametrize("name, shapes", [
    ("sublane_gather", ((2048, 128), (8, 128))),
    ("take_along_lanes", ((512, 128), (512, 1))),
])
def test_wrappers_refuse_tensors_neither_on_the_cpu_nor_on_the_card(name, shapes):
    table = torch.empty(shapes[0], device="meta")
    idx = torch.empty(shapes[1], dtype=I32, device="meta")
    with pytest.raises(ValueError, match="on a CUDA device; got 2D torch.float32 on meta"):
        getattr(probe_gather, name)(table, idx)


@pytest.mark.parametrize("name, shapes, message", [
    ("sublane_gather", ((2048, 128), (8, 64)), "idx must have the table's 128 lanes; got 64"),
    ("sublane_gather", ((2**24, 128), (8, 128)), "sizes must fit int32"),
    ("sublane_gather", ((16, 128), (2**24, 128)), "sizes must fit int32"),
    ("take_along_lanes", ((512, 128), (256, 1)), r"idx must be \[512, 1\]; got \[256, 1\]"),
    ("take_along_lanes", ((512, 128), (512, 2)), r"idx must be \[512, 1\]; got \[512, 2\]"),
    ("take_along_lanes", ((2**24, 128), (2**24, 1)), "sizes must fit int32"),
])
def test_checks_refuse_wrong_shapes_and_sizes(monkeypatch, name, shapes, message):
    # past check_pair (as if the tensors lay on the card): the shapes, and the
    # sizes the kernels index with int
    monkeypatch.setattr(probe_gather, "check_pair", lambda *args: 0)
    table = torch.empty(shapes[0], device="meta")
    idx = torch.empty(shapes[1], dtype=I32, device="meta")
    with pytest.raises(ValueError, match=f"{name}: {message}"):
        getattr(probe_gather, f"check_{name}")(table, idx)


@pytest.mark.parametrize("name, shapes, sizes", [
    ("sublane_gather", ((2048, 128), (8, 128)), (1024, 128)),
    ("take_along_lanes", ((8192, 128), (8192, 1)), (8192, 128)),
])
def test_checks_give_the_launch_sizes(monkeypatch, name, shapes, sizes):
    monkeypatch.setattr(probe_gather, "check_pair", lambda *args: 3)
    table = torch.empty(shapes[0], device="meta")
    idx = torch.empty(shapes[1], dtype=I32, device="meta")
    assert getattr(probe_gather, f"check_{name}")(table, idx) == (3, *sizes)


_SIGNATURE = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def _launchers() -> dict:
    """Every Launcher at the top of a module of the package that imports
    kernels.launch, by its qualified name."""
    package = build.CSRC_DIR.parent
    found = {}
    for path in sorted(package.rglob("*.py")):
        if "kernels.launch import" not in path.read_text():
            continue
        name = ".".join((package.name, *path.relative_to(package).with_suffix("").parts))
        for attr, value in vars(importlib.import_module(name)).items():
            if isinstance(value, launch.Launcher):
                found[f"{name}.{attr}"] = value
    return found


def test_every_launcher_names_a_launcher_of_its_source():
    launchers = _launchers()
    assert {"cmacionize_torch.kernels.probe_gather._SUBLANE_GATHER",
            "cmacionize_torch.kernels.probe_gather._TAKE_ALONG_LANES"} <= set(launchers)
    for where, launcher in launchers.items():
        source = (build.CSRC_DIR / f"{launcher.library}.cu").read_text()
        signatures = {symbol: [p.strip() for p in params.split(",")]
                      for symbol, params in _SIGNATURE.findall(source)}
        assert launcher.symbol in signatures, where
        params = signatures[launcher.symbol]
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int if p.startswith("int ") else p
                 for p in params]
        assert kinds == launcher.argtypes, (where, params)
        assert params[-1] == "void* stream", where


# -- K12r and K14c ------------------------------------------------------------------------------


def test_k12r_and_k14c_launchers_are_found_and_bind_nothing_at_import():
    # the signature test above holds every Launcher it finds against its
    # source; these two are among them, and importing builds and binds nothing
    assert {"cmacionize_torch.kernels.probe_gather._ROW_GATHER",
            "cmacionize_torch.kernels.probe_cohort._STREAM_ROWS"} <= set(_launchers())
    assert (probe_gather._ROW_GATHER.symbol, probe_cohort._STREAM_ROWS.symbol) == (
        "cmi_row_gather", "cmi_stream_rows")
    code = (
        "from cmacionize_torch.kernels import build, probe_cohort, probe_gather\n"
        "assert not build._LIBRARIES\n"
        "assert probe_gather._ROW_GATHER.function is None\n"
        "assert probe_cohort._STREAM_ROWS.function is None\n"
    )
    env = {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent"}  # no nvcc
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=build.CSRC_DIR.parent.parent, check=False)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_check_one_refuses_a_tensor_off_the_card(device):
    pk = torch.empty((2, 16, 128), device=device)
    with pytest.raises(ValueError, match=r"k: pk must be a 3D torch.float32 tensor on a CUDA "
                                         rf"device; got 3D torch.float32 on {device}"):
        launch.check_one("k", "pk", pk, F32, 3)


@pytest.mark.parametrize("which, message", [
    ("dtype", "pk must be a 3D torch.float32 tensor on cpu; got 3D torch.float64 on cpu"),
    ("dim", "pk must be a 3D torch.float32 tensor on cpu; got 2D torch.float32 on cpu"),
    ("contiguity", "pk must be contiguous"),
])
def test_check_one_names_the_wrong_property(which, message):
    pk = torch.zeros((2, 16, 128))
    wrong = {"dtype": pk.double(), "dim": pk.reshape(2, -1),
             "contiguity": pk.transpose(1, 2).contiguous().transpose(1, 2)}[which]
    assert launch._first_wrong("k", torch.device("cpu"), (("pk", wrong, F32, 3),)) == f"k: {message}"
    with pytest.raises(ValueError, match="k: pk must be .* on a CUDA device"):
        launch.check_one("k", "pk", wrong, F32, 3)


ROW_GATHER_WRONG = {
    "tab dtype": "tab must be a 2D torch.float32 tensor on cpu; got 2D torch.float64 on cpu",
    "idx dtype": "idx must be a 1D torch.int32 tensor on cpu; got 1D torch.int64 on cpu",
    "tab dim": "tab must be a 2D torch.float32 tensor on cpu; got 1D torch.float32 on cpu",
    "idx dim": "idx must be a 1D torch.int32 tensor on cpu; got 2D torch.int32 on cpu",
    "tab contiguity": "tab must be contiguous",
    "idx contiguity": "idx must be contiguous",
}


@pytest.mark.parametrize("which", sorted(ROW_GATHER_WRONG))
def test_check_row_gather_names_each_wrong_argument(which):
    # K12r's idx is 1D; the CPU stands in for the card's device
    tab, idx = torch.zeros((16, 8)), torch.zeros(32, dtype=I32)
    tab, idx = {
        "tab dtype": lambda: (tab.double(), idx),
        "idx dtype": lambda: (tab, idx.long()),
        "tab dim": lambda: (tab.reshape(-1), idx),
        "idx dim": lambda: (tab, idx.reshape(4, 8)),
        "tab contiguity": lambda: (tab.t().contiguous().t(), idx),
        "idx contiguity": lambda: (tab, idx[::2]),
    }[which]()
    tensors = (("tab", tab, F32, 2), ("idx", idx, I32, 1))
    assert launch._first_wrong("row_gather", torch.device("cpu"), tensors) == \
        f"row_gather: {ROW_GATHER_WRONG[which]}"
    with pytest.raises(ValueError, match="row_gather: tab must be .* on a CUDA device"):
        probe_gather.check_row_gather(tab, idx)


@pytest.mark.parametrize("shapes, sizes", [
    (((4096, 64), (8192,)), (8192, 64)),
    (((4096, 63), (2**20,)), (2**20, 63)),
])
def test_check_row_gather_gives_the_launch_sizes(monkeypatch, shapes, sizes):
    monkeypatch.setattr(probe_gather, "check_pair", lambda *args: 2)
    tab = torch.empty(shapes[0], device="meta")
    idx = torch.empty(shapes[1], dtype=I32, device="meta")
    assert probe_gather.check_row_gather(tab, idx) == (2, *sizes)


@pytest.mark.parametrize("shapes", [((2**25, 64), (8,)), ((4096, 64), (2**25,))])
def test_check_row_gather_refuses_sizes_past_int32(monkeypatch, shapes):
    monkeypatch.setattr(probe_gather, "check_pair", lambda *args: 0)
    tab = torch.empty(shapes[0], device="meta")
    idx = torch.empty(shapes[1], dtype=I32, device="meta")
    with pytest.raises(ValueError, match="row_gather: sizes must fit int32"):
        probe_gather.check_row_gather(tab, idx)


def _unaligned(shape):
    """A contiguous CPU tensor of ``shape`` that starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.zeros(int(np.prod(shape)) + 4)
    offset = next(k for k in range(4) if (flat.data_ptr() + 4 * k) % 16 == 4)
    return flat[offset:offset + int(np.prod(shape))].view(shape)


@pytest.mark.parametrize("make, message", [
    (lambda: torch.zeros((2, 8, 128)), r"pk must be \[N, 16, 128\]; got \[2, 8, 128\]"),
    (lambda: torch.zeros((2, 16, 64)), r"pk must be \[N, 16, 128\]; got \[2, 16, 64\]"),
    (lambda: _unaligned((2, 16, 128)), "pk must be 16-byte aligned"),
    (lambda: torch.empty((2**20, 16, 128), device="meta"), "pk must have fewer than 2\\^31 elements"),
])
def test_check_stream_rows_refuses_shapes_alignment_and_sizes(monkeypatch, make, message):
    # past check_one (as if the tensor lay on the card)
    monkeypatch.setattr(probe_cohort, "check_one", lambda *args: 0)
    with pytest.raises(ValueError, match=f"stream_rows: {message}"):
        probe_cohort.check_stream_rows(make())


def test_check_stream_rows_gives_the_launch_sizes(monkeypatch):
    monkeypatch.setattr(probe_cohort, "check_one", lambda *args: 1)
    assert probe_cohort.check_stream_rows(torch.zeros((7, 16, 128))) == (1, 7)
    assert probe_cohort.check_stream_rows(
        torch.empty((2**20 - 1, 16, 128), device="meta")) == (1, 2**20 - 1)


@pytest.mark.parametrize("make, message", [
    (lambda: torch.zeros((2, 16, 128), dtype=torch.float64), "got 3D torch.float64 on cpu"),
    (lambda: torch.zeros((2, 2048)), "got 2D torch.float32 on cpu"),
    (lambda: torch.zeros((2, 128, 16)).transpose(1, 2), "got 3D torch.float32 on cpu"),
])
def test_stream_rows_check_names_the_tensor_off_the_card(make, message):
    with pytest.raises(ValueError, match=f"stream_rows: pk must be .* on a CUDA device; {message}"):
        probe_cohort.check_stream_rows(make())


def test_stream_chunk_matches_the_source():
    source = (build.CSRC_DIR / "probe_cohort.cu").read_text()
    assert f"constexpr int kChunk = {probe_cohort.STREAM_CHUNK};" in source


def test_row_gather_and_stream_rows_run_the_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(4)
    table = rng.normal(size=(4096, 64)).astype(np.float32)
    idx = rng.integers(0, 4096, 8192).astype(np.int32)
    pk = rng.normal(size=(9, 16, 128)).astype(np.float32)
    kernels.LAUNCHES.clear()
    out = probe_gather.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), table[idx])
    rows, s = probe_cohort.stream_rows(torch.from_numpy(pk))
    expected = pk.copy()
    expected[:, 2] = pk[:, 0] + pk[:, 1]
    np.testing.assert_array_equal(rows.numpy(), expected)
    np.testing.assert_allclose(float(s), float((pk[:, 0].astype(np.float64) * pk[:, 1]).sum()),
                               rtol=1e-5)
    assert kernels.LAUNCHES["row_gather"] == kernels.LAUNCHES["stream_rows"] == 0
    assert probe_gather._ROW_GATHER.function is None and probe_cohort._STREAM_ROWS.function is None


def test_row_gather_and_stream_rows_refuse_meta_tensors():
    tab, idx = torch.empty((4096, 64), device="meta"), torch.empty(8192, dtype=I32, device="meta")
    with pytest.raises(ValueError, match="row_gather: tab must be a 2D torch.float32 tensor on a "
                                         "CUDA device; got 2D torch.float32 on meta"):
        probe_gather.row_gather(tab, idx)
    with pytest.raises(ValueError, match="stream_rows: pk must be a 3D torch.float32 tensor on a "
                                         "CUDA device; got 3D torch.float32 on meta"):
        probe_cohort.stream_rows(torch.empty((8, 16, 128), device="meta"))


# -- K11r and K13f ------------------------------------------------------------------------------


def test_k11r_and_k13f_launchers_are_found_and_bind_nothing_at_import():
    # the signature test above holds every Launcher it finds against its
    # source; these two are among them, and importing builds and binds nothing
    assert {"cmacionize_torch.kernels.gather._GATHER2D",
            "cmacionize_torch.kernels.probe_deposit._FILL_FIRST"} <= set(_launchers())
    assert (gather._GATHER2D.library, gather._GATHER2D.symbol) == ("gather", "cmi_gather2d")
    assert (probe_deposit._FILL_FIRST.library, probe_deposit._FILL_FIRST.symbol) == (
        "probe_deposit", "cmi_fill_first")
    code = (
        "from cmacionize_torch.kernels import build, gather, probe_deposit\n"
        "from cmacionize_torch.tools import probe_deposit2, probe_pallas_gather\n"
        "assert not build._LIBRARIES\n"
        "assert gather._GATHER2D.function is None\n"
        "assert probe_deposit._FILL_FIRST.function is None\n"
    )
    env = {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent"}  # no nvcc
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=build.CSRC_DIR.parent.parent, check=False)
    assert proc.returncode == 0, proc.stderr


def _gather2d_args(shape=(64, 128)):
    return (torch.zeros((2048, 128)), torch.zeros(shape, dtype=I32),
            torch.zeros(shape, dtype=I32))


GATHER2D_WRONG = {
    "tbl2 dtype": ("tbl2 must be a 2D torch.float32 tensor on a CUDA device; "
                   "got 2D torch.float64 on cpu"),
    "tbl2 dim": ("tbl2 must be a 2D torch.float32 tensor on a CUDA device; "
                 "got 1D torch.float32 on cpu"),
    "tbl2 contiguity": ("tbl2 must be a 2D torch.float32 tensor on a CUDA device; "
                        "got 2D torch.float32 on cpu"),
    "rows dtype": "rows must be a torch.int32 tensor on cpu; got 2D torch.int64 on cpu",
    "rows contiguity": "rows must be contiguous",
    "lanes dtype": "lanes must be a torch.int32 tensor on cpu; got 2D torch.int64 on cpu",
    "lanes shape": r"rows and lanes must have one shape; got \[64, 128\] and \[128, 64\]",
    "lanes 3D": r"rows and lanes must have one shape; got \[64, 128\] and \[4, 16, 128\]",
    "lanes contiguity": "lanes must be contiguous",
    "lanes device": "lanes must be a torch.int32 tensor on cpu; got 2D torch.int32 on meta",
}


def _wrong_gather2d(which):
    tbl2, rows, lanes = _gather2d_args()
    return {
        "tbl2 dtype": lambda: (tbl2.double(), rows, lanes),
        "tbl2 dim": lambda: (tbl2.reshape(-1), rows, lanes),
        "tbl2 contiguity": lambda: (tbl2.t().contiguous().t(), rows, lanes),
        "rows dtype": lambda: (tbl2, rows.long(), lanes),
        "rows contiguity": lambda: (tbl2, rows.t().contiguous().t(), lanes),
        "lanes dtype": lambda: (tbl2, rows, lanes.long()),
        "lanes shape": lambda: (tbl2, rows, lanes.reshape(128, 64)),
        "lanes 3D": lambda: (tbl2, rows, lanes.reshape(4, 16, 128)),
        "lanes contiguity": lambda: (tbl2, rows, lanes.t().contiguous().t()),
        "lanes device": lambda: (tbl2, rows, torch.empty((64, 128), dtype=I32, device="meta")),
    }[which]()


@pytest.mark.parametrize("which", sorted(GATHER2D_WRONG))
def test_check_gather2d_names_each_wrong_argument(monkeypatch, which):
    # the CPU stands in for the card's device: check_pair gives index 0 where
    # the table and rows would pass on the card, and each check below it
    # names the wrong argument (lanes, on the CPU, is never on device 0)
    tbl2, rows, lanes = _wrong_gather2d(which)
    if which.startswith("tbl2"):
        with pytest.raises(ValueError, match=f"gather2d: {GATHER2D_WRONG[which]}"):
            gather.check_gather2d(tbl2, rows, lanes)
        return
    real = launch.check_pair

    def on_cpu(label, a_name, a, a_dtype, a_dim, b_name, b, b_dtype, b_dim):
        if a.dtype is a_dtype and b.dtype is b_dtype and b.is_contiguous():
            return 0
        raise ValueError(launch._first_wrong(label, a.device, (
            (a_name, a, a_dtype, a_dim), (b_name, b, b_dtype, b_dim))))

    monkeypatch.setattr(gather, "check_pair", on_cpu)
    with pytest.raises(ValueError, match=f"gather2d: {GATHER2D_WRONG[which]}"):
        gather.check_gather2d(tbl2, rows, lanes)
    with pytest.raises(ValueError, match="gather2d: .* on a CUDA device"):
        real("gather2d", "tbl2", tbl2, F32, 2, "rows", rows, I32, None)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_check_gather2d_refuses_tensors_off_the_card(device):
    tbl2, rows, lanes = (t.to(device) for t in _gather2d_args())
    with pytest.raises(ValueError, match=r"gather2d: tbl2 must be a 2D torch.float32 tensor on a "
                                         rf"CUDA device; got 2D torch.float32 on {device}"):
        gather.check_gather2d(tbl2, rows, lanes)


def test_gather2d_refuses_meta_tensors():
    tbl2, rows, lanes = (t.to("meta") for t in _gather2d_args())
    with pytest.raises(ValueError, match="gather2d: tbl2 must be .* on a CUDA device; got 2D "
                                         "torch.float32 on meta"):
        gather.gather2d(tbl2, rows, lanes)


@pytest.mark.parametrize("shapes", [((2**24, 128), (8,)), ((2048, 128), (2**31,)),
                                    ((2048, 128), (2**16, 2**15))])
def test_check_gather2d_refuses_sizes_past_int32(monkeypatch, shapes):
    monkeypatch.setattr(gather, "check_pair", lambda *args: 0)
    tbl2 = torch.empty(shapes[0], device="meta")
    rows = torch.empty(shapes[1], dtype=I32, device="meta")
    lanes = torch.empty(shapes[1], dtype=I32, device="meta")
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    with pytest.raises(ValueError, match="gather2d: sizes must fit int32"):
        gather.check_gather2d(tbl2, rows, lanes)


@pytest.mark.parametrize("table, index, sizes", [
    ((2048, 128), (64, 128), (8192, 128)),
    ((2048, 128), (4, 16, 128), (8192, 128)),
    ((2048, 128), (2**20 - 3,), (2**20 - 3, 128)),
    ((4096, 64), (7, 3, 5, 2), (210, 64)),
])
def test_check_gather2d_gives_the_launch_sizes(monkeypatch, table, index, sizes):
    # index blocks of any shape; n is their element count, the width the table's
    monkeypatch.setattr(gather, "check_pair", lambda *args: 3)
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 3)
    tbl2 = torch.empty(table, device="meta")
    rows, lanes = (torch.empty(index, dtype=I32, device="meta") for _ in range(2))
    assert gather.check_gather2d(tbl2, rows, lanes) == (3, *sizes)


FILL_FIRST_WRONG = {
    "dtype": ("dep must be a torch.float32 tensor on a CUDA device; "
              "got 2D torch.float64 on cpu"),
    "contiguity": ("dep must be a torch.float32 tensor on a CUDA device; "
                   "got 2D torch.float32 on cpu"),
}


@pytest.mark.parametrize("which", sorted(FILL_FIRST_WRONG))
def test_check_fill_first_names_the_wrong_property(which):
    dep = torch.zeros((8, 128))
    wrong = {"dtype": dep.double(), "contiguity": dep.t()}[which]
    with pytest.raises(ValueError, match=f"fill_first: {FILL_FIRST_WRONG[which]}"):
        probe_deposit.check_fill_first(wrong)
    message = {"dtype": "dep must be a torch.float32 tensor on cpu; got 2D torch.float64 on cpu",
               "contiguity": "dep must be contiguous"}[which]
    assert launch._first_wrong("fill_first", torch.device("cpu"),
                               (("dep", wrong, F32, None),)) == f"fill_first: {message}"


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_check_fill_first_refuses_a_tensor_off_the_card(device):
    with pytest.raises(ValueError, match=r"fill_first: dep must be a torch.float32 tensor on a "
                                         rf"CUDA device; got 2D torch.float32 on {device}"):
        probe_deposit.check_fill_first(torch.zeros((8, 128), device=device))
    if device == "meta":  # the wrapper runs the plain version on the CPU only
        with pytest.raises(ValueError, match="fill_first: dep must be .* on a CUDA device"):
            probe_deposit.fill_first(torch.zeros((8, 128), device=device))


@pytest.mark.parametrize("shape, message", [
    ((0, 128), "dep must not be empty"),
    ((2**31,), "sizes must fit int32"),
])
def test_check_fill_first_refuses_empty_and_huge_tensors(monkeypatch, shape, message):
    monkeypatch.setattr(probe_deposit, "check_one", lambda *args: 0)
    with pytest.raises(ValueError, match=f"fill_first: {message}"):
        probe_deposit.check_fill_first(torch.empty(shape, device="meta"))


@pytest.mark.parametrize("shape", [(8, 128), (1,), (2, 3, 4), (2**31 - 1,)])
def test_check_fill_first_gives_the_launch_device(monkeypatch, shape):
    # any number of dimensions; the launch takes no size, only the device
    monkeypatch.setattr(probe_deposit, "check_one", lambda *args: 5)
    assert probe_deposit.check_fill_first(torch.empty(shape, device="meta")) == (5,)


def test_gather2d_and_fill_first_run_the_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(6)
    table = rng.normal(size=(2048, 128)).astype(np.float32)
    hi = rng.integers(0, 2048, (4, 16, 128)).astype(np.int32)
    lo = rng.integers(0, 128, (4, 16, 128)).astype(np.int32)
    dep = rng.normal(size=(8, 128)).astype(np.float32)
    dep[0, 0] = -0.0
    kernels.LAUNCHES.clear()
    out = gather.gather2d(*(torch.from_numpy(a) for a in (table, hi, lo)))
    np.testing.assert_array_equal(out.numpy(), table[hi, lo])
    first = probe_deposit.fill_first(torch.from_numpy(dep))
    assert first.shape == (1, 128)
    np.testing.assert_array_equal(first.numpy().view(np.int32),
                                  np.full((1, 128), dep[0, 0]).view(np.int32))
    assert kernels.LAUNCHES["gather2d"] == kernels.LAUNCHES["fill_first"] == 0
    assert gather._GATHER2D.function is None and probe_deposit._FILL_FIRST.function is None


# -- tools/launch_cost.py: what it times, on the CPU ----------------------------------------------


@pytest.mark.parametrize("label", ["K11r", "K12s", "K12t", "K12r", "K12a", "K13f", "K14c"])
def test_launch_cost_library_calls_compute_the_wrappers_functions(label):
    # the one PyTorch call timed beside each wrapper computes its function
    # (K14c's pk.clone() moves the same bytes: every row but row 2); on CPU
    # tensors the wrappers run their plain versions and launch nothing
    from cmacionize_torch.tools import launch_cost

    n = {"K11r": 1027, "K12s": 1024, "K12t": 256, "K12r": 512, "K12a": 1024, "K13f": 1024,
         "K14c": 5}[label]
    args = launch_cost.seeded_inputs(label, n, "cpu", np.random.default_rng(len(label) + n))
    wrapper = launch_cost.KERNELS[label][0]
    kernels.LAUNCHES.clear()
    out, library = wrapper(*args), launch_cost.library_call(label, args)()
    if label == "K14c":
        rows = [0, 1, *range(3, 16)]
        assert torch.equal(out[0][:, rows], library[:, rows])
    else:
        assert torch.equal(out.reshape(-1), library.reshape(-1))
    assert sum(kernels.LAUNCHES.values()) == 0


def test_launch_cost_bounds_count_each_byte_once():
    from cmacionize_torch.tools import launch_cost, probe_cohort_kernel, probe_pallas_gather

    # K12r at the probe's shapes: (7t) mod 4096 touches the whole 1 MB table,
    # then 8192 indices and 2 MB out (chip_smoke.py's 0.000949 ms)
    _, args = probe_pallas_gather.b_row_gather("cpu")
    assert launch_cost.bound_ms("K12r", args) == pytest.approx(
        (4 * 8192 * 65 + 4096 * 64 * 4) / 3.35e12 * 1e3)
    assert launch_cost.bound_ms("K12r", args) == pytest.approx(0.000949, abs=5e-7)
    # K14c: 15 rows of each item read (row 2 out is row 0 + row 1), 16 written
    (pk,) = probe_cohort_kernel.c_inputs("meta")
    assert launch_cost.bound_ms("K14c", (pk,)) == pytest.approx(
        (15 + 16) * 128 * 4 * pk.shape[0] / 3.35e12 * 1e3)
    assert launch_cost.bound_ms("K14c", (pk,)) == pytest.approx(0.036994, abs=5e-7)
    assert launch_cost.LARGER["K14c"] == 2 * pk.shape[0]
    idx, val = probe_pallas_gather.b_scatter_add("cpu")[1]
    assert launch_cost.bound_ms("K12a", (idx, val)) == pytest.approx(
        4 * (2 * idx.numel() + probe_pallas_gather.SCATTER_N) / 3.35e12 * 1e3)
    # K11r at the flat 2D probe's shape: 8 bytes of indices in and 4 out a
    # lookup, and the 6452 distinct sectors that (97t) mod 2^18 touches
    # (chip_smoke.py's 0.000091 ms)
    tab, hi, lo = probe_pallas_gather.b_flat_gather_2d("cpu")[1]
    assert launch_cost.bound_ms("K11r", (tab, hi, lo)) == pytest.approx(
        (12 * 8192 + 32 * 6452) / 3.35e12 * 1e3)
    assert launch_cost.bound_ms("K11r", (tab, hi, lo)) == pytest.approx(0.000091, abs=5e-7)
    # at 2^20 seeded lookups every sector of the 1 MB table is touched
    n = launch_cost.LARGER["K11r"]
    args = launch_cost.seeded_inputs("K11r", n, "cpu", np.random.default_rng(1))
    assert launch_cost.bound_ms("K11r", args) == pytest.approx(
        (12 * n + 4 * 2048 * 128) / 3.35e12 * 1e3)
    assert launch_cost.bound_ms("K11r", args) == pytest.approx(0.004069, abs=5e-7)
    # K13f: the one element it copies in, 128 out
    assert launch_cost.bound_ms("K13f", (torch.zeros((8, 128)),)) == pytest.approx(
        516 / 3.35e12 * 1e3)
    assert launch_cost.LARGER["K13f"] is None


def test_launch_cost_splits_each_path_on_its_kernels():
    from cmacionize_torch.tools import launch_cost

    assert set(launch_cost.NEW_PATH) == {"K11r", "K12s", "K12t", "K12r", "K13f"}
    assert launch_cost.OLD_PATH == "K12a" and launch_cost.OLD_PATH not in launch_cost.NEW_PATH
    assert set(launch_cost.KERNELS) == set(launch_cost.LIBRARY) == set(launch_cost.LARGER)
    libraries = {"K11r": "gather", "K13f": "probe_deposit"}
    for label, (launcher, _, _) in launch_cost.NEW_PATH.items():
        assert isinstance(launcher, launch.Launcher)
        assert launcher.library == libraries.get(label, "probe_gather")
        assert launch_cost.KERNELS[label][0].__module__ == f"cmacionize_torch.kernels.{launcher.library}"
