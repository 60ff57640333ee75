"""The launch path of K12s and K12t (``cmacionize_torch/kernels/launch.py``)
on the CPU.

The CPU has no card and no ``nvcc``, so what is held here is what a wrapper
does around its launch: the module imports, builds and binds nothing until a
kernel launches; a :class:`Launcher` types its function once, launches on
the raw stream, enters the device's context only when the device is not the
current one and raises RuntimeError on a failed launch (a stand-in library
on the CPU); :func:`check_pair` and the wrappers' checks raise ValueError on
each wrong argument the CPU can show (a dtype, a dimension count, a
contiguity, a tensor off the card, a shape, a size past int32); the wrappers
of K12s and K12t run their plain versions on CPU tensors and refuse any other
non-CUDA tensor; every launcher names an ``extern "C"`` function of its
source with the arguments it passes.  The kernels themselves, on the card,
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
from cmacionize_torch.kernels import build, launch, probe_gather

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
