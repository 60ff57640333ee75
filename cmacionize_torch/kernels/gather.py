"""K11 and K11r, the per-index gathers (``csrc/gather.cu``), with their
plain versions.

:func:`gather` (``out[i] = tbl[idx[i]]``) and :func:`gather2d`
(``out = tbl2[rows, lanes]`` for index blocks of any one shape) dispatch on
the device: CPU tensors run :func:`gather_reference` /
:func:`gather2d_reference`, CUDA tensors launch the kernel, which counts its
launches in ``kernels.LAUNCHES["gather"]`` / ``["gather2d"]``.  There is no
fallback between the two.  The wrappers check devices, dtypes, shapes and
contiguity; they do not check the indices (that would read them back to the
host), so they must lie in the table.

Both launch through :mod:`kernels.launch` (a launcher typed once,
PyTorch's raw stream, an identity check of each tensor).  The ctypes path
here (:func:`_check`, :func:`_function`, :func:`_launch`) serves the older
wrappers of the package.
"""

from __future__ import annotations

import ctypes

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import load_library
from cmacionize_torch.kernels.launch import Launcher, _first_wrong, check_pair

NAME = "gather"
F32, I32 = torch.float32, torch.int32
_GATHER = Launcher(NAME, "cmi_gather", 3, 1)
_GATHER2D = Launcher(NAME, "cmi_gather2d", 4, 2)


def gather_reference(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K11: ``tbl[idx]`` of a 1D table."""
    return tbl[idx]


def gather2d_reference(tbl2: torch.Tensor, rows: torch.Tensor, lanes: torch.Tensor):
    """Plain version of K11r: ``tbl2[rows, lanes]`` of a 2D table, for index
    blocks of one shape."""
    return tbl2[rows, lanes]


def _function(name: str, n_pointers: int, n_ints: int, library: str = NAME):
    """``name`` of the library of ``csrc/<library>.cu``, typed: pointers,
    then ints, then the stream."""
    fn = getattr(load_library(library), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(label, tensors, device):
    """Each (name, tensor, dtype, dim) lies on ``device`` with that dtype, that
    number of dimensions (any where dim is None) and contiguous."""
    for name, t, dtype, dim in tensors:
        if t.device != device or t.dtype != dtype or dim not in (None, t.dim()):
            shape = "" if dim is None else f"{dim}D "
            raise ValueError(
                f"{label}: {name} must be a {shape}{dtype} tensor on {device}; "
                f"got {t.dim()}D {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{label}: {name} must be contiguous")


def _launch(label, fn, *args):
    device = args[0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{label}: CUDA error {err} at launch")


def check_gather(tbl: torch.Tensor, idx: torch.Tensor) -> tuple:
    """K11's checks: (device index, n) of its launch, or ValueError."""
    index = check_pair("gather", "tbl", tbl, F32, 1, "idx", idx, I32, 1)
    n = idx.numel()
    if max(tbl.numel(), n) >= 2**31:
        raise ValueError("gather: sizes must fit int32")
    return index, n


def gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = tbl[idx[i]]``: tbl f32 [N], idx int32 [n] → f32 [n]."""
    if tbl.device.type == "cpu":
        return gather_reference(tbl, idx)
    index, n = check_gather(tbl, idx)
    out = torch.empty_like(idx, dtype=F32)
    _GATHER(index, tbl.data_ptr(), idx.data_ptr(), out.data_ptr(), n)
    LAUNCHES["gather"] += 1
    return out


def check_gather2d(tbl2: torch.Tensor, rows: torch.Tensor, lanes: torch.Tensor) -> tuple:
    """K11r's checks: (device index, n, width) of its launch, or
    ValueError."""
    index = check_pair("gather2d", "tbl2", tbl2, F32, 2, "rows", rows, I32, None)
    if not (lanes.dtype is I32 and lanes.shape == rows.shape and lanes.get_device() == index
            and lanes.is_contiguous()):
        if lanes.shape != rows.shape:
            raise ValueError(f"gather2d: rows and lanes must have one shape; got "
                             f"{list(rows.shape)} and {list(lanes.shape)}")
        raise ValueError(_first_wrong("gather2d", rows.device, (("lanes", lanes, I32, None),)))
    n = rows.numel()
    if max(tbl2.numel(), n) >= 2**31:
        raise ValueError("gather2d: sizes must fit int32")
    return index, n, tbl2.shape[1]


def gather2d(tbl2: torch.Tensor, rows: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """``out = tbl2[rows, lanes]``: tbl2 f32 [R, W], rows and lanes int32 of
    one shape (any number of dimensions) → f32 of that shape."""
    if tbl2.device.type == "cpu":
        return gather2d_reference(tbl2, rows, lanes)
    index, n, width = check_gather2d(tbl2, rows, lanes)
    out = torch.empty_like(rows, dtype=F32)
    _GATHER2D(index, tbl2.data_ptr(), rows.data_ptr(), lanes.data_ptr(), out.data_ptr(), n, width)
    LAUNCHES["gather2d"] += 1
    return out
