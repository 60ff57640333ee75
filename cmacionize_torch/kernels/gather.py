"""K11 and K11r, the per-index gathers (``csrc/gather.cu``), with their
plain versions.

:func:`gather` (``out[i] = tbl[idx[i]]``) and :func:`gather2d`
(``out[i] = tbl2[rows[i], lanes[i]]``) dispatch on the device: CPU tensors
run :func:`gather_reference` / :func:`gather2d_reference`, CUDA tensors
launch the kernel, which counts its launches in ``kernels.LAUNCHES["gather"]``
/ ``["gather2d"]``.  There is no fallback between the two.  The wrapper
checks devices, dtypes, shapes and contiguity; it does not check the indices
(that would read them back to the host), so they must lie in the table.
"""

from __future__ import annotations

import ctypes

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import load_library

NAME = "gather"


def gather_reference(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K11: ``tbl[idx]`` of a 1D table."""
    return tbl[idx]


def gather2d_reference(tbl2: torch.Tensor, rows: torch.Tensor, lanes: torch.Tensor):
    """Plain version of K11r: ``tbl2[rows, lanes]`` of a 2D table."""
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


def gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = tbl[idx[i]]``: tbl f32 [N], idx int32 [n] → f32 [n]."""
    if tbl.device.type == "cpu":
        return gather_reference(tbl, idx)
    _check("gather", (("tbl", tbl, torch.float32, 1), ("idx", idx, torch.int32, 1)),
           tbl.device)
    if max(tbl.numel(), idx.numel()) >= 2**31:
        raise ValueError("gather: sizes must fit int32")
    out = torch.empty(idx.shape, dtype=torch.float32, device=tbl.device)
    _launch("gather", _function("cmi_gather", 3, 1), tbl, idx, out, idx.numel())
    LAUNCHES["gather"] += 1
    return out


def gather2d(tbl2: torch.Tensor, rows: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """``out[i] = tbl2[rows[i], lanes[i]]``: tbl2 f32 [R, W], rows and lanes
    int32 [n] → f32 [n]."""
    if tbl2.device.type == "cpu":
        return gather2d_reference(tbl2, rows, lanes)
    _check("gather2d", (("tbl2", tbl2, torch.float32, 2), ("rows", rows, torch.int32, 1),
                        ("lanes", lanes, torch.int32, 1)), tbl2.device)
    if rows.shape != lanes.shape or max(tbl2.numel(), rows.numel()) >= 2**31:
        raise ValueError("gather2d: rows and lanes must have one shape; sizes must fit int32")
    out = torch.empty(rows.shape, dtype=torch.float32, device=tbl2.device)
    _launch("gather2d", _function("cmi_gather2d", 4, 2), tbl2, rows, lanes, out,
            rows.numel(), tbl2.shape[1])
    LAUNCHES["gather2d"] += 1
    return out
