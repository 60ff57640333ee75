"""K12t, K12r, K12s and K12a, the dynamic-indexing probes
(``csrc/probe_gather.cu``), with their plain versions.

:func:`take_along_lanes` (``out[t, 0] = blk[t, idx[t, 0]]``),
:func:`row_gather` (``out[t, :] = tab[idx[t], :]``), :func:`sublane_gather`
(``out[s, l] = tab[idx[s, l], l]``) and :func:`scatter_add` (``out = 0``, then
``out.flat[idx.flat] += val.flat``) dispatch on the device: CPU tensors run
their ``*_reference``, CUDA tensors launch the kernel, which counts its
launches in ``kernels.LAUNCHES`` under the wrapper's name.  There is no
fallback between the two.  The wrappers check devices, dtypes, shapes and
contiguity; they do not check the indices (that would read them back to the
host), so they must lie in the table, as for :mod:`kernels.gather`.

K12s, K12t and K12r launch through :mod:`kernels.launch` (a launcher typed
once, PyTorch's raw stream, an identity check of each tensor), K12a through
the ctypes path of :mod:`kernels.gather`.
"""

from __future__ import annotations

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.gather import _check, _function, _launch
from cmacionize_torch.kernels.launch import Launcher, check_pair

NAME = "probe_gather"
F32, I32 = torch.float32, torch.int32
_SUBLANE_GATHER = Launcher(NAME, "cmi_sublane_gather", 3, 2)
_TAKE_ALONG_LANES = Launcher(NAME, "cmi_take_along_lanes", 3, 2)
_ROW_GATHER = Launcher(NAME, "cmi_row_gather", 3, 2)


def take_along_lanes_reference(blk: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K12t: ``take_along_dim`` on dim 1."""
    return torch.take_along_dim(blk, idx.long(), 1)


def row_gather_reference(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K12r: ``tab[idx]`` of a 2D table."""
    return tab[idx]


def sublane_gather_reference(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K12s: ``gather`` on dim 0."""
    return torch.gather(tab, 0, idx.long())


def scatter_add_reference(idx: torch.Tensor, val: torch.Tensor, out_shape) -> torch.Tensor:
    """Plain version of K12a: zeros of ``out_shape`` with ``val`` added at the
    flat indices ``idx``, duplicates accumulated."""
    out = torch.zeros(out_shape, dtype=torch.float32, device=val.device)
    out.view(-1).index_put_((idx.reshape(-1).long(),), val.reshape(-1), accumulate=True)
    return out


def _fits_int32(label, *sizes):
    if max(sizes) >= 2**31:
        raise ValueError(f"{label}: sizes must fit int32")


def check_take_along_lanes(blk: torch.Tensor, idx: torch.Tensor) -> tuple:
    """K12t's checks: (device index, rows, width) of its launch, or
    ValueError."""
    index = check_pair("take_along_lanes", "blk", blk, F32, 2, "idx", idx, I32, 2)
    rows, width = blk.shape
    if idx.shape != (rows, 1):
        raise ValueError(f"take_along_lanes: idx must be [{rows}, 1]; got {list(idx.shape)}")
    _fits_int32("take_along_lanes", rows * width)
    return index, rows, width


def take_along_lanes(blk: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[t, 0] = blk[t, idx[t, 0]]``: blk f32 [T, W], idx int32 [T, 1] →
    f32 [T, 1]."""
    if not blk.is_cuda and blk.device.type == "cpu":
        return take_along_lanes_reference(blk, idx)
    index, rows, width = check_take_along_lanes(blk, idx)
    out = torch.empty_like(idx, dtype=F32)
    _TAKE_ALONG_LANES(index, blk.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, width)
    LAUNCHES["take_along_lanes"] += 1
    return out


def check_row_gather(tab: torch.Tensor, idx: torch.Tensor) -> tuple:
    """K12r's checks: (device index, rows, width) of its launch, or
    ValueError."""
    index = check_pair("row_gather", "tab", tab, F32, 2, "idx", idx, I32, 1)
    rows, width = idx.shape[0], tab.shape[1]
    _fits_int32("row_gather", tab.numel(), rows * width)
    return index, rows, width


def row_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[t, :] = tab[idx[t], :]``: tab f32 [R, W], idx int32 [T] → f32
    [T, W]."""
    if not tab.is_cuda and tab.device.type == "cpu":
        return row_gather_reference(tab, idx)
    index, rows, width = check_row_gather(tab, idx)
    out = tab.new_empty((rows, width))
    _ROW_GATHER(index, tab.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, width)
    LAUNCHES["row_gather"] += 1
    return out


def check_sublane_gather(tab: torch.Tensor, idx: torch.Tensor) -> tuple:
    """K12s's checks: (device index, n, width) of its launch, or
    ValueError."""
    index = check_pair("sublane_gather", "tab", tab, F32, 2, "idx", idx, I32, 2)
    (rows, width), (sublanes, lanes) = tab.shape, idx.shape
    if lanes != width:
        raise ValueError(f"sublane_gather: idx must have the table's {width} lanes; "
                         f"got {lanes}")
    _fits_int32("sublane_gather", sublanes * lanes, rows * width)
    return index, sublanes * lanes, width


def sublane_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[s, l] = tab[idx[s, l], l]``: tab f32 [R, L], idx int32 [S, L] →
    f32 [S, L]."""
    if not tab.is_cuda and tab.device.type == "cpu":
        return sublane_gather_reference(tab, idx)
    index, n, width = check_sublane_gather(tab, idx)
    out = torch.empty_like(idx, dtype=F32)
    _SUBLANE_GATHER(index, tab.data_ptr(), idx.data_ptr(), out.data_ptr(), n, width)
    LAUNCHES["sublane_gather"] += 1
    return out


def scatter_add(idx: torch.Tensor, val: torch.Tensor, out_shape) -> torch.Tensor:
    """Zeros of ``out_shape`` (f32) with ``out.flat[idx.flat] += val.flat``:
    idx int32 and val f32 of one shape; duplicates accumulate (on the card
    by atomics, in no fixed order)."""
    if val.device.type == "cpu":
        return scatter_add_reference(idx, val, out_shape)
    _check("scatter_add", (("idx", idx, torch.int32, val.dim()), ("val", val, torch.float32,
                                                                  val.dim())), val.device)
    if idx.shape != val.shape:
        raise ValueError(f"scatter_add: idx and val must have one shape; got "
                         f"{list(idx.shape)} and {list(val.shape)}")
    out = torch.empty(out_shape, dtype=torch.float32, device=val.device)
    _fits_int32("scatter_add", idx.numel(), out.numel())
    _launch("scatter_add", _function("cmi_scatter_add", 3, 2, NAME), idx, val, out, idx.numel(),
            out.numel())
    LAUNCHES["scatter_add"] += 1
    return out
