"""K14a, K14b and K14c, the cohort-traversal mechanics probes
(``csrc/probe_cohort.cu``), with their plain versions.

:func:`count_positive` (``run_a``: the number of positive counts in every
cell of [8, 128]), :func:`lane_gather_loop` (``run_b``: ``out[r, c] =
Σ_{i<nsteps} tab[r, (idx[r, c] + i) mod 128]`` in the order of i) and
:func:`stream_rows` (``run_c``: ``pk`` with row 2 of each [16, 128] item
replaced by row 0 + row 1, and the sum of row 0 · row 1) dispatch on the
device: CPU tensors run their ``*_reference``, CUDA tensors launch the
kernel, which counts its launches in ``kernels.LAUNCHES`` under the
wrapper's name.  There is no fallback between the two.  The wrappers check
devices, dtypes, shapes and contiguity.  K14c launches through
:mod:`kernels.launch` (a launcher typed once, PyTorch's raw stream), K14a and
K14b through the ctypes path of :mod:`kernels.gather`.
"""

from __future__ import annotations

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.gather import _check, _function, _launch
from cmacionize_torch.kernels.launch import Launcher, check_one

NAME = "probe_cohort"
LANES = 128
ITEM_ROWS = 16  # rows of one [16, 128] item of run_c's stream
COUNT_SHAPE = (8, LANES)  # run_a's output block
STREAM_CHUNK = 4  # items of K14c's chunks, one partial sum each (csrc/probe_cohort.cu:kChunk)
_STREAM_ROWS = Launcher(NAME, "cmi_stream_rows", 4, 1)


def count_positive_reference(cnt: torch.Tensor) -> torch.Tensor:
    """Plain version of K14a: ``#{m : cnt[m] > 0}`` in every cell of [8, 128]."""
    return (cnt > 0).sum().float().expand(COUNT_SHAPE).clone()


def lane_gather_loop_reference(tab: torch.Tensor, idx: torch.Tensor, nsteps: int = 1000):
    """Plain version of K14b: ``acc + gather`` in the order of i from 0."""
    idx64 = idx.long()
    acc = torch.zeros_like(tab)
    for i in range(nsteps):
        acc = acc + torch.gather(tab, 1, (idx64 + i) % LANES)
    return acc


def stream_rows_reference(pk: torch.Tensor):
    """Plain version of K14c: (``pk`` with ``[:, 2] = [:, 0] + [:, 1]``, the
    f32 sum of ``[:, 0] * [:, 1]`` as [1, 1])."""
    x, y = pk[:, 0], pk[:, 1]
    out = pk.clone()
    out[:, 2] = x + y
    return out, (x * y).sum().reshape(1, 1)


def count_positive(cnt: torch.Tensor) -> torch.Tensor:
    """f32 [8, 128] holding the number of positive entries of int32 ``cnt``
    [n] in every cell."""
    if cnt.device.type == "cpu":
        return count_positive_reference(cnt)
    _check("count_positive", (("cnt", cnt, torch.int32, 1),), cnt.device)
    if cnt.numel() >= 2**24:
        raise ValueError("count_positive: cnt must have fewer than 2^24 entries (exact in f32)")
    out = torch.empty(COUNT_SHAPE, dtype=torch.float32, device=cnt.device)
    _launch("count_positive", _function("cmi_count_positive", 2, 1, NAME), cnt, out, cnt.numel())
    LAUNCHES["count_positive"] += 1
    return out


def lane_gather_loop(tab: torch.Tensor, idx: torch.Tensor, nsteps: int = 1000) -> torch.Tensor:
    """``out[r, c] = Σ_{i<nsteps} tab[r, (idx[r, c] + i) mod 128]``, summed
    in the order of i from 0: tab f32 and idx int32 [R, 128] → f32 [R, 128]."""
    if tab.device.type == "cpu":
        return lane_gather_loop_reference(tab, idx, nsteps)
    _check("lane_gather_loop", (("tab", tab, torch.float32, 2), ("idx", idx, torch.int32, 2)),
           tab.device)
    if tab.shape[1] != LANES or idx.shape != tab.shape:
        raise ValueError(f"lane_gather_loop: tab and idx must be [R, {LANES}]; got "
                         f"{list(tab.shape)} and {list(idx.shape)}")
    if not 0 <= nsteps < 2**31 - LANES or tab.shape[0] >= 2**31:
        raise ValueError("lane_gather_loop: nsteps and the rows must fit int32")
    out = torch.empty_like(tab)
    _launch("lane_gather_loop", _function("cmi_lane_gather_loop", 3, 2, NAME), tab, idx, out,
            tab.shape[0], nsteps)
    LAUNCHES["lane_gather_loop"] += 1
    return out


def check_stream_rows(pk: torch.Tensor) -> tuple:
    """K14c's checks: (device index, items) of its launch, or ValueError."""
    index = check_one("stream_rows", "pk", pk, torch.float32, 3)
    if pk.shape[1:] != (ITEM_ROWS, LANES):
        raise ValueError(f"stream_rows: pk must be [N, {ITEM_ROWS}, {LANES}]; got "
                         f"{list(pk.shape)}")
    if pk.data_ptr() % 16 != 0:
        raise ValueError("stream_rows: pk must be 16-byte aligned")
    if pk.numel() >= 2**31:
        raise ValueError("stream_rows: pk must have fewer than 2^31 elements")
    return index, pk.shape[0]


def stream_rows(pk: torch.Tensor):
    """(``pk`` with row 2 of each item = row 0 + row 1, the sum of row 0 ·
    row 1 as f32 [1, 1]): pk f32 [N, 16, 128].  On the card the sum is
    reduced in a fixed order (per chunk of four items, then over the chunks
    in order), so repeated runs agree bit for bit."""
    if not pk.is_cuda and pk.device.type == "cpu":
        return stream_rows_reference(pk)
    index, items = check_stream_rows(pk)
    out = torch.empty_like(pk)
    s = pk.new_empty((1, 1))
    # the chunks' partial sums, then the two counters the launcher zeroes
    scratch = pk.new_empty(-(-items // STREAM_CHUNK) + 2)
    _STREAM_ROWS(index, pk.data_ptr(), out.data_ptr(), scratch.data_ptr(), s.data_ptr(), items)
    LAUNCHES["stream_rows"] += 1
    return out, s
