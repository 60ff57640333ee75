"""Wrappers of K9c and K9p, the packet exchange's stable compaction and
bucketed send partition (``csrc/compact.cu``).

The wrappers check what the kernels take (one CUDA device, 1-8 contiguous
f32 fields of one length, a bool mask or int8 buckets), allocate the outputs,
launch on PyTorch's current stream and raise if a launch was refused.  The
plain versions are :func:`cmacionize_torch.parallel.domain.compact_reference`
and ``partition_reference``.

K9c allocates each output and its scratch with ``torch.empty`` and launches
its three kernels through ctypes arrays.  K9p is one launch through
:mod:`cmacionize_torch.kernels.launch`: one output buffer a call, which the
wrapper hands back as views; its scratch (the grid barrier and the block
counts) kept per device and stream, zeroed once, and the count of blocks the
device holds at once per device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import load_library
from cmacionize_torch.kernels.launch import Launcher, kernel_occupancy, raw_stream

NAME = "compact"
COMPACT, PARTITION = "compact", "partition"  # the LAUNCHES keys of K9c, K9p
MAX_FIELDS = 8
LANES_PER_BLOCK = 1024  # kThreads in compact.cu (K9c)
PARTITION_TILE = 256  # kTile in compact.cu: K9p's lanes a tile and threads a block
COUNTS_BYTES = 32  # K9p's output buffer starts with two int64 {count, overflow}
_PARTITION = Launcher(NAME, "cmi_partition", MAX_FIELDS + 3, 7, 2)
_SCRATCH: dict = {}  # (device index, raw stream) → K9p's int32 scratch
_RESIDENT: dict = {}  # device index → blocks of K9p the device holds at once


def _launcher():
    fn = load_library(NAME).cmi_compact
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _check(label, fields, codes, code_dtype):
    fields = tuple(fields)
    if not 1 <= len(fields) <= MAX_FIELDS:
        raise ValueError(f"{label}: 1 to {MAX_FIELDS} fields, got {len(fields)}")
    if not codes.is_cuda:
        raise ValueError(f"{label} needs CUDA tensors, got {codes.device}")
    device, index, n = codes.device, codes.get_device(), codes.numel()
    if codes.dtype is not code_dtype or codes.dim() != 1 or not codes.is_contiguous():
        raise ValueError(f"{label}: codes must be a contiguous 1-D {code_dtype} tensor, "
                         f"got {codes.dtype} of shape {tuple(codes.shape)}")
    for i, f in enumerate(fields):
        if (f.dtype is torch.float32 and f.is_cuda and f.get_device() == index
                and f.dim() == 1 and f.numel() == n and f.is_contiguous()):
            continue
        if f.device != device or f.dtype != torch.float32 or f.dim() != 1 or f.numel() != n:
            raise ValueError(
                f"{label}: field {i} must be float32 of {n} elements on {device}; "
                f"got {f.dtype} of shape {tuple(f.shape)} on {f.device}")
        raise ValueError(f"{label}: field {i} must be contiguous")
    if n >= 2**31 - LANES_PER_BLOCK:
        raise ValueError(f"{label}: sizes must fit int32")
    return fields, device, n


def _run(label, fields, codes, n, device, capacities, shifts):
    n_buckets = len(capacities)
    if min(capacities) < 0 or max(capacities) >= 2**31 - LANES_PER_BLOCK:
        raise ValueError(f"{label}: capacities must be in [0, 2^31), got {capacities}")
    n_fields = len(fields)
    outs = [[torch.empty(c, dtype=torch.float32, device=device) for _ in range(n_fields)]
            for c in capacities]
    in_range = [torch.empty(c, dtype=torch.bool, device=device) for c in capacities]
    n_blocks = -(-n // LANES_PER_BLOCK)
    scratch = torch.empty(2 * n_buckets * n_blocks + n_buckets, dtype=torch.int32,
                          device=device)
    counts = torch.empty((n_buckets, 2), dtype=torch.int64, device=device)
    # the shift is a Python number meeting an f32 field: rounded once to f32
    shift_values = np.asarray([0.0 if s is None else s for s in shifts], np.float32)
    has_shift = np.asarray([s is not None for s in shifts], np.int32)
    caps = np.asarray(capacities, np.int32)
    ptrs_in = (ctypes.c_void_p * n_fields)(*(f.data_ptr() for f in fields))
    ptrs_out = (ctypes.c_void_p * (n_buckets * n_fields))(
        *(t.data_ptr() for row in outs for t in row))
    ptrs_range = (ctypes.c_void_p * n_buckets)(*(t.data_ptr() for t in in_range))
    launch = _launcher()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = launch(
            ptrs_in, n_fields, codes.data_ptr(), n, n_buckets, ptrs_out, ptrs_range,
            caps.ctypes.data, shift_values.ctypes.data, has_shift.ctypes.data,
            scratch.data_ptr(), counts.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{label}: CUDA error {err} at launch")
    return [(tuple(outs[b]), in_range[b], counts[b, 1]) for b in range(n_buckets)]


def compact_cuda(fields, mask: torch.Tensor, capacity: int):
    """K9c: the members of ``mask`` in input order, then the other lanes in
    input order, truncated to ``capacity`` and zero-padded past the input.

    Returns (fields [capacity] each, in_range [capacity] bool, overflow: a
    0-d int64 tensor, max(count - capacity, 0))."""
    fields, device, n = _check("compact_cuda", fields, mask, torch.bool)
    (result,) = _run("compact_cuda", fields, mask.view(torch.int8), n, device,
                     (int(capacity),), (None,))
    LAUNCHES[COMPACT] += 1
    return result


def occupancy(device) -> dict:
    """Registers per thread and blocks of 256 resident per SM of K9p, and the
    SM count of CUDA ``device``."""
    return kernel_occupancy(NAME, "cmi_partition_occupancy", device)


def _scratch(index: int, device, n_tiles: int) -> tuple:
    """K9p's scratch on this device and its current stream (the barrier's two
    words, zero, two counts a block and sixteen a tile, for at least
    ``n_tiles``), and the blocks the device holds at once: made at the first
    call on each, and the scratch made anew for more tiles.  Every call
    leaves the barrier's words at zero."""
    resident = _RESIDENT.get(index)
    if resident is None:
        layout = occupancy(device)
        resident = _RESIDENT[index] = layout["blocks_per_sm"] * layout["sms"]
    key = (index, raw_stream(index))
    scratch = _SCRATCH.get(key)
    size = 2 + 2 * resident + 16 * n_tiles
    if scratch is None or scratch.numel() < size:
        scratch = torch.zeros(size, dtype=torch.int32, device=device)
        # one made while a CUDA graph is captured is zeroed only by the
        # graph's replays: it serves that call alone
        if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
            _SCRATCH[key] = scratch
    return scratch, resident


def partition_views(out: torch.Tensor, n_fields: int, capacities) -> list:
    """K9p's results as views of its one output buffer (``cmi_partition``'s
    layout): [(fields, in_range, overflow)] for buckets 0 and 1."""
    c0, c1 = capacities
    floats = 4 * n_fields * (c0 + c1)
    counts = out[:COUNTS_BYTES].view(torch.int64)
    fields = out[COUNTS_BYTES:COUNTS_BYTES + floats].view(torch.float32)
    flags = out[COUNTS_BYTES + floats:].view(torch.bool)
    if c0 == c1:  # the exchanges' case: one view a row
        rows = fields.view(2 * n_fields, c0).unbind(0)
        return [(rows[:n_fields], flags[:c0], counts[1]),
                (rows[n_fields:], flags[c0:], counts[3])]
    return [(fields[:n_fields * c0].view(n_fields, c0).unbind(0), flags[:c0], counts[1]),
            (fields[n_fields * c0:].view(n_fields, c1).unbind(0), flags[c0:], counts[3])]


def partition_cuda(fields, bucket: torch.Tensor, capacities, shifts=(None, None)):
    """K9p: for each bucket b of (0, 1), the lanes with ``bucket == b`` in
    input order, then the other lanes in input order, truncated to
    ``capacities[b]`` and zero-padded past the input, with ``shifts[b]``
    (where not None) added to field 0 of every output lane.

    Returns [(fields, in_range, overflow)] for buckets 0 and 1, each as
    :func:`compact_cuda` returns it, all views of one buffer."""
    if len(capacities) != 2 or len(shifts) != 2:
        raise ValueError("partition_cuda: two buckets: two capacities and two shifts")
    fields, device, n = _check("partition_cuda", fields, bucket, torch.int8)
    c0, c1 = int(capacities[0]), int(capacities[1])
    if min(c0, c1) < 0 or max(c0, c1) >= 2**31 - LANES_PER_BLOCK:
        raise ValueError(f"partition_cuda: capacities must be in [0, 2^31), got {capacities}")
    n_fields = len(fields)
    index = bucket.get_device()
    scratch, resident = _scratch(index, device, -(-max(n, c0, c1) // PARTITION_TILE))
    out = bucket.new_empty(COUNTS_BYTES + (4 * n_fields + 1) * (c0 + c1), dtype=torch.uint8)
    s0, s1 = shifts
    _PARTITION(index, *(f.data_ptr() for f in fields), *(0,) * (MAX_FIELDS - n_fields),
               bucket.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, n_fields, c0, c1,
               s0 is not None, s1 is not None, resident,
               0.0 if s0 is None else float(s0), 0.0 if s1 is None else float(s1))
    LAUNCHES[PARTITION] += 1
    return partition_views(out, n_fields, (c0, c1))
