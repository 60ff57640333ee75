"""Wrappers of K9c and K9p, the packet exchange's stable compaction and
bucketed send partition (``csrc/compact.cu``).

The wrappers check what the kernels take (one CUDA device, 1-8 f32 fields of
one length, a bool mask or int8 buckets), allocate the output, launch on
PyTorch's current stream and raise if a launch was refused.  The plain
versions are :func:`cmacionize_torch.parallel.domain.compact_reference` and
``partition_reference``.

Both are one launch of one templated kernel through
:mod:`cmacionize_torch.kernels.launch`, with one output buffer a call, handed
back as one ``[n_fields, capacity]`` view of the fields a bucket, its
``in_range`` and its overflow.  Their scratch (the grid barrier, the block
and warp counts) is kept per device and stream and zeroed once; the blocks
the device holds at once, per device and instance.  A call's fields are a
2-D ``[n_fields, n]`` tensor whose rows are contiguous (such as a view of an
earlier call's output) or a sequence of 1-D contiguous tensors.

K9c takes one to three segments, (fields, mask) each, and compacts their
concatenation without forming it: the slab merge hands it the two received
buffers, the 3D exchange the kept lanes and the two received buffers.  The
segments' addresses reach ``cmi_compact`` as a host table of int64, one per
thread, so that a call passes four pointers' worth of arguments however many
segments it has.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.launch import Launcher, kernel_occupancy, raw_stream

NAME = "compact"
COMPACT, PARTITION = "compact", "partition"  # the LAUNCHES keys of K9c, K9p
MAX_FIELDS = 8
MAX_SEGMENTS = 3  # kMaxSegments in compact.cu
SEGMENT_WORDS = 2 + MAX_FIELDS  # a segment's row of cmi_compact's table
TILE = 256  # kTile in compact.cu: lanes a tile and threads a block
COMPACT_COUNTS_BYTES = 16  # K9c's buffer starts with one int64 {count, overflow}
COUNTS_BYTES = 32  # K9p's with two
MAX_LANES = 2**31 - TILE  # the kernels index lanes in int32
_COMPACT = Launcher(NAME, "cmi_compact", 3, 4)
_PARTITION = Launcher(NAME, "cmi_partition", MAX_FIELDS + 3, 7, 2)
_OCCUPANCY = {COMPACT: "cmi_compact_occupancy", PARTITION: "cmi_partition_occupancy"}
_SCRATCH: dict = {}  # (device index, raw stream) → K9c's and K9p's int32 scratch
_RESIDENT: dict = {}  # (device index, kernel) → blocks of it the device holds at once
_TABLE = threading.local()  # .rows: this thread's segment table for cmi_compact


def _field_error(label: str, i: int, f, n: int, device) -> str:
    if f.device != device or f.dtype != torch.float32 or f.dim() != 1 or f.numel() != n:
        return (f"{label}: field {i} must be float32 of {n} elements on {device}; "
                f"got {f.dtype} of shape {tuple(f.shape)} on {f.device}")
    return f"{label}: field {i} must be contiguous"


def _check(label, fields, codes, code_dtype):
    """The fields (a 2-D tensor or a tuple of 1-D ones), the codes' device
    and length; raises ValueError on what the kernels do not take."""
    two_d = isinstance(fields, torch.Tensor)
    if not two_d:
        fields = tuple(fields)
    if not 1 <= len(fields) <= MAX_FIELDS:
        raise ValueError(f"{label}: 1 to {MAX_FIELDS} fields, got {len(fields)}")
    if not codes.is_cuda:
        raise ValueError(f"{label} needs CUDA tensors, got {codes.device}")
    device, index, n = codes.device, codes.get_device(), codes.numel()
    if codes.dtype is not code_dtype or codes.dim() != 1 or not codes.is_contiguous():
        raise ValueError(f"{label}: codes must be a contiguous 1-D {code_dtype} tensor, "
                         f"got {codes.dtype} of shape {tuple(codes.shape)}")
    if two_d:
        if not (fields.dim() == 2 and fields.dtype is torch.float32 and fields.is_cuda
                and fields.get_device() == index and fields.shape[1] == n
                and (fields.stride(1) == 1 or n <= 1)):
            raise ValueError(
                f"{label}: fields must be float32 [n_fields, {n}] with contiguous rows on "
                f"{device}; got {fields.dtype} of shape {tuple(fields.shape)}, strides "
                f"{fields.stride()} on {fields.device}")
    else:
        for i, f in enumerate(fields):
            if not (f.dtype is torch.float32 and f.is_cuda and f.get_device() == index
                    and f.dim() == 1 and f.numel() == n and f.is_contiguous()):
                raise ValueError(_field_error(label, i, f, n, device))
    if n >= MAX_LANES:
        raise ValueError(f"{label}: sizes must fit int32")
    return fields, device, n


def field_pointers(fields) -> list:
    """The address of each field: the rows of a 2-D tensor or each tensor of
    a sequence."""
    if isinstance(fields, torch.Tensor):
        base, step = fields.data_ptr(), 4 * fields.stride(0)
        return [base + step * f for f in range(fields.shape[0])]
    return [f.data_ptr() for f in fields]


def occupancy(device, kernel: str = PARTITION) -> dict:
    """Registers per thread and blocks of 256 resident per SM of K9p's (or,
    with ``kernel="compact"``, K9c's) instance of the exchange kernel, and
    the SM count of CUDA ``device``."""
    return kernel_occupancy(NAME, _OCCUPANCY[kernel], device)


def _resident(index: int, device, kernel: str) -> int:
    """The blocks of ``kernel``'s instance the device holds at once, queried
    at the first call on each device."""
    resident = _RESIDENT.get((index, kernel))
    if resident is None:
        layout = occupancy(device) if kernel == PARTITION else occupancy(device, kernel)
        resident = _RESIDENT[(index, kernel)] = layout["blocks_per_sm"] * layout["sms"]
    return resident


def _scratch(index: int, device, n_tiles: int, resident: int) -> torch.Tensor:
    """The exchange kernels' scratch on this device and its current stream
    (the barrier's two words, zero, two counts a block of ``resident`` and
    sixteen a tile, for at least ``n_tiles``): made at the first call on
    each, and made anew for more.  Every call leaves the barrier's words at
    zero."""
    key = (index, raw_stream(index))
    scratch = _SCRATCH.get(key)
    size = 2 + 2 * resident + 16 * n_tiles
    if scratch is None or scratch.numel() < size:
        scratch = torch.zeros(size, dtype=torch.int32, device=device)
        # one made while a CUDA graph is captured is zeroed only by the
        # graph's replays: it serves that call alone
        if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
            _SCRATCH[key] = scratch
    return scratch


def _check_segments(label, segments):
    """The segment table's values (per segment: the mask's address, its
    lanes, its fields' addresses), the device and its index, the lanes in
    all and the fields a lane; raises ValueError on what K9c does not take."""
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"{label}: 1 to {MAX_SEGMENTS} segments, got {len(segments)}")
    values, total, n_fields, device, index = [], 0, None, None, None
    for fields, mask in segments:
        fields, mask_device, n = _check(label, fields, mask, torch.bool)
        pointers = field_pointers(fields)
        if device is None:
            device, index, n_fields = mask_device, mask.get_device(), len(pointers)
        elif mask_device != device or len(pointers) != n_fields:
            raise ValueError(f"{label}: every segment must hold {n_fields} fields on {device}; "
                             f"got {len(pointers)} on {mask_device}")
        values += [mask.data_ptr(), n, *pointers, *(0,) * (MAX_FIELDS - n_fields)]
        total += n
    if total >= MAX_LANES:
        raise ValueError(f"{label}: sizes must fit int32")
    return values, device, index, total, n_fields


def compact_views(out: torch.Tensor, n_fields: int, capacity: int) -> tuple:
    """K9c's result as views of its one output buffer (``cmi_compact``'s
    layout): (fields [n_fields, capacity], in_range [capacity], overflow)."""
    floats = COMPACT_COUNTS_BYTES + 4 * n_fields * capacity
    return (out[COMPACT_COUNTS_BYTES:floats].view(torch.float32).view(n_fields, capacity),
            out[floats:].view(torch.bool), out[:COMPACT_COUNTS_BYTES].view(torch.int64)[1])


def compact_segments_cuda(segments, capacity: int) -> tuple:
    """K9c: the members of the concatenation of ``segments`` ((fields, mask)
    each, 1 to 3) in order, then its other lanes in order, truncated to
    ``capacity`` and zero-padded past the input; the concatenation is never
    formed.

    Returns (fields [n_fields, capacity], in_range [capacity] bool,
    overflow: a 0-d int64 tensor, max(count - capacity, 0)), views of one
    buffer."""
    values, device, index, n, n_fields = _check_segments("compact_cuda", segments)
    capacity = int(capacity)
    if not 0 <= capacity < MAX_LANES:
        raise ValueError(f"compact_cuda: capacity must be in [0, 2^31), got {capacity}")
    resident = _resident(index, device, COMPACT)
    scratch = _scratch(index, device, -(-max(n, capacity) // TILE), resident)
    out = torch.empty(COMPACT_COUNTS_BYTES + (4 * n_fields + 1) * capacity, dtype=torch.uint8,
                      device=device)
    rows = getattr(_TABLE, "rows", None)
    if rows is None:
        rows = _TABLE.rows = (ctypes.c_int64 * (MAX_SEGMENTS * SEGMENT_WORDS))()
    rows[:len(values)] = values
    _COMPACT(index, rows, out.data_ptr(), scratch.data_ptr(), len(segments), n_fields,
             capacity, resident)
    LAUNCHES[COMPACT] += 1
    return compact_views(out, n_fields, capacity)


def compact_cuda(fields, mask: torch.Tensor, capacity: int) -> tuple:
    """K9c on one segment: the members of ``mask`` in input order, then the
    other lanes in input order, truncated to ``capacity`` and zero-padded
    past the input; as :func:`compact_segments_cuda` returns it."""
    return compact_segments_cuda(((fields, mask),), capacity)


def partition_views(out: torch.Tensor, n_fields: int, capacities) -> list:
    """K9p's results as views of its one output buffer (``cmi_partition``'s
    layout): [(fields [n_fields, capacity], in_range, overflow)] for buckets
    0 and 1."""
    c0, c1 = capacities
    floats = COUNTS_BYTES + 4 * n_fields * (c0 + c1)
    counts = out[:COUNTS_BYTES].view(torch.int64)
    fields = out[COUNTS_BYTES:floats].view(torch.float32)
    flags = out[floats:].view(torch.bool)
    if c0 == c1:  # the exchanges' case
        rows = fields.view(2, n_fields, c0)
        return [(rows[0], flags[:c0], counts[1]), (rows[1], flags[c0:], counts[3])]
    return [(fields[:n_fields * c0].view(n_fields, c0), flags[:c0], counts[1]),
            (fields[n_fields * c0:].view(n_fields, c1), flags[c0:], counts[3])]


def partition_cuda(fields, bucket: torch.Tensor, capacities, shifts=(None, None)):
    """K9p: for each bucket b of (0, 1), the lanes with ``bucket == b`` in
    input order, then the other lanes in input order, truncated to
    ``capacities[b]`` and zero-padded past the input, with ``shifts[b]``
    (where not None) added to field 0 of every output lane.

    Returns [(fields, in_range, overflow)] for buckets 0 and 1, each as
    :func:`compact_segments_cuda` returns it, all views of one buffer."""
    if len(capacities) != 2 or len(shifts) != 2:
        raise ValueError("partition_cuda: two buckets: two capacities and two shifts")
    fields, device, n = _check("partition_cuda", fields, bucket, torch.int8)
    c0, c1 = int(capacities[0]), int(capacities[1])
    if min(c0, c1) < 0 or max(c0, c1) >= MAX_LANES:
        raise ValueError(f"partition_cuda: capacities must be in [0, 2^31), got {capacities}")
    pointers = field_pointers(fields)
    n_fields = len(pointers)
    index = bucket.get_device()
    resident = _resident(index, device, PARTITION)
    scratch = _scratch(index, device, -(-max(n, c0, c1) // TILE), resident)
    out = bucket.new_empty(COUNTS_BYTES + (4 * n_fields + 1) * (c0 + c1), dtype=torch.uint8)
    s0, s1 = shifts
    _PARTITION(index, *pointers, *(0,) * (MAX_FIELDS - n_fields),
               bucket.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, n_fields, c0, c1,
               s0 is not None, s1 is not None, resident,
               0.0 if s0 is None else float(s0), 0.0 if s1 is None else float(s1))
    LAUNCHES[PARTITION] += 1
    return partition_views(out, n_fields, (c0, c1))
