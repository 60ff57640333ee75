"""Wrappers of K9c and K9p, the packet exchange's stable compaction and
bucketed send partition (``csrc/compact.cu``).

The wrappers check what the kernels take (one CUDA device, 1-8 contiguous
f32 fields of one length, a bool mask or int8 buckets), allocate the outputs
and the kernels' scratch with ``torch.empty``, launch on PyTorch's current
stream and raise if a launch was refused.  The plain versions are
:func:`cmacionize_torch.parallel.domain.compact_reference` and
``partition_reference``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import load_library

NAME = "compact"
COMPACT, PARTITION = "compact", "partition"  # the LAUNCHES keys of K9c, K9p
MAX_FIELDS = 8
LANES_PER_BLOCK = 1024  # kThreads in compact.cu


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
    device = codes.device
    if device.type != "cuda":
        raise ValueError(f"{label} needs CUDA tensors, got {device}")
    n = codes.numel()
    if codes.dtype != code_dtype or codes.dim() != 1 or not codes.is_contiguous():
        raise ValueError(f"{label}: codes must be a contiguous 1-D {code_dtype} tensor, "
                         f"got {codes.dtype} of shape {tuple(codes.shape)}")
    for i, f in enumerate(fields):
        if f.device != device or f.dtype != torch.float32 or f.dim() != 1 or f.numel() != n:
            raise ValueError(
                f"{label}: field {i} must be float32 of {n} elements on {device}; "
                f"got {f.dtype} of shape {tuple(f.shape)} on {f.device}")
        if not f.is_contiguous():
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


def partition_cuda(fields, bucket: torch.Tensor, capacities, shifts=(None, None)):
    """K9p: for each bucket b of (0, 1), the lanes with ``bucket == b`` in
    input order, then the other lanes in input order, truncated to
    ``capacities[b]`` and zero-padded past the input, with ``shifts[b]``
    (where not None) added to field 0 of every output lane.

    Returns [(fields, in_range, overflow)] for buckets 0 and 1, each as
    :func:`compact_cuda` returns it."""
    if len(capacities) != 2 or len(shifts) != 2:
        raise ValueError("partition_cuda: two buckets: two capacities and two shifts")
    fields, device, n = _check("partition_cuda", fields, bucket, torch.int8)
    result = _run("partition_cuda", fields, bucket, n, device,
                  tuple(int(c) for c in capacities), tuple(shifts))
    LAUNCHES[PARTITION] += 1
    return result
