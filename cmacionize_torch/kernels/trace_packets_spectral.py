"""Wrapper of K2, the CUDA spectral packet march
(``csrc/trace_packets_spectral.cu``).

The wrapper checks what the kernel takes (one CUDA device, dtypes, lengths,
contiguity), launches on PyTorch's current stream and raises if the launch
was refused.  It allocates nothing: packet state and the tally are updated in
place, and the caller (:func:`cmacionize_torch.ops.traversal.trace_packets_spectral`)
hands in copies of the packet state.
"""

from __future__ import annotations

import ctypes

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import load_library

NAME = "trace_packets_spectral"

_FLOAT_FIELDS = ("px", "py", "pz", "dx", "dy", "dz", "tau_left", "weight", "sig_h", "sig_he")
_INT_FIELDS = ("cx", "cy", "cz", "fbin")
_BOOL_FIELDS = ("active", "absorbed")
_POINTER_ORDER = (
    "chi_h", "chi_he", "tally", "px", "py", "pz", "cx", "cy", "cz",
    "dx", "dy", "dz", "tau_left", "weight", "sig_h", "sig_he", "fbin",
    "active", "absorbed",
)


def _launcher():
    fn = load_library(NAME).cmi_trace_packets_spectral
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * len(_POINTER_ORDER) + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def trace_packets_spectral_cuda(
    chi_h: torch.Tensor,
    chi_he: torch.Tensor,
    tally: torch.Tensor,
    fields: dict,
    *,
    shape,
    n_bins: int,
    periodic,
    max_steps: int,
) -> None:
    """March the packets in ``fields`` (SpectralPacketBatch field name →
    tensor) to termination, adding ℓ·w into ``tally[fbin·ncell + cell]``,
    in place."""
    nx, ny, nz = (int(s) for s in shape)
    ncell = nx * ny * nz
    device = chi_h.device
    if device.type != "cuda":
        raise ValueError(f"trace_packets_spectral_cuda needs CUDA tensors, got {device}")
    n = fields["px"].numel()
    expected = [(name, torch.float32, n) for name in _FLOAT_FIELDS]
    expected += [(name, torch.int32, n) for name in _INT_FIELDS]
    expected += [(name, torch.bool, n) for name in _BOOL_FIELDS]
    expected += [
        ("chi_h", torch.float32, ncell), ("chi_he", torch.float32, ncell),
        ("tally", torch.float32, n_bins * ncell),
    ]
    arrays = {"chi_h": chi_h, "chi_he": chi_he, "tally": tally, **fields}
    for name, dtype, length in expected:
        t = arrays[name]
        if t.device != device or t.dtype != dtype or t.numel() != length:
            raise ValueError(
                f"trace_packets_spectral_cuda: {name} must be {dtype} of {length} "
                f"elements on {device}; got {t.dtype} of {t.numel()} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"trace_packets_spectral_cuda: {name} must be contiguous")
    if max(n, n_bins * ncell) >= 2**31 or max_steps < 0 or n_bins < 1:
        raise ValueError("trace_packets_spectral_cuda: sizes must fit int32")
    periodic_mask = sum(1 << axis for axis, p in enumerate(periodic) if p)

    launch = _launcher()
    stream = torch.cuda.current_stream(device).cuda_stream
    pointers = [arrays[name].data_ptr() for name in _POINTER_ORDER]
    with torch.cuda.device(device):
        err = launch(
            *pointers, n, nx, ny, nz, n_bins, periodic_mask, int(max_steps), stream
        )
    if err != 0:
        raise RuntimeError(f"trace_packets_spectral_cuda: CUDA error {err} at launch")
    LAUNCHES[NAME] += 1
