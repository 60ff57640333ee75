"""Wrapper of K1, the CUDA packet march (``csrc/trace_packets.cu``).

The wrapper checks what the kernel takes (one CUDA device, dtypes, lengths,
contiguity, int32 sizes) and launches on PyTorch's current stream through
:mod:`cmacionize_torch.kernels.launch`, which raises if the launch was
refused.  It allocates nothing: packet state and the tally are updated in
place, and the caller (:func:`cmacionize_torch.ops.traversal.trace_packets`)
hands in copies of the packet state.
"""

from __future__ import annotations

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.launch import Launcher, kernel_occupancy

NAME = "trace_packets"

_FLOAT_FIELDS = ("px", "py", "pz", "dx", "dy", "dz", "tau_left", "weight")
_INT_FIELDS = ("cx", "cy", "cz")
_BOOL_FIELDS = ("active", "absorbed")
_POINTER_ORDER = ("opacity", "tally", "px", "py", "pz", "cx", "cy", "cz", "dx", "dy", "dz",
                  "tau_left", "weight", "active", "absorbed")
# then n, nx, ny, nz, the periodic mask and max_steps
_TRACE_PACKETS = Launcher(NAME, "cmi_trace_packets", len(_POINTER_ORDER), 6)


def occupancy(device) -> dict:
    """Registers per thread and blocks of 256 resident per SM of K1, and the
    SM count of CUDA ``device``."""
    return kernel_occupancy(NAME, "cmi_trace_packets_occupancy", device)


def trace_packets_cuda(
    opacity: torch.Tensor,
    tally: torch.Tensor,
    fields: dict,
    *,
    shape,
    periodic,
    max_steps: int,
) -> None:
    """March the packets in ``fields`` (PacketBatch field name → tensor) to
    termination, adding path length × weight into ``tally``, in place."""
    nx, ny, nz = (int(s) for s in shape)
    ncell = nx * ny * nz
    device = opacity.device
    if device.type != "cuda":
        raise ValueError(f"trace_packets_cuda needs CUDA tensors, got {device}")
    n = fields["px"].numel()
    expected = [(name, torch.float32, n) for name in _FLOAT_FIELDS]
    expected += [(name, torch.int32, n) for name in _INT_FIELDS]
    expected += [(name, torch.bool, n) for name in _BOOL_FIELDS]
    arrays = {"opacity": opacity, "tally": tally, **fields}
    expected += [("opacity", torch.float32, ncell), ("tally", torch.float32, ncell)]
    for name, dtype, length in expected:
        t = arrays[name]
        if t.device != device or t.dtype != dtype or t.numel() != length:
            raise ValueError(
                f"trace_packets_cuda: {name} must be {dtype} of {length} "
                f"elements on {device}; got {t.dtype} of {t.numel()} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"trace_packets_cuda: {name} must be contiguous")
    if max(n, ncell) >= 2**31 or max_steps < 0:
        raise ValueError("trace_packets_cuda: sizes must fit int32")
    if n == 0:  # no packet: no launch
        return
    periodic_mask = sum(1 << axis for axis, p in enumerate(periodic) if p)
    _TRACE_PACKETS(device.index, *(arrays[name].data_ptr() for name in _POINTER_ORDER),
                   n, nx, ny, nz, periodic_mask, int(max_steps))
    LAUNCHES[NAME] += 1
