"""Wrapper of K2, the CUDA spectral packet march
(``csrc/trace_packets_spectral.cu``).

The wrapper checks what the kernel takes (one CUDA device, dtypes, lengths,
contiguity, int32 sizes) and launches on PyTorch's current stream through
:mod:`cmacionize_torch.kernels.launch`, which raises if the launch was
refused.  Packet state and the tally are updated in place, and the caller
(:func:`cmacionize_torch.ops.traversal.trace_packets_spectral`) hands in
copies of the packet state.
"""

from __future__ import annotations

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.launch import Launcher, kernel_occupancy
from cmacionize_torch.kernels.trace_octree import check_tensors

NAME = "trace_packets_spectral"

_FLOAT_FIELDS = ("px", "py", "pz", "dx", "dy", "dz", "tau_left", "weight", "sig_h", "sig_he")
_INT_FIELDS = ("cx", "cy", "cz", "fbin")
_BOOL_FIELDS = ("active", "absorbed")
_POINTER_ORDER = (
    "chi_h", "chi_he", "tally", "px", "py", "pz", "cx", "cy", "cz",
    "dx", "dy", "dz", "tau_left", "weight", "sig_h", "sig_he", "fbin",
    "active", "absorbed",
)
# then n, nx, ny, nz, n_bins, the periodic mask and max_steps
_LAUNCH = Launcher(NAME, "cmi_trace_packets_spectral", len(_POINTER_ORDER), 7)


def occupancy(device) -> dict:
    """Registers per thread and blocks of 256 resident per SM of K2, and the
    SM count of CUDA ``device``."""
    return kernel_occupancy(NAME, "cmi_trace_packets_spectral_occupancy", device)


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
    n = fields["px"].numel()
    expected = [(name, torch.float32, n) for name in _FLOAT_FIELDS]
    expected += [(name, torch.int32, n) for name in _INT_FIELDS]
    expected += [(name, torch.bool, n) for name in _BOOL_FIELDS]
    expected += [
        ("chi_h", torch.float32, ncell), ("chi_he", torch.float32, ncell),
        ("tally", torch.float32, n_bins * ncell),
    ]
    arrays = {"chi_h": chi_h, "chi_he": chi_he, "tally": tally, **fields}
    check_tensors("trace_packets_spectral_cuda", chi_h.device, arrays, expected)
    # the slot fbin·ncell + cell is int32 arithmetic, as in the JAX march
    if max(n, n_bins * ncell) >= 2**31 or max_steps < 0 or n_bins < 1:
        raise ValueError("trace_packets_spectral_cuda: sizes must fit int32")
    if n == 0:  # no packet: no launch
        return
    periodic_mask = sum(1 << axis for axis, p in enumerate(periodic) if p)
    _LAUNCH(chi_h.get_device(), *(arrays[name].data_ptr() for name in _POINTER_ORDER),
            n, nx, ny, nz, n_bins, periodic_mask, int(max_steps))
    LAUNCHES[NAME] += 1
