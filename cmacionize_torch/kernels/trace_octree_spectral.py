"""Wrapper of K5s, the CUDA spectral octree march
(``csrc/trace_octree_spectral.cu``).

As :mod:`cmacionize_torch.kernels.trace_octree`, with per-packet σ_H, σ_He and
frequency bin, and a flat [n_bins·C] tally.  Packet state and the tally are
updated in place; the caller hands in copies of the packet state.
"""

from __future__ import annotations

import ctypes

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import load_library
from cmacionize_torch.kernels.trace_octree import check_octree, check_tensors

NAME = "trace_octree_spectral"

_FLOAT_FIELDS = ("px", "py", "pz", "dx", "dy", "dz", "tau_left", "weight", "sig_h", "sig_he")
_BOOL_FIELDS = ("active", "absorbed")
_POINTER_ORDER = ("root", "children", "chi_h", "chi_he", "tally", "px", "py", "pz",
                  "dx", "dy", "dz", "tau_left", "weight", "sig_h", "sig_he", "fbin",
                  "active", "absorbed")


def _launcher():
    fn = load_library(NAME).cmi_trace_octree_spectral
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * len(_POINTER_ORDER) + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def trace_octree_spectral_cuda(root: torch.Tensor, children: torch.Tensor,
                               chi_h: torch.Tensor, chi_he: torch.Tensor,
                               tally: torch.Tensor, fields: dict, *, coarse_shape,
                               max_level: int, n_bins: int, eps: float,
                               max_steps: int) -> None:
    """March the packets in ``fields`` (SpectralPacketBatch field name →
    tensor, positions in coarse cell units) to termination through the
    octree, adding ℓ·w into ``tally[fbin·C + leaf]``, in place.  ``chi_h`` /
    ``chi_he``: [C] f32 n_H·x_H and n_H·A_He·x_He per coarse-unit length."""
    nx, ny, nz, n_internal = check_octree(NAME, root, children, coarse_shape, max_level)
    device = chi_h.device
    n = fields["px"].numel()
    C = chi_h.numel()
    # the slot fbin·C + leaf is int32 arithmetic, as in the JAX march
    if n_bins < 1 or max_steps < 0 or max(n, n_bins * C) >= 2**31:
        raise ValueError("trace_octree_spectral_cuda: n_bins >= 1, max_steps >= 0, "
                         "n and n_bins * C must fit int32")
    arrays = {"root": root, "children": children, "chi_h": chi_h, "chi_he": chi_he,
              "tally": tally, **fields}
    expected = [(f, torch.float32, n) for f in _FLOAT_FIELDS]
    expected += [("fbin", torch.int32, n)]
    expected += [(f, torch.bool, n) for f in _BOOL_FIELDS]
    expected += [("root", torch.int32, nx * ny * nz), ("children", torch.int32, 8 * n_internal),
                 ("chi_h", torch.float32, C), ("chi_he", torch.float32, C),
                 ("tally", torch.float32, n_bins * C)]
    check_tensors("trace_octree_spectral_cuda", device, arrays, expected)
    launch = _launcher()
    stream = torch.cuda.current_stream(device).cuda_stream
    pointers = [arrays[f].data_ptr() for f in _POINTER_ORDER]
    with torch.cuda.device(device):
        err = launch(*pointers, n, nx, ny, nz, C, n_bins, int(max_level), float(eps),
                     int(max_steps), stream)
    if err != 0:
        raise RuntimeError(f"trace_octree_spectral_cuda: CUDA error {err} at launch")
    LAUNCHES[NAME] += 1
