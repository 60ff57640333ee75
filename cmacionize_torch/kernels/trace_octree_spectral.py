"""Wrapper of K5s, the CUDA spectral octree march
(``csrc/trace_octree_spectral.cu``).

As :mod:`cmacionize_torch.kernels.trace_octree`, with per-packet σ_H, σ_He and
frequency bin, and a flat [n_bins·C] tally.  Packet state and the tally are
updated in place; the caller hands in copies of the packet state.

The kernel marches the active packets in the order of :func:`packet_order`
(a key sort made here, whose time is part of the call's), ends a packet at a
fixed point of its step and sums each run of a warp's deposits into one
slot before its atomicAdd.  None of these changes a packet's final state;
the deposits are summed in another order.  It launches through
:mod:`cmacionize_torch.kernels.launch`.
"""

from __future__ import annotations

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.launch import Launcher, kernel_occupancy
from cmacionize_torch.kernels.trace_octree import check_octree, check_tensors

NAME = "trace_octree_spectral"

_FLOAT_FIELDS = ("px", "py", "pz", "dx", "dy", "dz", "tau_left", "weight", "sig_h", "sig_he")
_BOOL_FIELDS = ("active", "absorbed")
_POINTER_ORDER = ("root", "children", "chi_h", "chi_he", "tally", "px", "py", "pz",
                  "dx", "dy", "dz", "tau_left", "weight", "sig_h", "sig_he", "fbin",
                  "active", "absorbed")
KEY_BITS = 30  # a packet's key is below 2^KEY_BITS
INACTIVE_KEY = 2**31 - 1  # above every key: the inactive packets go last
_LAUNCH = Launcher(NAME, "cmi_trace_octree_spectral", len(_POINTER_ORDER) + 2, 7, 1)


def occupancy(device) -> dict:
    """Registers per thread and blocks of 256 resident per SM of K5s, and the
    SM count of CUDA ``device``."""
    return kernel_occupancy(NAME, "cmi_trace_octree_spectral_occupancy", device)


def bin_direction_key(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor, fbin: torch.Tensor,
                      n_bins: int) -> torch.Tensor:
    """int32 key of each packet: its frequency bin, then its direction's cell
    in a cube over [-1, 1]³, x major, of side 2^((30 - b) // 3) for bins of
    b bits (256³ for 64 bins), so that the key stays below 2^30."""
    side = 1 << ((KEY_BITS - max(n_bins - 1, 1).bit_length()) // 3)
    cells = [torch.clamp(((d + 1.0) * (0.5 * side)).to(torch.int32), 0, side - 1)
             for d in (dx, dy, dz)]
    return ((fbin * side + cells[0]) * side + cells[1]) * side + cells[2]


def packet_order(fields: dict, n_bins: int) -> tuple:
    """(order, n_active): int32 indices of the packets, the active ones first,
    sorted by :func:`bin_direction_key` (``torch.argsort``), then the
    inactive ones; and the count of active packets (a 0-d int64 tensor, on
    the packets' device).  The kernel marches ``order[:n_active]``: the lanes
    of a warp march neighbouring rays of one bin, whose deposits go to one
    tally plane, and a generation's warps hold only re-emitted packets."""
    active = fields["active"]
    key = torch.where(active, bin_direction_key(fields["dx"], fields["dy"], fields["dz"],
                                                fields["fbin"], n_bins), INACTIVE_KEY)
    return torch.argsort(key).to(torch.int32), torch.count_nonzero(active)


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
    if n == 0:  # no packet: no launch
        return
    order, n_active = packet_order(fields, n_bins)
    _LAUNCH(chi_h.get_device(), *(arrays[f].data_ptr() for f in _POINTER_ORDER),
            order.data_ptr(), n_active.data_ptr(), n, nx, ny, nz, C, int(max_level),
            int(max_steps), float(eps))
    LAUNCHES[NAME] += 1
