"""Wrapper of K5, the CUDA octree march (``csrc/trace_octree.cu``).

The wrapper checks what the kernel takes (one CUDA device, dtypes, lengths,
contiguity, int32 sizes), launches on PyTorch's current stream and raises if
the launch was refused.  Packet state and the tally are updated in place (the
caller, :func:`cmacionize_torch.ops.amr_traversal.trace_packets_octree`,
hands in copies of the packet state).

The kernel ends a packet at a fixed point of its step, sums each run of a
warp's deposits into one leaf before its atomicAdd, and marches the packets
in the order of :func:`direction_order` (a key sort made here, whose time is
part of the call's; the one allocation beside it is the order).  None of
these changes a packet's final state; the deposits are summed in another
order.
"""

from __future__ import annotations

import ctypes

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import load_library
from cmacionize_torch.kernels.launch import kernel_occupancy

NAME = "trace_octree"

_FLOAT_FIELDS = ("px", "py", "pz", "dx", "dy", "dz", "tau_left", "weight")
_BOOL_FIELDS = ("active", "absorbed")
_POINTER_ORDER = ("root", "children", "chi", "tally", "px", "py", "pz", "dx", "dy", "dz",
                  "tau_left", "weight", "active", "absorbed", "order")
DIRECTION_BUCKETS = 1024  # a side of the cube of direction buckets


def check_tensors(name: str, device, arrays: dict, expected) -> None:
    """Each of ``expected`` (label, dtype, numel) names a contiguous tensor of
    ``arrays`` of that dtype and length on ``device``; raises otherwise."""
    if device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {device}")
    for label, dtype, length in expected:
        t = arrays[label]
        if t.device != device or t.dtype != dtype or t.numel() != length:
            raise ValueError(
                f"{name}: {label} must be {dtype} of {length} elements on {device}; "
                f"got {t.dtype} of {t.numel()} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def check_octree(name: str, root, children, coarse_shape, max_level: int) -> tuple:
    """The (nx, ny, nz, n_internal) of the octree tables; raises on a shape,
    dtype or size the kernels do not take."""
    nx, ny, nz = (int(s) for s in coarse_shape)
    if children.dim() != 2 or children.shape[1] != 8:
        raise ValueError(f"{name}: children must be [n_internal, 8], got {tuple(children.shape)}")
    if not 0 <= max_level <= 30:
        raise ValueError(f"{name}: max_level must be in [0, 30], got {max_level}")
    if nx * ny * nz >= 2**31:
        raise ValueError(f"{name}: the coarse lattice must fit int32")
    return nx, ny, nz, children.shape[0]


def _launcher():
    fn = load_library(NAME).cmi_trace_octree
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * len(_POINTER_ORDER) + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def occupancy(device) -> dict:
    """Registers per thread and blocks of 256 resident per SM of K5, and the
    SM count of CUDA ``device``."""
    return kernel_occupancy(NAME, "cmi_trace_octree_occupancy", device)


def direction_order(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """int32 indices of the packets sorted by their direction's cell in a
    cube of :data:`DIRECTION_BUCKETS`³ over [-1, 1]³, x major
    (``torch.argsort``), so that the lanes of a warp march neighbouring rays.
    A Z-order key over the same cells took longer (PERF.md, section 6)."""
    side = DIRECTION_BUCKETS
    cells = [torch.clamp(((d + 1.0) * (0.5 * side)).to(torch.int32), 0, side - 1)
             for d in (dx, dy, dz)]
    return torch.argsort((cells[0] * side + cells[1]) * side + cells[2]).to(torch.int32)


def trace_octree_cuda(root: torch.Tensor, children: torch.Tensor, chi: torch.Tensor,
                      tally: torch.Tensor, fields: dict, *, coarse_shape, max_level: int,
                      eps: float, max_steps: int) -> None:
    """March the packets in ``fields`` (PacketBatch field name → tensor,
    positions in coarse cell units) to termination through the octree,
    adding ℓ·w into ``tally[leaf]``, in place.  ``chi``: [C] f32 opacity per
    coarse-unit length; ``root`` [nx·ny·nz] and ``children`` [n_internal, 8]
    int32."""
    nx, ny, nz, n_internal = check_octree(NAME, root, children, coarse_shape, max_level)
    device = chi.device
    n = fields["px"].numel()
    C = chi.numel()
    arrays = {"root": root, "children": children, "chi": chi, "tally": tally, **fields}
    expected = [(f, torch.float32, n) for f in _FLOAT_FIELDS]
    expected += [(f, torch.bool, n) for f in _BOOL_FIELDS]
    expected += [("root", torch.int32, nx * ny * nz), ("children", torch.int32, 8 * n_internal),
                 ("chi", torch.float32, C), ("tally", torch.float32, C)]
    check_tensors("trace_octree_cuda", device, arrays, expected)
    if max(n, C) >= 2**31 or max_steps < 0:
        raise ValueError("trace_octree_cuda: sizes must fit int32, max_steps >= 0")
    if n == 0:  # no packet: no launch
        return
    launch = _launcher()
    stream = torch.cuda.current_stream(device).cuda_stream
    arrays["order"] = direction_order(fields["dx"], fields["dy"], fields["dz"])
    pointers = [arrays[f].data_ptr() for f in _POINTER_ORDER]
    with torch.cuda.device(device):
        err = launch(*pointers, n, nx, ny, nz, int(max_level), float(eps), int(max_steps),
                     stream)
    if err != 0:
        raise RuntimeError(f"trace_octree_cuda: CUDA error {err} at launch")
    LAUNCHES[NAME] += 1
