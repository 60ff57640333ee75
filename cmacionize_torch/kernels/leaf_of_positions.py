"""Wrapper of K5d, the CUDA leaf descent (``cmi_leaf_of_positions`` in
``csrc/trace_octree.cu``).

The wrapper checks what the kernel takes (one CUDA device, dtypes, lengths,
contiguity), launches on PyTorch's current stream and raises if the launch
was refused.  It writes the leaf ids into the [P] int32 tensor it is handed
and allocates nothing.
"""

from __future__ import annotations

import ctypes

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import load_library
from cmacionize_torch.kernels.trace_octree import check_octree, check_tensors

NAME = "leaf_of_positions"
LIBRARY = "trace_octree"  # K5d is built with K5


def _launcher():
    fn = load_library(LIBRARY).cmi_leaf_of_positions
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def leaf_of_positions_cuda(root: torch.Tensor, children: torch.Tensor, px: torch.Tensor,
                           py: torch.Tensor, pz: torch.Tensor, leaf: torch.Tensor, *,
                           coarse_shape, max_level: int) -> None:
    """Write the leaf id of each point (px, py, pz), in coarse cell units,
    into ``leaf`` ([P] int32), in place."""
    nx, ny, nz, n_internal = check_octree(NAME, root, children, coarse_shape, max_level)
    device = px.device
    n = px.numel()
    if n >= 2**31:
        raise ValueError("leaf_of_positions_cuda: sizes must fit int32")
    arrays = {"root": root, "children": children, "px": px, "py": py, "pz": pz, "leaf": leaf}
    expected = [(f, torch.float32, n) for f in ("px", "py", "pz")]
    expected += [("leaf", torch.int32, n), ("root", torch.int32, nx * ny * nz),
                 ("children", torch.int32, 8 * n_internal)]
    check_tensors("leaf_of_positions_cuda", device, arrays, expected)
    launch = _launcher()
    stream = torch.cuda.current_stream(device).cuda_stream
    pointers = [arrays[f].data_ptr() for f in ("root", "children", "px", "py", "pz", "leaf")]
    with torch.cuda.device(device):
        err = launch(*pointers, n, nx, ny, nz, int(max_level), stream)
    if err != 0:
        raise RuntimeError(f"leaf_of_positions_cuda: CUDA error {err} at launch")
    LAUNCHES[NAME] += 1
