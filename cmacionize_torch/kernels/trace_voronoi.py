"""Wrapper of K6, the CUDA face-plane march over a Voronoi cell graph
(``csrc/trace_voronoi.cu``).

The wrapper checks what the kernel takes (one CUDA device, dtypes, lengths,
contiguity), launches on PyTorch's current stream and raises if the launch
was refused.  It allocates nothing: packet state and the tally are updated in
place, and the caller (:func:`cmacionize_torch.models.voronoi.trace_packets_voronoi`)
hands in copies of the packet state.
"""

from __future__ import annotations

import ctypes

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import load_library

NAME = "trace_voronoi"

_TABLE_POINTERS = ("neighbors", "normals", "offsets", "shifts")
_PACKET_POINTERS = ("pos", "dirn", "cell", "tau_left", "weight", "active", "absorbed")


def check_march_inputs(name, tables, fields, arrays: dict) -> tuple:
    """Check the tensors a face-plane march takes; returns (P, C, K).

    ``arrays`` maps further names to (tensor, dtype, expected numel)."""
    nbr = tables.neighbors
    device = nbr.device
    if device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {device}")
    if nbr.dim() != 2:
        raise ValueError(f"{name}: neighbors must be [C, K], got {tuple(nbr.shape)}")
    C, K = nbr.shape
    n = fields["cell"].numel()
    expected = {
        "neighbors": (nbr, torch.int32, C * K),
        "normals": (tables.normals, torch.float32, C * K * 3),
        "offsets": (tables.offsets, torch.float32, C * K),
        "shifts": (tables.shifts, torch.float32, C * K * 3),
        "pos": (fields["pos"], torch.float32, 3 * n),
        "dirn": (fields["dirn"], torch.float32, 3 * n),
        "cell": (fields["cell"], torch.int32, n),
        "tau_left": (fields["tau_left"], torch.float32, n),
        "weight": (fields["weight"], torch.float32, n),
        "active": (fields["active"], torch.bool, n),
        "absorbed": (fields["absorbed"], torch.bool, n),
    }
    expected.update(arrays)
    for label, (t, dtype, length) in expected.items():
        if t.device != device or t.dtype != dtype or t.numel() != length:
            raise ValueError(
                f"{name}: {label} must be {dtype} of {length} elements on {device}; "
                f"got {t.dtype} of {t.numel()} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if max(n * 3, C * K * 3) >= 2**31:
        raise ValueError(f"{name}: sizes must fit int32")
    return n, C, K


def _launcher():
    fn = load_library(NAME).cmi_trace_voronoi
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                                           ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def trace_voronoi_cuda(tables, chi_u: torch.Tensor, tally: torch.Tensor, fields: dict, *,
                       eps: float, max_steps: int) -> None:
    """March the packets in ``fields`` (VoronoiPacketBatch field name →
    tensor) to termination over the rows of ``tables`` (a VoronoiTables),
    adding ℓ·w (box units) into ``tally[cell]``, in place.  ``chi_u``: [C]
    f32 opacity per box unit."""
    C = tables.neighbors.shape[0] if tables.neighbors.dim() == 2 else -1
    n, C, K = check_march_inputs(
        "trace_voronoi_cuda", tables, fields,
        {"chi": (chi_u, torch.float32, C), "tally": (tally, torch.float32, C)},
    )
    if max_steps < 0:
        raise ValueError("trace_voronoi_cuda: max_steps must be >= 0")
    device = chi_u.device
    launch = _launcher()
    stream = torch.cuda.current_stream(device).cuda_stream
    pointers = [getattr(tables, f).data_ptr() for f in _TABLE_POINTERS]
    pointers += [chi_u.data_ptr(), tally.data_ptr()]
    pointers += [fields[f].data_ptr() for f in _PACKET_POINTERS]
    with torch.cuda.device(device):
        err = launch(*pointers, n, C, K, float(eps), int(max_steps), stream)
    if err != 0:
        raise RuntimeError(f"trace_voronoi_cuda: CUDA error {err} at launch")
    LAUNCHES[NAME] += 1
