"""Wrapper of K6, the CUDA face-plane march over a Voronoi cell graph
(``csrc/trace_voronoi.cu``).

The wrapper checks what the kernel takes (one CUDA device, dtypes, lengths,
contiguity, int32 sizes, the packed face rows of the tables) and launches on
PyTorch's current stream through :mod:`cmacionize_torch.kernels.launch`,
which raises if the launch was refused.  It allocates nothing: packet state
and the tally are updated in place, and the caller
(:func:`cmacionize_torch.models.voronoi.trace_packets_voronoi`) hands in
copies of the packet state.  ``check_march_inputs`` is shared with K6s.
"""

from __future__ import annotations

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.launch import Launcher, kernel_occupancy

NAME = "trace_voronoi"

_POINTER_ORDER = ("faces", "face_count", "neighbors", "shifts", "chi", "tally", "pos", "dirn",
                  "cell", "tau_left", "weight", "active", "absorbed")
# then n, C, K and max_steps, then eps
_TRACE_VORONOI = Launcher(NAME, "cmi_trace_voronoi", len(_POINTER_ORDER), 4, 1)


def check_march_inputs(name, tables, fields, arrays: dict) -> tuple:
    """Check the tensors a face-plane march takes (the packed face rows, the
    neighbour and shift rows, the packet fields); returns (P, C, K).

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
        "faces": (tables.faces, torch.float32, C * K * 4),
        "face_count": (tables.face_count, torch.int32, C),
        "neighbors": (nbr, torch.int32, C * K),
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
    if max(n * 3, C * K * 4) >= 2**31:
        raise ValueError(f"{name}: sizes must fit int32")
    if tables.faces.data_ptr() % 16:
        raise ValueError(f"{name}: faces must be 16-byte aligned (one float4 a face)")
    return n, C, K


def occupancy(device) -> dict:
    """Registers per thread and blocks of 256 resident per SM of K6, and the
    SM count of CUDA ``device``."""
    return kernel_occupancy(NAME, "cmi_trace_voronoi_occupancy", device)


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
    if n == 0:  # no packet: no launch
        return
    arrays = {**tables._asdict(), **fields, "chi": chi_u, "tally": tally}
    _TRACE_VORONOI(chi_u.device.index, *(arrays[f].data_ptr() for f in _POINTER_ORDER),
                   n, C, K, int(max_steps), float(eps))
    LAUNCHES[NAME] += 1
