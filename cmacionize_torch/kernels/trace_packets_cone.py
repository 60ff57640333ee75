"""Wrapper of K10, the CUDA cone march (``csrc/trace_packets_cone.cu``).

The wrapper checks what the kernel takes (one CUDA device, dtypes, shapes,
contiguity, the chunk and slab the kernel was written for) and launches on
PyTorch's current stream through :mod:`cmacionize_torch.kernels.launch`,
which raises if the launch was refused.  It allocates nothing: the tally
(zeroed by the caller) and the packet state are updated in place, and the
caller (:func:`cmacionize_torch.tools.experimental_cone_kernel.trace_packets_cone`)
hands in copies.
"""

from __future__ import annotations

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.launch import Launcher, kernel_occupancy

NAME = "trace_packets_cone"
# compile-time constants of csrc/trace_packets_cone.cu: one block of CHUNK
# threads per chunk, an SLAB³ slab in shared memory
CHUNK = 512
SLAB = 8
# the kernel orders lanes by (lag metric + nx + ny + nz) · CHUNK + lane in
# one int32, and packs a slab corner's x and y into one
MAX_SIDE_SUM = 2**21
MAX_SIDE = 2**15
# chi, tally, pf, pi; then P, nx, ny, nz and max_phases
_LAUNCH = Launcher(NAME, "cmi_trace_packets_cone", 4, 5)


def occupancy(device) -> dict:
    """Registers per thread and blocks of 512 resident per SM of K10, and the
    SM count of CUDA ``device``."""
    return kernel_occupancy(NAME, "cmi_trace_packets_cone_occupancy", device)


def check_cone(chi3d, tally, pf, pi, shape, slab: int, chunk: int, max_phases: int) -> int:
    """K10's checks: the CUDA device index of its launch, or ValueError."""
    nx, ny, nz = (int(s) for s in shape)
    device = chi3d.device
    if device.type != "cuda":
        raise ValueError(f"trace_packets_cone_cuda needs CUDA tensors, got {device}")
    if slab != SLAB or chunk != CHUNK:
        raise ValueError(
            f"trace_packets_cone_cuda: K10 is built for slab={SLAB}, chunk={CHUNK}; "
            f"got slab={slab}, chunk={chunk}")
    P = pf.shape[0]
    expected = (
        ("chi3d", chi3d, torch.float32, (nx, ny, nz)),
        ("tally", tally, torch.float32, (nx, ny, nz)),
        ("pf", pf, torch.float32, (P, 8)),
        ("pi", pi, torch.int32, (P, 8)),
    )
    for name, t, dtype, size in expected:
        if t.device != device or t.dtype != dtype or tuple(t.shape) != size:
            raise ValueError(
                f"trace_packets_cone_cuda: {name} must be {dtype} {size} on {device}; "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"trace_packets_cone_cuda: {name} must be contiguous")
    if P % chunk or min(nx, ny, nz) < slab:
        raise ValueError("trace_packets_cone_cuda: P % chunk != 0 or grid smaller than slab")
    if (max(8 * P, nx * ny * nz) >= 2**31 or nx + ny + nz >= MAX_SIDE_SUM
            or max(nx, ny, nz) >= MAX_SIDE or max_phases < 0):
        raise ValueError("trace_packets_cone_cuda: sizes must fit int32")
    return device.index if device.index is not None else torch.cuda.current_device()


def trace_packets_cone_cuda(
    chi3d: torch.Tensor,
    tally: torch.Tensor,
    pf: torch.Tensor,
    pi: torch.Tensor,
    *,
    shape,
    slab: int,
    chunk: int,
    max_phases: int,
) -> None:
    """March the packets of ``pf``/``pi`` ([P, 8] f32 / i32) for at most
    ``max_phases`` phases per chunk, adding ℓ·w into ``tally`` ([nx, ny, nz]
    f32), all in place."""
    index = check_cone(chi3d, tally, pf, pi, shape, slab, chunk, max_phases)
    nx, ny, nz = (int(s) for s in shape)
    _LAUNCH(index, chi3d.data_ptr(), tally.data_ptr(), pf.data_ptr(), pi.data_ptr(),
            pf.shape[0], nx, ny, nz, int(max_phases))
    LAUNCHES[NAME] += 1
