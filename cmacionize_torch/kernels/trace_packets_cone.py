"""Wrapper of K10, the CUDA cone march (``csrc/trace_packets_cone.cu``).

The wrapper checks what the kernel takes (one CUDA device, dtypes, shapes,
contiguity, the chunk and slab the kernel was written for), launches on
PyTorch's current stream and raises if the launch was refused.  It
allocates nothing: the tally (zeroed by the caller) and the packet state are
updated in place, and the caller
(:func:`cmacionize_torch.tools.experimental_cone_kernel.trace_packets_cone`)
hands in copies.
"""

from __future__ import annotations

import ctypes

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import load_library

NAME = "trace_packets_cone"
# compile-time constants of csrc/trace_packets_cone.cu: one block of CHUNK
# threads per chunk, an SLAB³ slab in shared memory
CHUNK = 512
SLAB = 8


def _launcher():
    fn = load_library(NAME).cmi_trace_packets_cone
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
    if max(8 * P, nx * ny * nz) >= 2**31 or max_phases < 0:
        raise ValueError("trace_packets_cone_cuda: sizes must fit int32")

    launch = _launcher()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = launch(chi3d.data_ptr(), tally.data_ptr(), pf.data_ptr(), pi.data_ptr(),
                     P, nx, ny, nz, int(max_phases), stream)
    if err != 0:
        raise RuntimeError(f"trace_packets_cone_cuda: CUDA error {err} at launch")
    LAUNCHES[NAME] += 1
