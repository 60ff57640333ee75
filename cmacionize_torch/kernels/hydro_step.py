"""Wrapper of K3, the CUDA MUSCL-Hancock step (``csrc/hydro_step.cu``).

The wrapper checks what the kernel takes (one CUDA device, f32, shapes,
contiguity, a known solver), allocates the output state and the kernel's
scratch with ``torch.empty``, launches on PyTorch's current stream and raises
if the launch was refused.  The f32 constants the kernel needs are formed
here in double from γ, dt and the cell size and rounded once, as the JAX
step's weakly typed Python scalars are.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import load_library

NAME = "hydro_step"
SCRATCH_FIELDS = 20  # 5 predicted primitives + 3 axes x 5 slopes
EXACT_NEWTON_ITERATIONS = 20  # riemann.exact_flux's n_iter
_SOLVERS = {"HLLC": 0, "Exact": 1}


def _launcher():
    fn = load_library(NAME).cmi_hydro_step
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def kernel_constants(gamma: float, dt: float, cell_size) -> np.ndarray:
    """The 18 f32 constants of ``Consts`` in ``csrc/hydro_step.cu``, each
    formed in double as the JAX expressions form it, then rounded once."""
    g = float(gamma)
    dt = float(np.float32(dt))
    values = [
        g,
        g - 1.0,
        (g + 1.0) / (2.0 * g),
        g + 1.0,
        (g - 1.0) / (g + 1.0),
        (g - 1.0) / (2.0 * g),
        1.0 / ((g - 1.0) / (2.0 * g)),
        -(g + 1.0) / (2.0 * g),
        0.5 * (g - 1.0),
        2.0 / (g + 1.0),
        2.0 / (g - 1.0),
        2.0 * g / (g - 1.0),
        1.0 / g,
        dt,
        0.5 * dt,
        *(1.0 / float(cell_size[a]) for a in range(3)),
    ]
    return np.asarray(values, dtype=np.float32)


def hydro_step_cuda(u, wp, dt: float, *, cell_size, gamma: float,
                    riemann_solver: str = "HLLC"):
    """K3: one MUSCL-Hancock step from padded primitives.

    ``u``: 5 conserved fields [nx, ny, nz]; ``wp``: 5 primitives padded with
    2 ghosts per side [nx+4, ny+4, nz+4]; all f32, contiguous, on one CUDA
    device.  Returns the 5 updated conserved fields (new tensors), with the
    density floor applied.
    """
    if riemann_solver not in _SOLVERS:
        raise ValueError(f"hydro_step_cuda: unknown Riemann solver {riemann_solver!r}")
    u, wp = tuple(u), tuple(wp)
    if len(u) != 5 or len(wp) != 5:
        raise ValueError("hydro_step_cuda: u and wp must hold 5 fields each")
    device = u[0].device
    if device.type != "cuda":
        raise ValueError(f"hydro_step_cuda needs CUDA tensors, got {device}")
    shape = tuple(u[0].shape)
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"hydro_step_cuda: u must be 3-D fields, got shape {shape}")
    nx, ny, nz = shape
    padded = (nx + 4, ny + 4, nz + 4)
    for name, fields, want in (("u", u, shape), ("wp", wp, padded)):
        for i, t in enumerate(fields):
            if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(
                    f"hydro_step_cuda: {name}[{i}] must be float32 of shape {want} "
                    f"on {device}; got {t.dtype} of {tuple(t.shape)} on {t.device}"
                )
            if not t.is_contiguous():
                raise ValueError(f"hydro_step_cuda: {name}[{i}] must be contiguous")
    n1 = (nx + 2) * (ny + 2) * (nz + 2)
    if SCRATCH_FIELDS * n1 >= 2**31:
        raise ValueError("hydro_step_cuda: sizes must fit int32")

    out = [torch.empty(shape, dtype=torch.float32, device=device) for _ in range(5)]
    scratch = torch.empty(SCRATCH_FIELDS * n1, dtype=torch.float32, device=device)
    consts = kernel_constants(gamma, dt, cell_size)
    launch = _launcher()
    stream = torch.cuda.current_stream(device).cuda_stream
    pointers = [t.data_ptr() for t in (*wp, *u, *out, scratch)]
    with torch.cuda.device(device):
        err = launch(
            *pointers, consts.ctypes.data, nx, ny, nz,
            _SOLVERS[riemann_solver], EXACT_NEWTON_ITERATIONS, stream,
        )
    if err != 0:
        raise RuntimeError(f"hydro_step_cuda: CUDA error {err} at launch")
    LAUNCHES[NAME] += 1
    return tuple(out)
