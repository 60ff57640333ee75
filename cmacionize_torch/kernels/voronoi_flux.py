"""Wrapper of K7, the CUDA moving-face Godunov update on a Voronoi cell graph
(``csrc/voronoi_flux.cu``).

The wrapper checks what the kernel takes (one CUDA device, dtypes, shapes,
contiguity), allocates the new state and the kernel's scratch (limited
gradients, predicted primitives, trial flags) with ``torch.empty``, launches
on PyTorch's current stream and raises if a launch was refused.  The f32
constants are formed here in double from γ, dt and the slope factor and
rounded once, as the JAX function's weakly typed Python scalars are.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import load_library

NAME = "voronoi_flux"


def _launcher():
    fn = load_library(NAME).cmi_voronoi_flux
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def kernel_constants(gamma: float, dt: float, slope_factor: float) -> np.ndarray:
    """The 6 f32 constants of ``Consts`` in ``csrc/voronoi_flux.cu``."""
    g = float(gamma)
    dt = float(np.float32(dt))
    return np.asarray(
        [g, g - 1.0, (g + 1.0) / (2.0 * g), dt, 0.5 * dt, float(slope_factor)],
        dtype=np.float32)


def voronoi_flux_update_cuda(neighbors, normals, area_over_vol, face_rel, nbr_rel, state,
                             gen_vel, dt: float, *, gamma: float, second_order: bool = True,
                             slope_factor: float = 0.5, stats: Optional[dict] = None):
    """K7: one update of the 5 intensive conserved fields ``state`` ([C] f32
    each) over the [C, K] rows; returns the 5 new fields (new tensors).
    With ``stats`` (second order), ``stats["flag"]`` receives the trial
    flags [C] bool and ``stats["gradients"]`` the limited gradients
    [5, C, 3]."""
    state = tuple(state)
    if len(state) != 5:
        raise ValueError("voronoi_flux_update_cuda: state must hold 5 fields")
    device = neighbors.device
    if device.type != "cuda":
        raise ValueError(f"voronoi_flux_update_cuda needs CUDA tensors, got {device}")
    if neighbors.dim() != 2:
        raise ValueError("voronoi_flux_update_cuda: neighbors must be [C, K]")
    C, K = neighbors.shape
    expected = {
        "neighbors": (neighbors, torch.int32, (C, K)),
        "normals": (normals, torch.float32, (C, K, 3)),
        "area_over_vol": (area_over_vol, torch.float32, (C, K)),
        "face_rel": (face_rel, torch.float32, (C, K, 3)),
        "nbr_rel": (nbr_rel, torch.float32, (C, K, 3)),
        "gen_vel": (gen_vel, torch.float32, (C, 3)),
        **{f"state[{i}]": (f, torch.float32, (C,)) for i, f in enumerate(state)},
    }
    for label, (t, dtype, shape) in expected.items():
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"voronoi_flux_update_cuda: {label} must be {dtype} of shape {shape} on "
                f"{device}; got {t.dtype} of {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"voronoi_flux_update_cuda: {label} must be contiguous")
    if 15 * C >= 2**31 or 3 * C * K >= 2**31:
        raise ValueError("voronoi_flux_update_cuda: sizes must fit int32")

    out = [torch.empty(C, dtype=torch.float32, device=device) for _ in range(5)]
    if second_order:
        grad = torch.empty((5, C, 3), dtype=torch.float32, device=device)
        pred = torch.empty((5, C), dtype=torch.float32, device=device)
        flag = torch.empty(C, dtype=torch.uint8, device=device)
        scratch = [grad.data_ptr(), pred.data_ptr(), flag.data_ptr()]
    else:
        scratch = [None, None, None]
    consts = kernel_constants(gamma, dt, slope_factor)
    launch = _launcher()
    stream = torch.cuda.current_stream(device).cuda_stream
    pointers = [t.data_ptr() for t in (*state, *out, neighbors, normals, area_over_vol,
                                       face_rel, nbr_rel, gen_vel)]
    with torch.cuda.device(device):
        err = launch(*pointers, *scratch, consts.ctypes.data, C, K, int(bool(second_order)),
                     stream)
    if err != 0:
        raise RuntimeError(f"voronoi_flux_update_cuda: CUDA error {err} at launch")
    LAUNCHES[NAME] += 1
    if stats is not None and second_order:
        stats["flag"] = flag.bool()
        stats["gradients"] = grad
    return tuple(out)
