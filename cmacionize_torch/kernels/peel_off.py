"""Wrapper of K8, the CUDA dust peel-off (``csrc/peel_off.cu``).

The wrapper checks what the kernel takes (one CUDA device, dtypes, lengths,
contiguity), launches on PyTorch's current stream and raises if the launch
was refused.  It allocates nothing: the contributions are added into the
CCD it is handed, and τ and the pixel of each event are written only where
the caller hands in tensors for them (the parity checks do).
"""

from __future__ import annotations

import ctypes

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import load_library
from cmacionize_torch.kernels.trace_octree import check_tensors

NAME = "peel_off"


def _launcher():
    fn = load_library(NAME).cmi_peel_off
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_float] * 4
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def view_arrays(view):
    """The host arrays of ``csrc/peel_march.cuh:make_view`` for a
    ``ops.peel_off.PeelOffView``: 22 floats and 7 ints."""
    floats = (*view.march_direction, *view.phase_direction, *view.anchor, *view.cell,
              *view.e1, *view.e2, *view.ccd_anchor, *view.ccd_sides)
    periodic_mask = sum(1 << axis for axis, p in enumerate(view.periodic) if p)
    ints = (*view.shape, periodic_mask, view.max_steps, *view.pixels)
    return (ctypes.c_float * len(floats))(*floats), (ctypes.c_int * len(ints))(*ints)


def check_inputs(caller: str, chi, planes, view, n: int, arrays: dict, expected) -> torch.device:
    """Check what K8 and K8p take: χ and the CCD planes of ``view``'s
    sizes, then each of ``expected`` (label, dtype, numel) in ``arrays``
    that is not None, all contiguous on one CUDA device, with sizes that fit
    int32.  Returns the device."""
    ncell = view.shape[0] * view.shape[1] * view.shape[2]
    npix = view.pixels[0] * view.pixels[1]
    if max(3 * n, ncell, npix) >= 2**31:
        raise ValueError(f"{caller}: sizes must fit int32")
    arrays = {"chi": chi, **{f"ccd{k}": p for k, p in enumerate(planes)}, **arrays}
    expected = [("chi", torch.float32, ncell),
                *((f"ccd{k}", torch.float32, npix) for k in range(len(planes))), *expected]
    check_tensors(caller, chi.device, arrays, [e for e in expected if arrays[e[0]] is not None])
    return chi.device


def peel_off_cuda(chi: torch.Tensor, position: torch.Tensor, direction, weight: torch.Tensor,
                  active: torch.Tensor, ccd: torch.Tensor, *, view, albedo: float = 1.0,
                  hgg: float = 0.0, tau_out=None, pix_out=None) -> None:
    """Peel off the ``active`` events at ``position`` ([n, 3] cell units)
    into ``ccd`` (flat npx·npy), in place: weight / 4π · exp(−τ) at emission
    (``direction`` None), weight · albedo · HG(d·o) · exp(−τ) at a scattering
    (``direction`` [n, 3]).  ``tau_out`` ([n] f32) and ``pix_out`` ([n]
    int32) receive each active event's τ and pixel (0 and −1 elsewhere)."""
    n = position.shape[0]
    arrays = {"position": position, "direction": direction, "weight": weight,
              "active": active, "tau_out": tau_out, "pix_out": pix_out}
    device = check_inputs("peel_off_cuda", chi, (ccd,), view, n, arrays, [
        ("position", torch.float32, 3 * n), ("direction", torch.float32, 3 * n),
        ("weight", torch.float32, n), ("active", torch.bool, n),
        ("tau_out", torch.float32, n), ("pix_out", torch.int32, n)])
    launch = _launcher()
    view_f, view_i = view_arrays(view)
    pointers = [None if t is None else t.data_ptr() for t in (
        chi, position, direction, weight, active, ccd, tau_out, pix_out)]
    stream = torch.cuda.current_stream(device).cuda_stream
    g = float(hgg)
    with torch.cuda.device(device):
        err = launch(*pointers, view_f, view_i, float(albedo), 1.0 - g * g, 1.0 + g * g,
                     2.0 * g, n, stream)
    if err != 0:
        raise RuntimeError(f"peel_off_cuda: CUDA error {err} at launch")
    LAUNCHES[NAME] += 1
