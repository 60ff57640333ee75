"""Wrapper of K8p, the CUDA polarized dust peel-off
(``csrc/peel_off_polarized.cu``).

The wrapper checks what the kernel takes (one CUDA device, dtypes, lengths,
contiguity), launches on PyTorch's current stream and raises if the launch
was refused.  It allocates nothing: the four Stokes contributions are added
into the I, Q, U, V planes it is handed, and τ and the pixel of each event
are written only where the caller hands in tensors for them.
"""

from __future__ import annotations

import ctypes

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import load_library
from cmacionize_torch.kernels.peel_off import check_inputs, view_arrays

NAME = "peel_off_polarized"


def _launcher():
    fn = load_library(NAME).cmi_peel_off_polarized
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def peel_off_polarized_cuda(chi: torch.Tensor, position: torch.Tensor,
                            direction: torch.Tensor, nref: torch.Tensor, stokes, active,
                            planes, *, view, band, tau_out=None, pix_out=None) -> None:
    """Peel off the ``active`` scattering events at ``position`` ([n, 3] cell
    units) with directions ``direction`` and reference normals ``nref`` ([n,
    3]) and Stokes vectors ``stokes`` (I, Q, U, V, each [n]) into ``planes``
    (I, Q, U, V, each flat npx·npy), in place, each component times
    albedo · exp(−τ).  ``tau_out`` / ``pix_out`` as in ``peel_off_cuda``."""
    n = position.shape[0]
    planes = tuple(planes)
    stokes = tuple(stokes)
    if len(planes) != 4 or len(stokes) != 4:
        raise ValueError("peel_off_polarized_cuda: four Stokes components and four planes")
    arrays = {"position": position, "direction": direction, "nref": nref, "active": active,
              "tau_out": tau_out, "pix_out": pix_out,
              **{f"stokes{k}": s for k, s in enumerate(stokes)}}
    expected = [(name, torch.float32, 3 * n) for name in ("position", "direction", "nref")]
    expected += [(f"stokes{k}", torch.float32, n) for k in range(4)]
    expected += [("active", torch.bool, n), ("tau_out", torch.float32, n),
                 ("pix_out", torch.int32, n)]
    device = check_inputs("peel_off_polarized_cuda", chi, planes, view, n, arrays, expected)
    launch = _launcher()
    view_f, view_i = view_arrays(view)
    g = float(band.hgg)
    band_f = (ctypes.c_float * 7)(1.0 - g * g, 1.0 + g * g, 2.0 * g, -float(band.pl),
                                  -float(band.pc), float(band.sc) * 3.13, float(band.albedo))
    pointers = [None if t is None else t.data_ptr() for t in (
        chi, position, direction, nref, *stokes, active, *planes, tau_out, pix_out)]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = launch(*pointers, view_f, view_i, band_f, n, stream)
    if err != 0:
        raise RuntimeError(f"peel_off_polarized_cuda: CUDA error {err} at launch")
    LAUNCHES[NAME] += 1
