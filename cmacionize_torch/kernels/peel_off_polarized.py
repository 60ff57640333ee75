"""Wrapper of K8p, the CUDA polarized dust peel-off
(``csrc/peel_off_polarized.cu``).

The wrapper checks what the kernel takes (one CUDA device, dtypes, lengths,
contiguity) and launches through :mod:`kernels.launch` on PyTorch's current
stream, raising if the launch was refused; the view's arrays are K8's, built
once per view (``kernels/peel_off.py:view_arrays``).  It allocates nothing:
the four Stokes contributions are added into the I, Q, U, V planes it is
handed, and τ and the pixel of each event are written only where the caller
hands in tensors for them.
"""

from __future__ import annotations

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.launch import Launcher
from cmacionize_torch.kernels.peel_off import check_inputs, view_arrays

NAME = "peel_off_polarized"
_PEEL_OFF_POLARIZED = Launcher(NAME, "cmi_peel_off_polarized", 17, 1, 7)


def _pointer(t) -> int | None:
    return None if t is None else t.data_ptr()


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
    index = check_inputs("peel_off_polarized_cuda", chi, planes, view, n, arrays, expected)
    g = float(band.hgg)
    # the band's constants formed in double and rounded once to f32 by ctypes
    _PEEL_OFF_POLARIZED(
        index, chi.data_ptr(), position.data_ptr(), direction.data_ptr(), nref.data_ptr(),
        *(s.data_ptr() for s in stokes), active.data_ptr(), *(p.data_ptr() for p in planes),
        _pointer(tau_out), _pointer(pix_out), *view_arrays(view).addresses, n,
        1.0 - g * g, 1.0 + g * g, 2.0 * g, -float(band.pl), -float(band.pc),
        float(band.sc) * 3.13, float(band.albedo))
    LAUNCHES[NAME] += 1
