"""Wrapper of K8, the CUDA dust peel-off (``csrc/peel_off.cu``), and the view
arrays that K8 and K8p share.

The wrapper checks what the kernel takes (one CUDA device, dtypes, lengths,
contiguity) and launches through :mod:`kernels.launch` on PyTorch's current
stream, raising if the launch was refused.  The view's 22 floats and 7 ints
are built once per view (:func:`view_arrays`, kept for the process) and
handed to the launcher by address.  The contributions are added into the CCD
it is handed, and τ and the pixel of each event are written only where the
caller hands in tensors for them (the parity checks do).  K8 takes the
events in the caller's order and counts its launches in
``kernels.LAUNCHES["peel_off"]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.launch import Launcher
from cmacionize_torch.kernels.trace_octree import check_tensors

NAME = "peel_off"
_PEEL_OFF = Launcher(NAME, "cmi_peel_off", 10, 1, 4)


class ViewArrays:
    """The host arrays of ``csrc/peel_march.cuh:make_view`` for one
    ``ops.peel_off.PeelOffView`` (22 floats and 7 ints) with their
    addresses."""

    def __init__(self, view):
        floats = (*view.march_direction, *view.phase_direction, *view.anchor, *view.cell,
                  *view.e1, *view.e2, *view.ccd_anchor, *view.ccd_sides)
        periodic_mask = sum(1 << axis for axis, p in enumerate(view.periodic) if p)
        ints = (*view.shape, periodic_mask, view.max_steps, *view.pixels)
        self.floats = (ctypes.c_float * len(floats))(*floats)
        self.ints = (ctypes.c_int * len(ints))(*ints)
        self.addresses = (ctypes.addressof(self.floats), ctypes.addressof(self.ints))


@functools.lru_cache(maxsize=None)
def view_arrays(view) -> ViewArrays:
    """The :class:`ViewArrays` of ``view``, built at its first call and kept."""
    return ViewArrays(view)


def check_inputs(caller: str, chi, planes, view, n: int, arrays: dict, expected) -> int:
    """Check what K8 and K8p take: χ and the CCD planes of ``view``'s
    sizes, then each of ``expected`` (label, dtype, numel) in ``arrays``
    that is not None, all contiguous on one CUDA device, with sizes that fit
    int32.  Returns the device index."""
    ncell = view.shape[0] * view.shape[1] * view.shape[2]
    npix = view.pixels[0] * view.pixels[1]
    if max(3 * n, ncell, npix) >= 2**31:
        raise ValueError(f"{caller}: sizes must fit int32")
    arrays = {"chi": chi, **{f"ccd{k}": p for k, p in enumerate(planes)}, **arrays}
    expected = [("chi", torch.float32, ncell),
                *((f"ccd{k}", torch.float32, npix) for k in range(len(planes))), *expected]
    check_tensors(caller, chi.device, arrays, [e for e in expected if arrays[e[0]] is not None])
    return chi.get_device()


def _pointer(t) -> int | None:
    return None if t is None else t.data_ptr()


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
    index = check_inputs("peel_off_cuda", chi, (ccd,), view, n, arrays, [
        ("position", torch.float32, 3 * n), ("direction", torch.float32, 3 * n),
        ("weight", torch.float32, n), ("active", torch.bool, n),
        ("tau_out", torch.float32, n), ("pix_out", torch.int32, n)])
    g = float(hgg)
    _PEEL_OFF(index, chi.data_ptr(), position.data_ptr(), _pointer(direction), weight.data_ptr(),
              active.data_ptr(), ccd.data_ptr(), _pointer(tau_out), _pointer(pix_out),
              *view_arrays(view).addresses, n, float(albedo),
              1.0 - g * g, 1.0 + g * g, 2.0 * g)
    LAUNCHES[NAME] += 1
