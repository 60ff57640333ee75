"""Wrapper of K6s, the CUDA spectral face-plane march over a Voronoi cell
graph (``csrc/trace_voronoi_spectral.cu``).

As :mod:`cmacionize_torch.kernels.trace_voronoi`, with per-packet σ_H, σ_He
and frequency bin, and a flat [n_bins·C] tally.  Packet state and the tally
are updated in place; the caller hands in copies of the packet state.
"""

from __future__ import annotations

import ctypes

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import load_library
from cmacionize_torch.kernels.trace_voronoi import check_march_inputs

NAME = "trace_voronoi_spectral"

_TABLE_POINTERS = ("neighbors", "normals", "offsets", "shifts")
_PACKET_POINTERS = ("pos", "dirn", "cell", "tau_left", "weight", "sig_h", "sig_he", "fbin",
                    "active", "absorbed")


def _launcher():
    fn = load_library(NAME).cmi_trace_voronoi_spectral
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                           ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def trace_voronoi_spectral_cuda(tables, chi_h_u: torch.Tensor, chi_he_u: torch.Tensor,
                                tally: torch.Tensor, fields: dict, *, n_bins: int,
                                eps: float, max_steps: int) -> None:
    """March the packets in ``fields`` (SpectralVoronoiPacketBatch field name
    → tensor) to termination, adding ℓ·w (box units) into
    ``tally[fbin·C + cell]``, in place.  ``chi_h_u`` / ``chi_he_u``: [C] f32
    n_H·x_H and n_H·A_He·x_He per box unit."""
    C = tables.neighbors.shape[0] if tables.neighbors.dim() == 2 else -1
    n = fields["cell"].numel()
    n, C, K = check_march_inputs(
        "trace_voronoi_spectral_cuda", tables, fields,
        {
            "chi_h": (chi_h_u, torch.float32, C),
            "chi_he": (chi_he_u, torch.float32, C),
            "tally": (tally, torch.float32, n_bins * C),
            "sig_h": (fields["sig_h"], torch.float32, n),
            "sig_he": (fields["sig_he"], torch.float32, n),
            "fbin": (fields["fbin"], torch.int32, n),
        },
    )
    if n_bins < 1 or max_steps < 0 or n_bins * C >= 2**31:
        raise ValueError("trace_voronoi_spectral_cuda: n_bins >= 1, max_steps >= 0, "
                         "n_bins * C must fit int32")
    device = chi_h_u.device
    launch = _launcher()
    stream = torch.cuda.current_stream(device).cuda_stream
    pointers = [getattr(tables, f).data_ptr() for f in _TABLE_POINTERS]
    pointers += [chi_h_u.data_ptr(), chi_he_u.data_ptr(), tally.data_ptr()]
    pointers += [fields[f].data_ptr() for f in _PACKET_POINTERS]
    with torch.cuda.device(device):
        err = launch(*pointers, n, C, K, n_bins, float(eps), int(max_steps), stream)
    if err != 0:
        raise RuntimeError(f"trace_voronoi_spectral_cuda: CUDA error {err} at launch")
    LAUNCHES[NAME] += 1
