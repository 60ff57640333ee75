"""Wrapper of K6s, the CUDA spectral face-plane march over a Voronoi cell
graph (``csrc/trace_voronoi_spectral.cu``).

As :mod:`cmacionize_torch.kernels.trace_voronoi`, with per-packet σ_H, σ_He
and frequency bin, and a flat [n_bins·C] tally.  Packet state and the tally
are updated in place; the caller hands in copies of the packet state.  It
launches through :mod:`cmacionize_torch.kernels.launch`.
"""

from __future__ import annotations

import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.launch import Launcher, kernel_occupancy
from cmacionize_torch.kernels.trace_voronoi import check_march_inputs

NAME = "trace_voronoi_spectral"

_POINTER_ORDER = ("faces", "face_count", "neighbors", "shifts", "chi_h", "chi_he", "tally",
                  "pos", "dirn", "cell", "tau_left", "weight", "sig_h", "sig_he", "fbin",
                  "active", "absorbed")
# then n, C, K and max_steps, then eps
_LAUNCH = Launcher(NAME, "cmi_trace_voronoi_spectral", len(_POINTER_ORDER), 4, 1)


def occupancy(device) -> dict:
    """Registers per thread and blocks of 256 resident per SM of K6s, and the
    SM count of CUDA ``device``."""
    return kernel_occupancy(NAME, "cmi_trace_voronoi_spectral_occupancy", device)


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
    # the slot fbin·C + cell is int32 arithmetic, as in the JAX march
    if n_bins < 1 or max_steps < 0 or n_bins * C >= 2**31:
        raise ValueError("trace_voronoi_spectral_cuda: n_bins >= 1, max_steps >= 0, "
                         "n_bins * C must fit int32")
    if n == 0:  # no packet: no launch
        return
    arrays = {**tables._asdict(), **fields, "chi_h": chi_h_u, "chi_he": chi_he_u,
              "tally": tally}
    _LAUNCH(chi_h_u.get_device(), *(arrays[f].data_ptr() for f in _POINTER_ORDER),
            n, C, K, int(max_steps), float(eps))
    LAUNCHES[NAME] += 1
