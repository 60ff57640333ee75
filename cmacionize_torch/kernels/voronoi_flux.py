"""Wrapper of K7, the CUDA moving-face Godunov update on a Voronoi cell graph
(``csrc/voronoi_flux.cu``).

The wrapper checks what the kernel takes (one CUDA device, dtypes, shapes,
contiguity, at most 256 face slots a row), allocates the new state as one
[5, C] tensor, launches through :mod:`cmacionize_torch.kernels.launch` on
PyTorch's current stream and raises if a launch was refused.  Its scratch
(a 128-byte record a cell: the primitives, the grid velocity, the predicted
primitives and the limited gradients; the trial flags and their count) is
kept per device and stream and made anew for more cells.  The f32 constants
are formed here in double from γ, dt and the slope factor and rounded once,
as the JAX function's weakly typed Python scalars are.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import library_path
from cmacionize_torch.kernels.launch import Launcher, kernel_occupancy, raw_stream

NAME = "voronoi_flux"
MAX_SLOTS = 256  # kBlock in voronoi_flux.cu: a block's threads, so a row's slots at most
RECORD = 32  # kRecord in voronoi_flux.cu: floats a cell's record
GRADIENTS = slice(13, 28)  # the limited gradients' floats in a record, q * 3 + axis
_LAUNCH = Launcher(NAME, "cmi_voronoi_flux", 15, 3, 6)
_OCCUPANCY = {"gradients": "cmi_voronoi_gradients_occupancy",
              "trial": "cmi_voronoi_trial_occupancy",
              "update": "cmi_voronoi_update_occupancy"}
_SCRATCH: dict = {}  # (device index, raw stream) → (f32 [32 C], uint8 [C + pad + 4])
KERNELS = ("primitives", "gradients", "trial", "update")  # voronoi_flux.cu's, in launch order
_PTXAS_FUNCTION = re.compile(r"Function properties for (\S+)")
_PTXAS_FRAME = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")


def kernel_constants(gamma: float, dt: float, slope_factor: float) -> np.ndarray:
    """The 6 f32 constants of ``Consts`` in ``csrc/voronoi_flux.cu``."""
    g = float(gamma)
    dt = float(np.float32(dt))
    return np.asarray(
        [g, g - 1.0, (g + 1.0) / (2.0 * g), dt, 0.5 * dt, float(slope_factor)],
        dtype=np.float32)


def occupancy(device) -> dict:
    """Registers per thread and blocks of 256 resident per SM of K7's
    gradient, trial and update kernels, and the SM count of CUDA
    ``device``: {kernel: {"registers", "blocks_per_sm", "sms"}}."""
    return {name: kernel_occupancy(NAME, symbol, device) for name, symbol in _OCCUPANCY.items()}


def ptxas_report(log_text: str | None = None) -> dict:
    """Registers, stack bytes and spill bytes of K7's four kernels, from
    ``ptxas -v``'s report in the build log of ``csrc/voronoi_flux.cu`` (or
    ``log_text``): {kernel: {"registers", "stack", "spill_stores",
    "spill_loads"}}."""
    if log_text is None:
        log_text = library_path(NAME).with_suffix(".log").read_text()
    found, current = {}, None
    for line in log_text.splitlines():
        if (m := _PTXAS_FUNCTION.search(line)) is not None:
            current = next((k for k in KERNELS if f"{k}_kernel" in m.group(1)), None)
        elif current is not None and (m := _PTXAS_FRAME.search(line)) is not None:
            found.setdefault(current, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        elif current is not None and (m := _PTXAS_USED.search(line)) is not None:
            found.setdefault(current, {})["registers"] = int(m.group(1))
            current = None
    return found


def _flagged_offset(C: int) -> int:
    """The byte of the flags' scratch where the int count of flagged cells
    sits: past the C flags, 4-byte aligned."""
    return -(-C // 4) * 4


def _scratch(index: int, device, C: int) -> tuple:
    """K7's scratch on this device and its current stream, for at least
    ``C`` cells: (f32 [32 C]: the cells' records; uint8: the C trial flags,
    then the count of flagged cells as an int at :func:`_flagged_offset`)."""
    key = (index, raw_stream(index))
    scratch = _SCRATCH.get(key)
    if scratch is None or scratch[0].numel() < RECORD * C:
        scratch = (torch.empty(RECORD * C, dtype=torch.float32, device=device),
                   torch.empty(_flagged_offset(C) + 4, dtype=torch.uint8, device=device))
        if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
            _SCRATCH[key] = scratch
    return scratch


def _check(neighbors, normals, area_over_vol, face_rel, nbr_rel, state, gen_vel) -> tuple:
    """(C, K) of the rows; raises ValueError on what K7 does not take."""
    if len(state) != 5:
        raise ValueError("voronoi_flux_update_cuda: state must hold 5 fields")
    if neighbors.dim() != 2:
        raise ValueError("voronoi_flux_update_cuda: neighbors must be [C, K]")
    C, K = neighbors.shape
    if K > MAX_SLOTS:
        raise ValueError(f"voronoi_flux_update_cuda: at most {MAX_SLOTS} face slots a row, "
                         f"got K = {K}")
    if RECORD * C >= 2**31 or 3 * C * K >= 2**31:
        raise ValueError("voronoi_flux_update_cuda: sizes must fit int32")
    device = neighbors.device
    if device.type != "cuda":
        raise ValueError(f"voronoi_flux_update_cuda needs CUDA tensors, got {device}")
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
    return C, K


def voronoi_flux_update_cuda(neighbors, normals, area_over_vol, face_rel, nbr_rel, state,
                             gen_vel, dt: float, *, gamma: float, second_order: bool = True,
                             slope_factor: float = 0.5, stats: Optional[dict] = None):
    """K7: one update of the 5 intensive conserved fields ``state`` ([C] f32
    each) over the [C, K] rows; returns the 5 new fields (the rows of one
    new [5, C] tensor).  With ``stats`` (second order), ``stats["flag"]``
    receives the trial flags [C] bool and ``stats["gradients"]`` the limited
    gradients [5, C, 3]."""
    state = tuple(state)
    C, K = _check(neighbors, normals, area_over_vol, face_rel, nbr_rel, state, gen_vel)
    index, device = neighbors.get_device(), neighbors.device
    record, flag = _scratch(index, device, C)
    out = torch.empty((5, C), dtype=torch.float32, device=device)
    _LAUNCH(index, *(f.data_ptr() for f in state), out.data_ptr(), neighbors.data_ptr(),
            normals.data_ptr(), area_over_vol.data_ptr(), face_rel.data_ptr(),
            nbr_rel.data_ptr(), gen_vel.data_ptr(), record.data_ptr(), flag.data_ptr(),
            flag.data_ptr() + _flagged_offset(C), C, K, int(bool(second_order)),
            *(float(v) for v in kernel_constants(gamma, dt, slope_factor)))
    LAUNCHES[NAME] += 1
    if stats is not None and second_order:
        stats["flag"] = flag[:C].bool()
        stats["gradients"] = (record[:RECORD * C].view(C, RECORD)[:, GRADIENTS]
                              .reshape(C, 5, 3).permute(1, 0, 2).contiguous())
    return tuple(out.unbind(0))
