"""Wrapper of K3, the CUDA MUSCL-Hancock step (``csrc/hydro_step.cu``).

Two entry points launch the one templated kernel, once a step:

- :func:`hydro_step_conserved_cuda`, (U): from the conserved state and the
  ghost map of the walls (``ops/hydro.py:ghost_maps``); the kernel forms the
  primitives and the ghosts itself;
- :func:`hydro_step_cuda`, (P): from primitives padded with 2 ghosts per side
  (inflow ghosts, a halo exchange's).

Each checks what the kernel takes (one CUDA device, f32, shapes,
contiguity, a known solver), allocates the new state as one [5, nx, ny, nz]
tensor and launches through :mod:`cmacionize_torch.kernels.launch` on
PyTorch's current stream, which raises if the launch was refused.  The f32
constants the kernel needs are formed here in double from γ, dt and the cell
size and rounded once, as the JAX step's weakly typed Python scalars are.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.launch import Launcher, kernel_occupancy

NAME = "hydro_step"
EXACT_NEWTON_ITERATIONS = 20  # riemann.exact_flux's n_iter
BRICK = (4, 8, 16)  # kBX, kBY, kBZ in hydro_step.cu: the cells a block owns
_SOLVERS = {"HLLC": 0, "Exact": 1}
# the 5 source fields, the ghost map, u and out; nx, ny, nz, from_conserved,
# exact, n_iter; the 18 constants of kernel_constants
_LAUNCH = Launcher(NAME, "cmi_hydro_step", 16, 6, 18)


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


@functools.lru_cache(maxsize=64)
def _constants(gamma: float, dt: float, cell_size: tuple) -> tuple:
    return tuple(float(v) for v in kernel_constants(gamma, dt, cell_size))


def occupancy(device) -> dict:
    """Registers per thread and blocks resident per SM of K3's HLLC kernels,
    (U) and (P), and the SM count of CUDA ``device``."""
    return {form: kernel_occupancy(NAME, f"cmi_hydro_step_{form}_occupancy", device)
            for form in ("u", "p")}


def _check(label: str, groups, riemann_solver: str) -> int:
    """The CUDA device index of the tensors in ``groups`` ((name, tensors,
    shape, dtype), ...), which must have those shapes and dtypes and lie,
    contiguous, on one CUDA device; raises ValueError naming the first that
    does not."""
    if riemann_solver not in _SOLVERS:
        raise ValueError(f"{label}: unknown Riemann solver {riemann_solver!r}")
    first = groups[0][1][0]
    if not first.is_cuda:
        raise ValueError(f"{label} needs CUDA tensors, got {first.device}")
    index = first.get_device()
    for name, tensors, shape, dtype in groups:
        for i, t in enumerate(tensors):
            if (t.dtype is not dtype or not t.is_cuda or t.get_device() != index
                    or t.shape != shape):
                raise ValueError(
                    f"{label}: {name}[{i}] must be {str(dtype)[6:]} of shape {tuple(shape)} "
                    f"on {first.device}; got {t.dtype} of {tuple(t.shape)} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{label}: {name}[{i}] must be contiguous")
    return index


def _shape(label: str, u) -> tuple:
    u = tuple(u)
    if len(u) != 5:
        raise ValueError(f"{label}: u must hold 5 fields")
    shape = tuple(u[0].shape)
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"{label}: u must be 3-D fields, got shape {shape}")
    if (shape[0] + 4) * (shape[1] + 4) * (shape[2] + 4) >= 2**31:
        raise ValueError(f"{label}: sizes must fit int32")
    return u, shape


def _launch(index: int, src, ghost_map: int, u, shape, from_conserved: bool, dt: float, *,
            cell_size, gamma: float, riemann_solver: str) -> tuple:
    out = u[0].new_empty((5,) + shape).unbind(0)
    _LAUNCH(index, *(f.data_ptr() for f in src), ghost_map, *(f.data_ptr() for f in u),
            *(f.data_ptr() for f in out), *shape, int(from_conserved),
            _SOLVERS[riemann_solver], EXACT_NEWTON_ITERATIONS,
            *_constants(float(gamma), float(dt), tuple(float(c) for c in cell_size)))
    LAUNCHES[NAME] += 1
    return out


def hydro_step_conserved_cuda(u, ghost_map: torch.Tensor, dt: float, *, cell_size,
                              gamma: float, riemann_solver: str = "HLLC"):
    """K3 (U): one MUSCL-Hancock step from the conserved state alone.

    ``u``: 5 conserved fields [nx, ny, nz]; ``ghost_map``: int32 [(nx + 4) +
    (ny + 4) + (nz + 4)], the three axes' ``ops/hydro.py:ghost_map``; all on
    one CUDA device, contiguous.  Returns the 5 updated conserved fields (the
    rows of one new [5, nx, ny, nz] tensor), with the density floor applied.
    """
    label = "hydro_step_conserved_cuda"
    u, shape = _shape(label, u)
    index = _check(label, (("u", u, shape, torch.float32),
                           ("ghost_map", (ghost_map,), (sum(shape) + 12,), torch.int32)),
                   riemann_solver)
    return _launch(index, u, ghost_map.data_ptr(), u, shape, True, dt, cell_size=cell_size,
                   gamma=gamma, riemann_solver=riemann_solver)


def hydro_step_cuda(u, wp, dt: float, *, cell_size, gamma: float,
                    riemann_solver: str = "HLLC"):
    """K3 (P): one MUSCL-Hancock step from padded primitives.

    ``u``: 5 conserved fields [nx, ny, nz]; ``wp``: 5 primitives padded with
    2 ghosts per side [nx+4, ny+4, nz+4]; all f32, contiguous, on one CUDA
    device.  Returns the 5 updated conserved fields (the rows of one new [5,
    nx, ny, nz] tensor), with the density floor applied.
    """
    label = "hydro_step_cuda"
    u, shape = _shape(label, u)
    wp = tuple(wp)
    if len(wp) != 5:
        raise ValueError(f"{label}: u and wp must hold 5 fields each")
    padded = torch.Size(s + 4 for s in shape)
    index = _check(label, (("u", u, shape, torch.float32), ("wp", wp, padded, torch.float32)),
                   riemann_solver)
    return _launch(index, wp, 0, u, shape, False, dt, cell_size=cell_size, gamma=gamma,
                   riemann_solver=riemann_solver)
