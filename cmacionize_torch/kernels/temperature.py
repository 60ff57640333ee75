"""Wrappers of K4 and K4f, the CUDA per-cell thermal balance in f64 and in
scaled f32 (``csrc/temperature.cu``, one body templated on the precision).

Each wrapper checks what the kernel takes (one CUDA device, the dtype,
lengths), allocates the outputs and the kernel's work counter with
``torch.empty``, and launches on PyTorch's current stream through
:mod:`cmacionize_torch.kernels.launch`, which raises if the launch was
refused.  The atomic tables and the scalars of a solve are packed into one
buffer of the working precision (:func:`kernel_tables`, whose layout matches
the offsets in the source) and kept on the device per configuration
(:func:`device_tables`), as is K4f's f32 log-Ω table of
``ops/line_cooling.py`` (:func:`device_omega_table`).  The kernel's grid is
persistent: the blocks the card holds at once, from the occupancy query
(:func:`grid_blocks`), with one lane a cell, or three where the cells do not
fill the card's lanes (:func:`lanes_per_cell`).  :func:`ptxas_report` reads the build's register and
stack report and :func:`lanes_busy` the share of lanes a one-thread-a-cell
launch keeps busy, both for the measurements of ``chip_smoke.py``.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from cmacionize_torch import constants
from cmacionize_torch.data import linecooling_tables
from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import library_path
from cmacionize_torch.kernels.launch import Launcher, kernel_occupancy
from cmacionize_torch.models.ions import ION_NAMES, METAL_NAMES
from cmacionize_torch.ops import charge_transfer, line_cooling, recombination

NAME = "temperature"
#: threads a block of K4 / K4f (``kThreads`` in the source)
THREADS = 64
# K4f is built into K4's library and counts its launches under this name
NAME_F32 = "temperature_f32"
# log(1.1 / 0.9): the log-secant's bracket width
LOG_BRACKET = math.log(1.1 / 0.9)
# He Lyman-alpha on-the-spot heating energy: 21.2 eV - 13.6 eV (J)
HE_LYA_HEATING_ENERGY = 1.21765423e-18
#: coefficient prefactor of the f32 solve: it lifts the 1e-40-class cooling
#: coefficients into normal f32 range; gain and loss carry the same factor,
#: and the secant uses them only in ratios and a relative convergence test
DEVICE_SOLVE_SCALE = 1.0e26

_HEADER = 32
_REC_STRIDE = 20
_CT_STRIDE = 8
_ELEMENTS = ("He", "C", "N", "O", "Ne", "S")


def _recombination_rows() -> np.ndarray:
    """[14, 20]: radiative kind (0 rnew, 1 rrec) and coefficients (rnew: A,
    1 - B, 1 + B, T0, T1; rrec: a, -b, the exponents formed in f64 as the
    plain version's Python numbers are), then the dielectronic kind (0 none,
    1 NS83, 2/3/4 the S_p1/S_p2/S_p3 sums) and its coefficients."""
    rows = np.zeros((len(ION_NAMES), _REC_STRIDE))
    for i, name in enumerate(ION_NAMES):
        kind, coeffs = recombination.RADIATIVE[name]
        rows[i, 0] = 0.0 if kind == "rnew" else 1.0
        if kind == "rnew":
            A, B, T0, T1 = coeffs
            rows[i, 1:6] = (A, 1.0 - B, 1.0 + B, T0, T1)
        else:
            a, b = coeffs
            rows[i, 1:3] = (a, -b)
        if name in recombination.DIELECTRONIC_NS83:
            diel = (1, recombination.DIELECTRONIC_NS83[name])
        elif name == "S_p1":
            diel = (2, (1.37e-9, -14.95))
        elif name == "S_p2":
            diel = (3, sum(recombination.S_P2_TERMS, ()))
        elif name == "S_p3":
            diel = (4, sum(recombination.S_P3_TERMS, ()))
        else:
            diel = (0, ())
        rows[i, 6] = diel[0]
        rows[i, 7:7 + len(diel[1])] = diel[1]
    return rows


def _charge_transfer_rows() -> np.ndarray:
    """[3, 14, 8]: (present, a, b, c, d, e, t_lo, t_hi) per table and ion,
    tables in the order recombination with H⁰, ionization by H⁺,
    recombination with He⁰."""
    rows = np.zeros((3, len(ION_NAMES), _CT_STRIDE))
    tables = (
        charge_transfer.RECOMBINATION_H, charge_transfer.IONIZATION_H,
        charge_transfer.RECOMBINATION_HE,
    )
    for t, table in enumerate(tables):
        for i, name in enumerate(ION_NAMES):
            if name in table:
                rows[t, i] = (1.0, *table[name])
    return rows


def _fit_coefficients(gamma) -> np.ndarray:
    """The Ω(T) coefficients with 1+g0 and g5-1 formed as the plain version
    forms them (f64)."""
    g = np.array(gamma, np.float64)
    g[..., 0] = 1.0 + g[..., 0]
    g[..., 5] = g[..., 5] - 1.0
    return g


def kernel_tables(abundances, *, pahfac, crfac, epsilon, minimum_ionized_temperature,
                  scale=1.0):
    """The packed f64 buffer of ``csrc/temperature.cu`` for one solve, with
    the balance coefficients times ``scale``; K4f takes it rounded to f32.
    Products of Python numbers are formed here in f64, as the plain version
    forms them before they meet a tensor."""
    AHe = abundances.get("He", 0.0)
    header = np.zeros(_HEADER)
    header[:6] = [abundances.get(e, 0.0) for e in _ELEMENTS]
    header[6:14] = (
        pahfac, crfac, epsilon, minimum_ionized_temperature, LOG_BRACKET,
        line_cooling.COLLISION_PREFACTOR, constants.BOLTZMANN * scale, recombination.K_PER_EV,
    )
    header[14:20] = (
        scale, HE_LYA_HEATING_ENERGY * scale, 1.5e-37 * scale, 1.42e-40 * scale,
        2.85e-40 * scale, 1.55e-39 * scale,
    )
    header[20:26] = (
        1.0 + 2.0 * AHe, 1.0 + AHe, 2.0 + AHe, 4.0 * AHe, 2.0 * AHe, crfac * (1.2e-25 * scale),
    )
    header[26:28] = line_cooling.omega_grid_constants()
    five_A, five_E, five_invw, five_gamma, two_A, two_E, two_invw, two_gamma = (
        linecooling_tables()
    )
    parts = [
        header, _recombination_rows(), _charge_transfer_rows(),
        five_A, five_E, five_invw, _fit_coefficients(five_gamma),
        two_A, two_E, two_invw, _fit_coefficients(two_gamma),
    ]
    return np.concatenate([np.asarray(p, np.float64).ravel() for p in parts])


def omega_table() -> np.ndarray:
    """[512, 103] f32: per log-T node, the ten five-level coolants' 10
    transitions then the three two-level coolants (K4f's layout of
    ``line_cooling.omega_tables``)."""
    _, five, two = line_cooling.omega_tables()
    return np.ascontiguousarray(
        np.concatenate([five.reshape(five.shape[0], -1), two], axis=1), np.float32)


def _key(abundances) -> tuple:
    return tuple(sorted((str(k), float(v)) for k, v in abundances.items()))


# the packed tables and K4f's log-Ω table on each device, by configuration
_TABLES: dict = {}
_OMEGA: dict = {}
# K4's / K4f's persistent grid (blocks resident on the card) per device
_GRID: dict = {}


def device_tables(dtype, device, abundances, *, pahfac, crfac, epsilon,
                  minimum_ionized_temperature, scale) -> torch.Tensor:
    """:func:`kernel_tables` in ``dtype`` on ``device``, packed and copied
    once per configuration and kept (the kernels only read it)."""
    key = (dtype, str(device), _key(abundances), float(pahfac), float(crfac), float(epsilon),
           float(minimum_ionized_temperature), float(scale))
    tables = _TABLES.get(key)
    if tables is None:
        host = kernel_tables(abundances, pahfac=pahfac, crfac=crfac, epsilon=epsilon,
                             minimum_ionized_temperature=minimum_ionized_temperature,
                             scale=scale)
        tables = _TABLES[key] = torch.tensor(host, dtype=dtype, device=device)
    return tables


def device_omega_table(device) -> torch.Tensor:
    """:func:`omega_table` on ``device``, copied once and kept."""
    table = _OMEGA.get(str(device))
    if table is None:
        table = _OMEGA[str(device)] = torch.tensor(omega_table(), device=device)
    return table


# pointers: tables, (K4f: the log-Ω table,) T_init, j, h, nd, T, h0, he0,
# metals, sweeps and the work counter; then n, max_iterations, the table
# size, the lanes a cell and the persistent grid
_TEMPERATURE = Launcher(NAME, "cmi_temperature", 11, 5)
_TEMPERATURE_F32 = Launcher(NAME, "cmi_temperature_f32", 12, 5)
_OCCUPANCY = {
    (torch.float64, 1): "cmi_temperature_occupancy",
    (torch.float32, 1): "cmi_temperature_f32_occupancy",
    (torch.float64, 3): "cmi_temperature3_occupancy",
    (torch.float32, 3): "cmi_temperature3_f32_occupancy",
}


def occupancy(device, dtype=torch.float64, lanes: int = 1) -> dict:
    """Registers per thread and blocks resident per SM of K4 (f64) or K4f
    (f32) with ``lanes`` (1 or 3) lanes a cell, and the SM count of CUDA
    ``device``."""
    return kernel_occupancy(NAME, _OCCUPANCY[dtype, lanes], device)


def grid_blocks(device, dtype, lanes: int = 1) -> int:
    """The persistent grid of K4 / K4f on ``device`` with ``lanes`` lanes a
    cell: every block the card holds at once (the kernel launches fewer
    where n needs fewer)."""
    key = (str(device), dtype, lanes)
    blocks = _GRID.get(key)
    if blocks is None:
        found = occupancy(device, dtype, lanes)
        blocks = _GRID[key] = found["blocks_per_sm"] * found["sms"]
    return blocks


def lanes_per_cell(n: int, device, dtype) -> int:
    """3 where the n cells do not fill the card's resident lanes one a lane
    (a small solve is as long as its slowest cell's chain of sweeps, which
    three lanes, one an evaluation, cut), else 1 (a large solve is as long
    as its sweeps over the card's lanes)."""
    return 3 if n <= grid_blocks(device, dtype, 1) * THREADS else 1


_PTXAS_FUNCTION = re.compile(r"Function properties for (\S+)")
_PTXAS_FRAME = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")


# the kernel's instantiations by their mangled names' template arguments
_INSTANTIATIONS = {"IdLi1E": "K4", "IfLi1E": "K4f", "IdLi3E": "K4 (3 lanes)",
                   "IfLi3E": "K4f (3 lanes)"}


def ptxas_report(log_text: str | None = None) -> dict:
    """Registers, stack bytes and spill bytes of K4 and K4f, each with one
    and with three lanes a cell, from ``ptxas -v``'s report in the build log
    of ``csrc/temperature.cu`` (or ``log_text``): {"K4": {...}, "K4f":
    {...}, "K4 (3 lanes)": {...}, "K4f (3 lanes)": {...}}."""
    if log_text is None:
        log_text = library_path(NAME).with_suffix(".log").read_text()
    found, current = {}, None
    for line in log_text.splitlines():
        if (m := _PTXAS_FUNCTION.search(line)) is not None:
            name = m.group(1)
            current = next((label for key, label in _INSTANTIATIONS.items()
                            if f"temperature_kernel{key}" in name), None)
        elif current is not None and (m := _PTXAS_FRAME.search(line)) is not None:
            found.setdefault(current, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        elif current is not None and (m := _PTXAS_USED.search(line)) is not None:
            found.setdefault(current, {})["registers"] = int(m.group(1))
            current = None
    return found


def lanes_busy(sweeps: torch.Tensor, warp: int = 32) -> float:
    """The share of lanes busy when one thread runs each cell in cell order:
    Σ sweeps / Σ over warps of ``warp`` consecutive cells of ``warp`` × the
    warp's most sweeps (the last warp padded with idle lanes)."""
    s = sweeps.reshape(-1).to(torch.int64)
    if s.numel() == 0:
        return 1.0
    pad = (-s.numel()) % warp
    if pad:
        s = torch.cat([s, s.new_zeros(pad)])
    held = int(s.reshape(-1, warp).amax(1).sum()) * warp
    return int(s.sum()) / held if held else 1.0


def _solve(label, dtype, T_init, j, h, nd, abundances, *, pahfac, crfac, epsilon,
           max_iterations, minimum_ionized_temperature, scale):
    """Check, allocate and launch K4 (f64) or K4f (f32)."""
    device = T_init.device
    if device.type != "cuda":
        raise ValueError(f"{label} needs CUDA tensors, got {device}")
    shape = T_init.shape
    n = T_init.numel()
    inputs = {"T_init": T_init, "nd": nd, "hH": h[0], "hHe": h[1]}
    inputs.update({f"j[{name}]": j[name] for name in ION_NAMES})
    type_name = str(dtype).removeprefix("torch.")
    for name, t in inputs.items():
        if t.device != device or t.dtype != dtype or t.shape != shape:
            raise ValueError(
                f"{label}: {name} must be {type_name} of shape "
                f"{tuple(shape)} on {device}; got {t.dtype} of {tuple(t.shape)} on {t.device}"
            )
    if len(METAL_NAMES) * n >= 2**31 or max_iterations < 0:
        raise ValueError(f"{label}: sizes must fit int32")

    T, h0, he0 = (torch.empty(n, dtype=dtype, device=device) for _ in range(3))
    metals = torch.empty((len(METAL_NAMES), n), dtype=dtype, device=device)
    sweeps = torch.empty(n, dtype=torch.int32, device=device)
    if n > 0:  # no cell: no launch
        tables = device_tables(
            dtype, device, abundances, pahfac=pahfac, crfac=crfac, epsilon=epsilon,
            minimum_ionized_temperature=minimum_ionized_temperature, scale=scale)
        buffers = [tables]
        if dtype == torch.float32:
            buffers.append(device_omega_table(device))
        buffers += [
            T_init.reshape(-1).contiguous(),
            torch.stack([j[name].reshape(-1) for name in ION_NAMES]),
            torch.stack([h[0].reshape(-1), h[1].reshape(-1)]), nd.reshape(-1).contiguous(),
            T, h0, he0, metals, sweeps, torch.empty(1, dtype=torch.int32, device=device),
        ]
        lanes = lanes_per_cell(n, device, dtype)
        launch = _TEMPERATURE_F32 if dtype == torch.float32 else _TEMPERATURE
        launch(device.index, *(t.data_ptr() for t in buffers), n, int(max_iterations),
               tables.numel(), lanes, grid_blocks(device, dtype, lanes))
        LAUNCHES[NAME_F32 if dtype == torch.float32 else NAME] += 1
    return (
        T.reshape(shape), h0.reshape(shape), he0.reshape(shape),
        {name: metals[k].reshape(shape) for k, name in enumerate(METAL_NAMES)},
        sweeps.reshape(shape),
    )


def solve_temperature_cuda(T_init, j, h, nd, abundances, *, pahfac, crfac, epsilon,
                           max_iterations, minimum_ionized_temperature):
    """K4: the f64 log-secant thermal balance of every cell.

    ``T_init``, ``nd`` and each of ``j`` (dict ion name → rate) and ``h``
    ((hH, hHe)) are f64 tensors of one shape on one CUDA device.  Returns
    (T, h0, he0, metals dict, sweeps int32), each of that shape.
    """
    return _solve(
        "solve_temperature_cuda", torch.float64, T_init, j, h, nd, abundances, pahfac=pahfac,
        crfac=crfac, epsilon=epsilon, max_iterations=max_iterations,
        minimum_ionized_temperature=minimum_ionized_temperature, scale=1.0,
    )


def solve_temperature_device_cuda(T_init, j, h, nd, abundances, *, pahfac, crfac, epsilon,
                                  max_iterations, minimum_ionized_temperature):
    """K4f: the f32 log-secant thermal balance of every cell, every gain and
    loss coefficient times ``DEVICE_SOLVE_SCALE`` (``ops/temperature.py``).

    The same inputs as :func:`solve_temperature_cuda`, in f32; returns f32
    (T, h0, he0, metals dict) and the int32 sweeps.
    """
    return _solve(
        "solve_temperature_device_cuda", torch.float32, T_init, j, h, nd, abundances,
        pahfac=pahfac, crfac=crfac, epsilon=epsilon, max_iterations=max_iterations,
        minimum_ionized_temperature=minimum_ionized_temperature, scale=DEVICE_SOLVE_SCALE,
    )
