"""Wrapper of K4, the CUDA per-cell thermal balance (``csrc/temperature.cu``).

The wrapper packs the atomic tables and the scalars of a solve into one f64
buffer on the host (:func:`kernel_tables`, whose layout matches the offsets
in the source), checks what the kernel takes (one CUDA device, f64, lengths),
allocates the outputs with ``torch.empty``, launches on PyTorch's current
stream and raises if the launch was refused.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from cmacionize_torch import constants
from cmacionize_torch.data import linecooling_tables
from cmacionize_torch.kernels import LAUNCHES
from cmacionize_torch.kernels.build import load_library
from cmacionize_torch.models.ions import ION_NAMES, METAL_NAMES
from cmacionize_torch.ops import charge_transfer, line_cooling, recombination

NAME = "temperature"
# log(1.1 / 0.9): the log-secant's bracket width
LOG_BRACKET = math.log(1.1 / 0.9)

_HEADER = 16
_REC_STRIDE = 20
_CT_STRIDE = 8
_ELEMENTS = ("He", "C", "N", "O", "Ne", "S")


def _recombination_rows() -> np.ndarray:
    """[14, 20]: radiative kind (0 rnew, 1 rrec) and coefficients, then the
    dielectronic kind (0 none, 1 NS83, 2/3/4 the S_p1/S_p2/S_p3 sums) and
    its coefficients."""
    rows = np.zeros((len(ION_NAMES), _REC_STRIDE))
    for i, name in enumerate(ION_NAMES):
        kind, coeffs = recombination.RADIATIVE[name]
        rows[i, 0] = 0.0 if kind == "rnew" else 1.0
        rows[i, 1:1 + len(coeffs)] = coeffs
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
        rows[i, 5] = diel[0]
        rows[i, 6:6 + len(diel[1])] = diel[1]
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


def kernel_tables(abundances, *, pahfac, crfac, epsilon, minimum_ionized_temperature):
    """The packed f64 buffer of ``csrc/temperature.cu`` for one solve."""
    header = np.zeros(_HEADER)
    header[:6] = [abundances.get(e, 0.0) for e in _ELEMENTS]
    header[6:14] = (
        pahfac, crfac, epsilon, minimum_ionized_temperature, LOG_BRACKET,
        line_cooling.COLLISION_PREFACTOR, constants.BOLTZMANN, recombination.K_PER_EV,
    )
    five_A, five_E, five_invw, five_gamma, two_A, two_E, two_invw, two_gamma = (
        linecooling_tables()
    )
    parts = [
        header, _recombination_rows(), _charge_transfer_rows(),
        five_A, five_E, five_invw, _fit_coefficients(five_gamma),
        two_A, two_E, two_invw, _fit_coefficients(two_gamma),
    ]
    return np.concatenate([np.asarray(p, np.float64).ravel() for p in parts])


def _launcher():
    fn = load_library(NAME).cmi_temperature
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def solve_temperature_cuda(T_init, j, h, nd, abundances, *, pahfac, crfac, epsilon,
                           max_iterations, minimum_ionized_temperature):
    """K4: the log-secant thermal balance of every cell.

    ``T_init``, ``nd`` and each of ``j`` (dict ion name → rate) and ``h``
    ((hH, hHe)) are f64 tensors of one shape on one CUDA device.  Returns
    (T, h0, he0, metals dict, sweeps int32), each of that shape.
    """
    device = T_init.device
    if device.type != "cuda":
        raise ValueError(f"solve_temperature_cuda needs CUDA tensors, got {device}")
    shape = T_init.shape
    n = T_init.numel()
    inputs = {"T_init": T_init, "nd": nd, "hH": h[0], "hHe": h[1]}
    inputs.update({f"j[{name}]": j[name] for name in ION_NAMES})
    for name, t in inputs.items():
        if t.device != device or t.dtype != torch.float64 or t.shape != shape:
            raise ValueError(
                f"solve_temperature_cuda: {name} must be float64 of shape "
                f"{tuple(shape)} on {device}; got {t.dtype} of {tuple(t.shape)} on {t.device}"
            )
    if len(METAL_NAMES) * n >= 2**31 or max_iterations < 0:
        raise ValueError("solve_temperature_cuda: sizes must fit int32")

    j_stack = torch.stack([j[name].reshape(-1) for name in ION_NAMES])
    h_stack = torch.stack([h[0].reshape(-1), h[1].reshape(-1)])
    T0 = T_init.reshape(-1).contiguous()
    nd_flat = nd.reshape(-1).contiguous()
    host_tables = kernel_tables(
        abundances, pahfac=pahfac, crfac=crfac, epsilon=epsilon,
        minimum_ionized_temperature=minimum_ionized_temperature,
    )
    tables = torch.tensor(host_tables, dtype=torch.float64, device=device)
    T, h0, he0 = (torch.empty(n, dtype=torch.float64, device=device) for _ in range(3))
    metals = torch.empty((len(METAL_NAMES), n), dtype=torch.float64, device=device)
    sweeps = torch.empty(n, dtype=torch.int32, device=device)

    launch = _launcher()
    stream = torch.cuda.current_stream(device).cuda_stream
    pointers = [t.data_ptr() for t in (
        tables, T0, j_stack, h_stack, nd_flat, T, h0, he0, metals, sweeps)]
    with torch.cuda.device(device):
        err = launch(*pointers, n, int(max_iterations), host_tables.size, stream)
    if err != 0:
        raise RuntimeError(f"solve_temperature_cuda: CUDA error {err} at launch")
    LAUNCHES[NAME] += 1
    return (
        T.reshape(shape), h0.reshape(shape), he0.reshape(shape),
        {name: metals[k].reshape(shape) for k, name in enumerate(METAL_NAMES)},
        sweeps.reshape(shape),
    )
