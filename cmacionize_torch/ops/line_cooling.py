"""Collisionally excited line cooling (10 five-level + 3 two-level ions).

Port of ``cmacionize_tpu/ops/line_cooling.py`` (the reference's
src/LineCoolingData.cpp): the level populations of each coolant ion follow
from the statistical-equilibrium balance of collisional (de-)excitation and
radiative decay; the radiated power per H atom is Σ n_i A_ij E_ij.  The level
matrices of all cells and all ten five-level ions form one [..., 10, 5, 5]
tensor, solved by an unrolled Gauss-Jordan elimination in the JAX package's
order (:func:`solve5x5`).

The functions compute in the dtype of T, as the JAX ones do with their
``dtype`` argument.  In f64 the collision strengths Ω(T) come from their
7-coefficient fit; in f32 (the device backend of the temperature solve, K4f)
from the JAX package's table of log Ω on a 512-point log-T grid, built once
in f64 numpy and interpolated linearly in log T (:func:`omega_tables`), since
the fit cancels catastrophically in f32.

Sums over transitions and coolants are written out left to right, so that
K4 and K4f (``csrc/temperature.cu``), which loop in the same order, add in
the same order.

Coolant index order (matching the reference enums):
    five-level: NI NII OI OII OIII NeIII SII SIII CII CIII   (0..9)
    two-level:  NIII NeII SIV                                (10..12)
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cmacionize_torch import constants
from cmacionize_torch.data import linecooling_tables
from cmacionize_torch.ops.recombination import div

N_FIVE = 10
N_TWO = 3
N_COOLANTS = N_FIVE + N_TWO

FIVE_NAMES = ("NI", "NII", "OI", "OII", "OIII", "NeIII", "SII", "SIII", "CII", "CIII")
TWO_NAMES = ("NIII", "NeII", "SIV")
COOLANT_NAMES = FIVE_NAMES + TWO_NAMES

# (lower, upper) level pairs of the 10 transitions
TRANSITION_PAIRS = (
    (0, 1), (0, 2), (0, 3), (0, 4), (1, 2),
    (1, 3), (1, 4), (2, 3), (2, 4), (3, 4),
)
UPPER_LEVEL = tuple(pair[1] for pair in TRANSITION_PAIRS)

# collision strength prefactor h^2 / (sqrt(k) (2 pi m_e)^{3/2}), K^0.5 m^3/s
COLLISION_PREFACTOR = constants.PLANCK**2 / (
    np.sqrt(constants.BOLTZMANN) * (2.0 * np.pi * constants.ELECTRON_MASS) ** 1.5
)

# never return exactly zero (the temperature iteration divides by it): a
# floor representable in the dtype (in the f32 solve's scaled units 1e-35 is
# 1e-61 W per H atom)
COOLING_FLOOR = {torch.float64: 1e-99, torch.float32: 1e-35}

# the f32 Ω table: log T from 100 K to 1e10 K (the secant's whole range)
OMEGA_GRID_POINTS = 512


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device, dtype: torch.dtype = torch.float64):
    return tuple(
        torch.tensor(np.asarray(t, np.float64), device=device).to(dtype)
        for t in linecooling_tables()
    )


@functools.lru_cache(maxsize=None)
def omega_tables():
    """(grid [512] f32 log T, five [512, 10, 10] f32 log Ω, two [512, 3] f32
    log Ω): the fit evaluated once in f64 numpy on the log-T grid, as the JAX
    package's ``_omega_tables`` does, and rounded to f32."""
    _, _, _, five_gamma, _, _, _, two_gamma = linecooling_tables()
    log_t = np.linspace(np.log(1.0e2), np.log(1.0e10), OMEGA_GRID_POINTS)
    T = np.exp(log_t)

    def fit(gamma):
        g = np.asarray(gamma, np.float64)
        g0, g1, g2, g3, g4, g5, g6 = (g[..., k] for k in range(7))
        Tb = T.reshape((-1,) + (1,) * g0.ndim)
        return Tb ** (1.0 + g0) * (
            g1 + g2 / Tb + g3 * np.log(Tb) + g4 * Tb * (1.0 + (g5 - 1.0) * Tb ** g6)
        )

    five = np.log(np.maximum(fit(five_gamma), 1e-30))
    two = np.log(np.maximum(fit(two_gamma), 1e-30))
    return np.float32(log_t), np.float32(five), np.float32(two)


def omega_grid_constants():
    """(g0, dg): the first log-T node and the node spacing, as the f32 values
    the interpolation uses (the spacing is the f32 difference of the first
    two nodes)."""
    grid = omega_tables()[0]
    return float(grid[0]), float(grid[1] - grid[0])


@functools.lru_cache(maxsize=None)
def _omega_device_tables(device: torch.device):
    _, five, two = omega_tables()
    return torch.tensor(five, device=device), torch.tensor(two, device=device)


def omega_interpolated(T, which: str):
    """Ω of the five-level ([..., 10, 10]) or two-level ([..., 3]) coolants at
    the f32 temperatures T, interpolated linearly in log T between the
    table's nodes (the JAX package's ``_omega_interp``)."""
    five, two = _omega_device_tables(T.device)
    table = five if which == "five" else two
    g0, dg = omega_grid_constants()
    x = div(torch.log(torch.clamp(T, 1.0e2, 1.0e10)) - g0, dg)
    k = torch.clamp(torch.floor(x).to(torch.int32), 0, OMEGA_GRID_POINTS - 2).long()
    frac = (x - k.to(T.dtype)).reshape(x.shape + (1,) * (table.ndim - 1))
    lo, hi = table[k], table[k + 1]
    return torch.exp(lo + frac * (hi - lo))


def _collision_strengths(gamma, T, Tinv, logT):
    """Ω(T) fit without its prefactor: gamma [..., 7] coefficients,
        T^(1+g0) · (g1 + g2/T + g3·lnT + g4·T·(1 + (g5-1)·T^g6))."""
    g0, g1, g2, g3, g4, g5, g6 = (gamma[..., k] for k in range(7))
    return T ** (1.0 + g0) * (
        g1 + g2 * Tinv + g3 * logT + g4 * T * (1.0 + (g5 - 1.0) * T**g6)
    )


def _sum_last(x):
    """Σ over the last axis, left to right."""
    total = x[..., 0]
    for k in range(1, x.shape[-1]):
        total = total + x[..., k]
    return total


def _omega(T, gamma, which):
    """Ω of every transition at T ([...] → [..., *gamma.shape[:-1]]): the
    fit in f64, the table in f32."""
    if T.dtype == torch.float32:
        return omega_interpolated(T, which)
    T = T.reshape(T.shape + (1,) * (gamma.ndim - 1))
    return _collision_strengths(gamma, T, div(1.0, T), torch.log(T))


def five_level_populations(T, ne):
    """Level populations [..., 10, 5] of the five-level coolants at T, ne
    (broadcastable f64 or f32 tensors, K and m^-3)."""
    A, E, invw, gamma = _tables(T.device, T.dtype)[:4]
    omega = _omega(T, gamma, "five")  # [..., 10, 10]
    T = T[..., None, None]  # [..., 1(ion), 1(transition)]
    ne = ne[..., None, None]
    Tinv = div(1.0, T)
    prefactor = COLLISION_PREFACTOR * ne / torch.sqrt(T)

    cs = prefactor * omega
    rate_up = cs * torch.exp(-E * Tinv)

    def down(t):
        return cs[..., t]

    def up(t):
        return rate_up[..., t]

    iw = [invw[:, level] for level in range(5)]
    T01, T02, T03, T04, T12, T13, T14, T23, T24, T34 = range(10)
    one = torch.ones_like(cs[..., 0])
    rows = [
        [one, one, one, one, one],  # closure: Σ n_i = 1
        [
            up(T01) * iw[0],
            -(A[:, T01] + iw[1] * (down(T01) + up(T12) + up(T13) + up(T14))),
            A[:, T12] + iw[2] * down(T12),
            A[:, T13] + iw[3] * down(T13),
            A[:, T14] + iw[4] * down(T14),
        ],
        [
            up(T02) * iw[0],
            up(T12) * iw[1],
            -(A[:, T02] + A[:, T12] + iw[2] * (down(T02) + down(T12) + up(T23) + up(T24))),
            A[:, T23] + iw[3] * down(T23),
            A[:, T24] + iw[4] * down(T24),
        ],
        [
            up(T03) * iw[0],
            up(T13) * iw[1],
            up(T23) * iw[2],
            -(A[:, T03] + A[:, T13] + A[:, T23]
              + iw[3] * (down(T03) + down(T13) + down(T23) + up(T34))),
            A[:, T34] + iw[4] * down(T34),
        ],
        [
            up(T04) * iw[0],
            up(T14) * iw[1],
            up(T24) * iw[2],
            up(T34) * iw[3],
            -(A[:, T04] + A[:, T14] + A[:, T24] + A[:, T34]
              + iw[4] * (down(T04) + down(T14) + down(T24) + down(T34))),
        ],
    ]
    zero = torch.zeros_like(one)
    return _gauss_jordan([
        list(torch.broadcast_tensors(*row, one if r == 0 else zero))
        for r, row in enumerate(rows)
    ])


def solve5x5(A, b):
    """Batched 5×5 solve A x = b ([..., 5, 5], [..., 5] → [..., 5])."""
    return _gauss_jordan([[A[..., r, k] for k in range(5)] + [b[..., r]] for r in range(5)])


def _gauss_jordan(rows):
    """Unrolled Gauss-Jordan elimination with partial pivoting on the five
    augmented rows (each a list of its six column tensors), in the JAX
    package's order: per column, the first row of largest |value| (NaN
    counting as largest, as argmax takes it) is swapped up, the pivot row is
    divided by the pivot, and every other row i loses f_i · pivot row.
    Columns left of the pivot column no longer reach the solution, so they
    are dropped as the elimination goes.  Returns the solution [..., 5]."""
    rows = [list(row) for row in rows]
    for j in range(5):
        # rows[r] holds columns j..5 from here on
        best = torch.abs(rows[j][0])
        p = torch.full_like(best, j, dtype=torch.int64)
        for r in range(j + 1, 5):
            c = torch.abs(rows[r][0])
            take = ~torch.isnan(best) & (torch.isnan(c) | (c > best))
            best = torch.where(take, c, best)
            p = torch.where(take, r, p)
        swap = [p == r for r in range(j + 1, 5)]
        pivot_row = rows[j]
        for r, m in zip(range(j + 1, 5), swap):
            pivot_row = [torch.where(m, a, b) for a, b in zip(rows[r], pivot_row)]
        for r, m in zip(range(j + 1, 5), swap):
            rows[r] = [torch.where(m, a, b) for a, b in zip(rows[j], rows[r])]
        row_j = [value / pivot_row[0] for value in pivot_row]
        for r in range(5):
            if r != j:
                f = rows[r][0]
                rows[r] = [a - f * b for a, b in zip(rows[r][1:], row_j[1:])]
        rows[j] = row_j[1:]
    return torch.stack([row[0] for row in rows], -1)


def two_level_populations(T, ne):
    """Upper-level population [..., 3] of the two-level coolants."""
    A, E, invw, gamma = _tables(T.device, T.dtype)[4:]
    omega = _omega(T, gamma, "two")  # [..., 3]
    T = T[..., None]
    ne = ne[..., None]
    Tinv = div(1.0, T)
    prefactor = COLLISION_PREFACTOR * ne / torch.sqrt(T)
    cs = prefactor * omega
    Texp = torch.exp(-E * Tinv)
    return cs * Texp * invw[:, 0] / (A + cs * (invw[:, 1] + Texp * invw[:, 0]))


def cooling_rate(T, ne, abundances, scale: float = 1.0):
    """Radiated power per H atom (W) × ``scale``, cf.
    LineCoolingData::get_cooling, in the dtype of T.

    abundances: [..., 13] coolant abundances (number relative to H), in
    COOLANT_NAMES order.  ``scale`` is folded into the Boltzmann prefactor in
    Python f64 and rounded once to the dtype, as the JAX function folds it,
    so that the f32 solve keeps the result in normal f32 range."""
    five_A, five_E, _, _, two_A, two_E, _, _ = _tables(T.device, T.dtype)
    pops = five_level_populations(T, ne)  # [..., 10, 5]
    n_upper = pops[..., list(UPPER_LEVEL)]  # [..., 10, 10]
    five_cool = _sum_last(n_upper * five_A * five_E)  # [..., 10]
    two_cool = two_level_populations(T, ne) * two_A * two_E  # [..., 3]
    per_ion = torch.cat([five_cool, two_cool], dim=-1)  # [..., 13]
    total = (constants.BOLTZMANN * scale) * _sum_last(abundances * per_ion)
    return torch.clamp_min(total, COOLING_FLOOR[T.dtype])
