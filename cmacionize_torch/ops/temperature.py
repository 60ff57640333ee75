"""Thermal equilibrium: the coupled ionization + heating/cooling solve.

Port of ``cmacionize_tpu/ops/temperature.py`` (the reference's
src/TemperatureCalculator.cpp): per cell, find T such that photo-heating
balances radiative cooling, with the H/He/metal ionization state recomputed
at each trial temperature, by the reference's log-secant iteration with
evaluations at 1.1T, 0.9T and T.

Two backends, as in the JAX package:

- :func:`solve_temperature`, f64: CPU tensors run the plain PyTorch version
  (:func:`solve_temperature_reference`), CUDA tensors launch K4
  (``csrc/temperature.cu``, one thread per cell);
- :func:`solve_temperature_device`, f32 with every gain and loss coefficient
  multiplied by :data:`DEVICE_SOLVE_SCALE` (``TemperatureCalculator: backend:
  f32-device``): CPU tensors run :func:`solve_temperature_device_reference`,
  CUDA tensors launch K4f, the f32 form of the same kernel.

The plain version is the JAX package's lockstep loop: a cell freezes once it
has converged and keeps its values.  It evaluates the balance only on the
cells still live in a sweep (the per-cell results are those of the masked
full-width loop, since each cell's arithmetic is its own), and it counts the
sweeps each cell ran.  The same code serves both dtypes: Python numbers meet
tensors as JAX's weakly typed scalars do (rounded once to the tensor's dtype),
and products of Python numbers, such as ``1.42e-40 * scale``, are formed in
Python f64 first, as in the JAX expressions.

The JAX package's ``solve_temperature_device_chunked`` is not ported: its
fixed 32768-cell chunks work around the TPU compile's constant budget, and
its per-cell results equal the unchunked call (tested on the CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cmacionize_torch.kernels.temperature import (
    DEVICE_SOLVE_SCALE,
    HE_LYA_HEATING_ENERGY,
    LOG_BRACKET,
    solve_temperature_cuda,
    solve_temperature_device_cuda,
)
from cmacionize_torch.models.ions import METAL_NAMES
from cmacionize_torch.ops import ionization, line_cooling, recombination
from cmacionize_torch.ops.ionization import tiny
from cmacionize_torch.ops.recombination import div


class BalanceResult(NamedTuple):
    h0: torch.Tensor
    he0: torch.Tensor
    gain: torch.Tensor
    loss: torch.Tensor
    metals: dict  # name -> fraction field


class TemperatureSolution(NamedTuple):
    T: torch.Tensor
    h0: torch.Tensor
    he0: torch.Tensor
    metals: dict  # name -> fraction field
    sweeps: torch.Tensor  # int32: secant sweeps each cell ran


def coolant_abundances(metals, abundances):
    """[..., 13] coolant abundances from the metal-stage fractions (the
    reference's stage-storage convention, see
    ``ionization.metal_ion_fractions``), in line_cooling.COOLANT_NAMES order."""
    A = abundances
    m = metals
    return torch.stack([
        A["N"] * (1.0 - m["N_n"] - m["N_p1"] - m["N_p2"]),  # NI
        A["N"] * m["N_n"],  # NII
        A["O"] * (1.0 - m["O_n"] - m["O_p1"]),  # OI
        A["O"] * m["O_n"],  # OII
        A["O"] * m["O_p1"],  # OIII
        A["Ne"] * m["Ne_p1"],  # NeIII
        A["S"] * (1.0 - m["S_p1"] - m["S_p2"] - m["S_p3"]),  # SII
        A["S"] * m["S_p1"],  # SIII
        A["C"] * (1.0 - m["C_p1"] - m["C_p2"]),  # CII
        A["C"] * m["C_p1"],  # CIII
        A["N"] * m["N_p1"],  # NIII
        A["Ne"] * m["Ne_n"],  # NeII
        A["S"] * m["S_p2"],  # SIV
    ], dim=-1)


def cooling_heating_balance(T, j, h, nd, abundances, pahfac=0.0, crfac=0.0, scale=1.0):
    """One balance evaluation at the temperature field T (f64 or f32 tensors).

    j: dict ion name → photoionization rate (s⁻¹, jfac-normalized);
    h: (hH, hHe) heating integrals (hfac-normalized); nd: hydrogen number
    density (m⁻³); abundances: dict element → abundance.  ``scale`` multiplies
    every gain and loss coefficient before it meets a tensor (1.0 leaves the
    f64 arithmetic as it is; the f32 solve passes DEVICE_SOLVE_SCALE).
    """
    guard = tiny(T)
    AHe = abundances.get("He", 0.0)
    alphaH = recombination.recombination_rate("H_n", T)
    alphaHe = recombination.recombination_rate("He_n", T)

    h0, he0 = ionization.hydrogen_helium_neutral_fractions(
        j["H_n"], j["He_n"], nd, AHe, T, alphaH, alphaHe
    )
    ne = nd * (1.0 - h0 + AHe * (1.0 - he0))
    nhp = nd * (1.0 - h0)
    nhep = nd * AHe * (1.0 - he0)
    nenhp = ne * nhp
    nenhep = ne * nhep
    sqrtT = torch.sqrt(T)
    logT = torch.log(T)
    T4 = T * 1e-4

    # heating
    hH, hHe = h
    gain = nd * ((hH * scale) * h0 + (hHe * scale) * AHe * he0)
    alpha_e_2sP = 4.17e-20 * T4 ** (-0.861)
    pHots = div(1.0, 1.0 + 77.0 * he0 / (sqrtT * torch.clamp_min(h0, guard)))
    gain = gain + pHots * (HE_LYA_HEATING_ENERGY * scale) * alpha_e_2sP * nenhep
    gain = gain + (1.5e-37 * scale) * nd * ne * pahfac
    if crfac > 0.0:
        gain = gain + div(crfac * (1.2e-25 * scale), torch.sqrt(torch.clamp_min(ne, guard)))

    # metal ionization (for the coolant abundances)
    alphas = {name: recombination.recombination_rate(name, T) for name in METAL_NAMES}
    metals = ionization.metal_ion_fractions(
        {name: j[name] for name in METAL_NAMES}, ne, T, nd * h0, nd * he0 * AHe, nhp,
        alphas,
    )

    # cooling
    abund = coolant_abundances(metals, abundances)
    loss = line_cooling.cooling_rate(T, ne, abund, scale=scale) * nd
    cgaunt = 5.5 - logT
    gff = 1.1 + 0.34 * torch.exp(div(-cgaunt * cgaunt, 3.0))
    loss = loss + (1.42e-40 * scale) * gff * sqrtT * (nenhp + nenhep)
    loss = loss + (2.85e-40 * scale) * nenhp * sqrtT * (
        5.914 - 0.5 * logT + 0.01184 * T ** (1.0 / 3.0)
    )
    loss = loss + (1.55e-39 * scale) * nenhep * T**0.3647

    return BalanceResult(
        h0=h0, he0=he0, gain=torch.clamp_min(gain, 0.0),
        loss=torch.clamp_min(loss, 0.0), metals=metals,
    )


def _log_ratio(a, b):
    """log(a/b) with the reference's handling of zeros."""
    pos = torch.where(a > 0.0, torch.log(torch.clamp_min(a, tiny(a)) / b), -99.0)
    zero = torch.where(a > 0.0, 99.0, 0.0).to(a.dtype)
    return torch.where(b > 0.0, pos.to(a.dtype), zero)


def _secant_sweep(T0, j, h, nd, abundances, pahfac, crfac, minimum_ionized_temperature,
                  scale):
    """One log-secant sweep for live cells: (T, gain, loss, h0, he0, metals)."""
    guard = tiny(T0)

    def balance(T):
        return cooling_heating_balance(T, j, h, nd, abundances, pahfac, crfac, scale)

    bal1 = balance(1.1 * T0)
    bal2 = balance(0.9 * T0)
    bal0 = balance(T0)
    expdiff = _log_ratio(bal1.gain, bal2.gain) - _log_ratio(bal1.loss, bal2.loss)
    good = (bal0.gain > 0.0) & (expdiff != 0.0)
    ratio = bal0.loss / torch.clamp_min(bal0.gain, guard)
    exponent = torch.clamp(div(LOG_BRACKET, torch.where(good, expdiff, 1.0)), -50, 50)
    T_new = torch.where(
        good, T0 * torch.exp(exponent * torch.log(torch.clamp_min(ratio, guard))), 1.1 * T0
    )

    # bounds: the neutral floor and the ionized cap force convergence
    went_cold = T_new < minimum_ionized_temperature
    went_hot = T_new > 1e10
    T_new = torch.where(went_cold, 500.0, torch.where(went_hot, 1e10, T_new))
    h0 = torch.where(went_cold, 1.0, torch.where(went_hot, 1e-10, bal0.h0))
    he0 = torch.where(went_cold, 1.0, torch.where(went_hot, 1e-10, bal0.he0))
    forced = went_cold | went_hot
    gain = torch.where(forced, 1.0, bal0.gain)
    loss = torch.where(forced, 1.0, bal0.loss)
    return T_new, gain, loss, h0, he0, bal0.metals


def _temperature_fixups(T0, h0, he0, metals, j):
    """Post-conditions: the 30 kK cap (He charge-transfer validity), the
    neutral / ionized overrides and the metal clean-up."""
    T0 = torch.clamp_max(T0, 30000.0)
    no_jH = j["H_n"] <= 0.0
    h0 = torch.where(no_jH, 1.0, h0)
    he0 = torch.where(j["He_n"] <= 0.0, 1.0, he0)
    clean = no_jH | (h0 <= 1e-10)
    metals = {name: torch.where(clean, 0.0, metals[name]) for name in METAL_NAMES}
    return T0, h0, he0, metals


def solve_temperature_reference(
    T_init, j, h, nd, abundances, pahfac=0.0, crfac=0.0, epsilon: float = 1e-3,
    max_iterations: int = 100, minimum_ionized_temperature: float = 4000.0,
    scale: float = 1.0,
) -> TemperatureSolution:
    """Plain PyTorch log-secant solve (the JAX ``solve_temperature``), in the
    dtype of the inputs, with the balance coefficients times ``scale``.

    Cells start at T_init (8000 K where T_init ≤ 4000 K) and sweep until
    |gain - loss| ≤ ε·gain or ``max_iterations`` sweeps; a cell that went
    below ``minimum_ionized_temperature`` is set neutral at 500 K, one above
    1e10 K ionized.  Cells whose balance is NaN (no gas) never converge and
    run every sweep.
    """
    guard = tiny(T_init)
    shape = T_init.shape
    T_init, nd = T_init.reshape(-1), nd.reshape(-1)
    j = {name: value.reshape(-1) for name, value in j.items()}
    h = (h[0].reshape(-1), h[1].reshape(-1))
    T = torch.where(T_init <= 4000.0, 8000.0, T_init)
    # the state of frozen cells: (T, h0, he0, *metals), and the live cells'
    # indices and inputs, compacted whenever cells freeze
    fields = [T.clone()] + [torch.zeros_like(T) for _ in range(2 + len(METAL_NAMES))]
    sweeps = torch.full_like(T, max_iterations, dtype=torch.int32)
    live = torch.arange(T.numel(), device=T.device)
    inputs = (T, j, h, nd)
    for sweep in range(max_iterations):
        if live.numel() == 0:
            break
        T_l, j_l, h_l, nd_l = inputs
        T_new, gain, loss, h0, he0, metals = _secant_sweep(
            T_l, j_l, h_l, nd_l, abundances, pahfac, crfac, minimum_ionized_temperature,
            scale)
        values = [T_new, h0, he0] + [metals[name] for name in METAL_NAMES]
        # a cell freezes once the reference's top-of-loop check would exit
        frozen = torch.abs(gain - loss) <= epsilon * torch.clamp_min(gain, guard)
        if sweep == max_iterations - 1:
            frozen = torch.ones_like(frozen)
        if bool(frozen.any()):
            done = live[frozen]
            for field, value in zip(fields, values):
                field[done] = value[frozen]
            sweeps[done] = sweep + 1
            keep = ~frozen
            live = live[keep]
            T_new = T_new[keep]
            j_l = {k: v[keep] for k, v in j_l.items()}
            h_l = (h_l[0][keep], h_l[1][keep])
            nd_l = nd_l[keep]
        inputs = (T_new, j_l, h_l, nd_l)
    T, h0, he0 = fields[:3]
    metals = dict(zip(METAL_NAMES, fields[3:]))
    T, h0, he0, metals = _temperature_fixups(T, h0, he0, metals, j)
    return TemperatureSolution(
        T.reshape(shape), h0.reshape(shape), he0.reshape(shape),
        {name: value.reshape(shape) for name, value in metals.items()},
        sweeps.reshape(shape),
    )


def solve_temperature(
    T_init, j, h, nd, abundances, pahfac=0.0, crfac=0.0, epsilon: float = 1e-3,
    max_iterations: int = 100, minimum_ionized_temperature: float = 4000.0,
) -> TemperatureSolution:
    """Equilibrium temperature of every cell (flat f64 tensors of one shape).

    Returns (T, h0, he0, metals, sweeps) with the reference's post-conditions
    applied: T capped at 30 kK, neutral cells at 500 K, metals cleared in
    cells without radiation or fully ionized.  CPU tensors run
    :func:`solve_temperature_reference`; CUDA tensors launch K4, which counts
    its launches in ``kernels.LAUNCHES["temperature"]``.
    """
    kwargs = dict(
        pahfac=float(pahfac), crfac=float(crfac), epsilon=float(epsilon),
        max_iterations=int(max_iterations),
        minimum_ionized_temperature=float(minimum_ionized_temperature),
    )
    if T_init.device.type == "cpu":
        return solve_temperature_reference(T_init, j, h, nd, abundances, **kwargs)
    return TemperatureSolution(*solve_temperature_cuda(T_init, j, h, nd, abundances, **kwargs))


def _to_f32(T_init, j, h, nd):
    def f32(a):
        return a.to(torch.float32)

    return f32(T_init), {k: f32(v) for k, v in j.items()}, (f32(h[0]), f32(h[1])), f32(nd)


def solve_temperature_device_reference(
    T_init, j, h, nd, abundances, pahfac=0.0, crfac=0.0, epsilon: float = 1e-3,
    max_iterations: int = 100, minimum_ionized_temperature: float = 4000.0,
) -> TemperatureSolution:
    """Plain PyTorch f32 solve (the JAX ``solve_temperature_device``): the
    inputs rounded to f32, the log-secant of :func:`solve_temperature_reference`
    in f32 with every coefficient times :data:`DEVICE_SOLVE_SCALE`, and the
    post-conditions on the f32 rates.  Returns f32 fields and the sweeps."""
    return solve_temperature_reference(
        *_to_f32(T_init, j, h, nd), abundances, pahfac=pahfac, crfac=crfac, epsilon=epsilon,
        max_iterations=max_iterations,
        minimum_ionized_temperature=minimum_ionized_temperature, scale=DEVICE_SOLVE_SCALE,
    )


def solve_temperature_device(
    T_init, j, h, nd, abundances, pahfac=0.0, crfac=0.0, epsilon: float = 1e-3,
    max_iterations: int = 100, minimum_ionized_temperature: float = 4000.0,
) -> TemperatureSolution:
    """The f32 backend of the temperature solve (``TemperatureCalculator:
    backend: f32-device``) on tensors of one shape, rounded to f32 first.

    Returns f32 (T, h0, he0, metals) and the int32 sweeps, with the
    post-conditions of :func:`solve_temperature`.  CPU tensors run
    :func:`solve_temperature_device_reference`; CUDA tensors launch K4f, which
    counts its launches in ``kernels.LAUNCHES["temperature_f32"]``.
    """
    kwargs = dict(
        pahfac=float(pahfac), crfac=float(crfac), epsilon=float(epsilon),
        max_iterations=int(max_iterations),
        minimum_ionized_temperature=float(minimum_ionized_temperature),
    )
    if T_init.device.type == "cpu":
        return solve_temperature_device_reference(T_init, j, h, nd, abundances, **kwargs)
    return TemperatureSolution(*solve_temperature_device_cuda(
        *_to_f32(T_init, j, h, nd), abundances, **kwargs))
