"""Charge-transfer ionization/recombination rates on tensors.

Port of ``cmacionize_tpu/ops/charge_transfer.py`` (the reference's
src/ChargeTransferRates.cpp): the Kingdon & Ferland 1996 and Arnaud &
Rothenflug 1985 fits

    rate = a · t^b · (1 + c · exp(-d·t)) [· exp(-e/t)]      (SI m³ s⁻¹)

with t = T/10⁴ K clamped to each fit's validity window.  Ions with no
published rate return 0.
"""

from __future__ import annotations

import torch

from cmacionize_torch.ops.recombination import div

# name → (a, b, c, d, e, t_lo, t_hi); e = 0 means no exp(-e/t) factor.
# constant rates are encoded with b = c = e = 0.
RECOMBINATION_H = {
    "He_n": (7.47e-21, 2.06, 9.93, 3.89, 0.0, 0.6, 10.0),
    "C_p1": (1.67e-19, 2.79, 304.74, 4.07, 0.0, 0.5, 5.0),
    "C_p2": (3.25e-15, 0.21, 0.19, 3.29, 0.0, 0.1, 10.0),
    "N_n": (1.01e-18, -0.29, -0.92, 8.38, 0.0, 0.01, 5.0),
    "N_p1": (3.05e-16, 0.6, 2.65, 0.93, 0.0, 0.1, 10.0),
    "N_p2": (4.54e-15, 0.57, -0.65, 0.89, 0.0, 0.001, 10.0),
    "O_n": (1.04e-15, 3.15e-2, -0.61, 9.73, 0.0, 0.001, 1.0),
    "O_p1": (1.04e-15, 0.27, 2.02, 5.92, 0.0, 0.01, 10.0),
    "Ne_p1": (1.0e-20, 0.0, 0.0, 1.0, 0.0, 0.1, 10.0),
    "S_p1": (1.0e-20, 0.0, 0.0, 1.0, 0.0, 0.1, 10.0),
    "S_p2": (2.29e-15, 4.02e-2, 1.59, 6.06, 0.0, 0.1, 3.0),
    "S_p3": (6.44e-15, 0.13, 2.69, 5.69, 0.0, 0.1, 3.0),
}

IONIZATION_H = {
    "N_n": (4.55e-18, -0.29, -0.92, 8.38, 1.086, 0.01, 5.0),
    "O_n": (7.4e-17, 0.47, 24.37, 0.74, 0.023, 0.001, 1.0),
}

RECOMBINATION_HE = {
    "C_p2": (4.6e-17, 2.0, 0.0, 1.0, 0.0, 0.1, 3.0),
    "N_p1": (3.3e-16, 0.29, 1.3, 4.5, 0.0, 0.1, 3.0),
    "N_p2": (1.5e-16, 0.0, 0.0, 1.0, 0.0, 0.1, 3.0),
    "O_p1": (2.0e-16, 0.95, 0.0, 1.0, 0.0, 0.5, 5.0),
    "Ne_p1": (1.0e-20, 0.0, 0.0, 1.0, 0.0, 0.1, 3.0),
    "S_p2": (1.1e-15, 0.56, 0.0, 1.0, 0.0, 0.1, 3.0),
    "S_p3": (7.6e-19, 0.32, 3.4, 5.25, 0.0, 0.1, 3.0),
}


def _evaluate(table, ion_name, t4):
    if ion_name not in table:
        return torch.zeros_like(t4)
    a, b, c, d, e, lo, hi = table[ion_name]
    t = torch.clamp(t4, lo, hi)
    rate = a * t**b * (1.0 + c * torch.exp(-d * t))
    if e != 0.0:
        rate = rate * torch.exp(div(-e, t))
    return rate


def recombination_rate_H(ion_name: str, t4):
    """X^(i+1) + H⁰ → X^i + H⁺ rate (m³ s⁻¹), t4 = T / 10⁴ K."""
    return _evaluate(RECOMBINATION_H, ion_name, t4)


def ionization_rate_H(ion_name: str, t4):
    """X^i + H⁺ → X^(i+1) + H⁰ rate (m³ s⁻¹)."""
    return _evaluate(IONIZATION_H, ion_name, t4)


def recombination_rate_He(ion_name: str, t4):
    """X^(i+1) + He⁰ → X^i + He⁺ rate (m³ s⁻¹)."""
    return _evaluate(RECOMBINATION_HE, ion_name, t4)
