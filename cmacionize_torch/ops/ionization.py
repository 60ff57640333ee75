"""Hydrogen photoionization equilibrium (elementwise torch ops).

Port of ``cmacionize_tpu/ops/ionization.py:hydrogen_neutral_fraction`` and
``normalize_mean_intensity``: mean-intensity tallies are normalized by
jfac = L_tot / (W_tot · V_cell) into photoionization rates j_H [s^-1], then
the balance is solved per cell (the reference's
src/IonizationStateCalculator.cpp).  The arithmetic is written in the JAX
package's order so that f32 results agree to round-off.
"""

from __future__ import annotations

import torch

# lower floor on neutral fractions, cf. the reference's
# src/IonizationStateCalculator.cpp:810 (1e-14)
NEUTRAL_FRACTION_FLOOR = 1.0e-14


def hydrogen_neutral_fraction(jH, nH, alphaH):
    """Solve jH·x = αH·nH·(1-x)² for the neutral fraction x ∈ (0, 1].

    With C = αH·nH/jH the physical root of C·x² - (2C+1)·x + C = 0 is written
    via its conjugate (the two roots multiply to 1), which is numerically
    stable for both the highly ionized (C → 0) and neutral (C → ∞) limits —
    no cancellation, so f32 is sufficient.

    Cells with no ionizing radiation (jH <= 0) or no gas stay fully neutral.
    """
    jH = torch.as_tensor(jH)
    nH = torch.as_tensor(nH, dtype=jH.dtype, device=jH.device)
    safe_j = torch.where(jH > 0.0, jH, torch.ones_like(jH))
    C = alphaH * nH / safe_j
    x = 2.0 * C / (2.0 * C + 1.0 + torch.sqrt(4.0 * C + 1.0))
    x = torch.clamp_min(x, NEUTRAL_FRACTION_FLOOR)
    return torch.where((jH > 0.0) & (nH > 0.0), x, torch.ones_like(x))


def normalize_mean_intensity(tally, luminosity, total_weight, cell_volume):
    """Raw path-length tally Σ ℓσw [m³] → photoionization rate [s^-1].

    jfac = L / (W_tot · V_cell), cf. the reference's
    src/IonizationStateCalculator.cpp:519,545.
    """
    return tally * (luminosity / (total_weight * cell_volume))
