"""Photoionization equilibrium solvers (elementwise torch ops).

Port of ``cmacionize_tpu/ops/ionization.py``: ``hydrogen_neutral_fraction``
and ``normalize_mean_intensity`` (the H-only path, f32), the coupled
hydrogen-helium fixed point ``hydrogen_helium_neutral_fractions`` and the
closed-form metal chains ``metal_ion_fractions`` (the multi-frequency path,
f64, or f32 in the device backend of the temperature solve).
Mean-intensity tallies are normalized by jfac = L_tot / (W_tot · V_cell) into
photoionization rates j [s^-1], then the balance is solved per cell (the
reference's src/IonizationStateCalculator.cpp).  The arithmetic is written in
the JAX package's order, divisions by a number go through
``recombination.div``, and K4 and K4f (``csrc/temperature.cu``) repeat the
H-He and metal expressions operation for operation.
"""

from __future__ import annotations

import torch

from cmacionize_torch.ops import charge_transfer as ct
from cmacionize_torch.ops.recombination import div

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


# ---------------------------------------------------------------------------
# Coupled hydrogen-helium balance (f64)
# ---------------------------------------------------------------------------

def tiny(x: torch.Tensor) -> float:
    """The division guard of x's dtype: 1e-300 in f64, 1e-30 in f32 (where
    1e-300 rounds to 0), as the JAX package's ``_tiny``."""
    return 1e-300 if x.dtype == torch.float64 else 1e-30


def hydrogen_helium_neutral_fractions(jH, jHe, nH, AHe, T, alphaH, alphaHe,
                                      n_iterations: int = 20):
    """Coupled H-He photoionization equilibrium, reference-exact.

    The reference's ``compute_ionization_states_hydrogen_helium`` as the JAX
    package replicates it: the same iteration order, the Taylor branches of
    both quadratics, averaging damping after 10 iterations, and the early
    exit as soon as EITHER fraction changes by less than 1e-4 relative.  The
    per-cell loop is a masked lockstep loop: settled cells freeze while the
    rest go on.  The result is not clipped to [0, 1] (the reference keeps
    raw iterates); cells with jH < 1e-20 are fully neutral.

    Returns (h0, he0) neutral fractions.
    """
    safe_jH = torch.where(jH > 0.0, jH, torch.ones_like(jH))
    safe_jHe = torch.where(jHe > 0.0, jHe, torch.ones_like(jHe))
    has_che = jHe > 0.0

    # effective He 2^1P recombination pumping the H-ionizing continuum
    alpha_e_2sP = 4.17e-20 * (T * 1.0e-4) ** (-0.861)
    ch1 = alphaH * nH / safe_jH
    ch2 = AHe * alpha_e_2sP * nH / safe_jH
    che = torch.where(has_che, alphaHe * nH / safe_jHe, torch.zeros_like(jHe))
    sqrtT = torch.sqrt(T)

    # initial guesses
    h0old = 0.99 * (1.0 - torch.exp(div(-0.5, ch1)))
    h0 = 0.9 * h0old
    he0old = torch.where(
        has_che, torch.clamp_max(div(0.5, torch.clamp_min(che, tiny(che))), 1.0),
        torch.ones_like(che),
    )
    he0 = torch.zeros_like(h0)

    def converged(h0, h0old, he0, he0old):
        # the loop CONTINUES while both change; it stops when either settles
        dh = torch.abs(h0 - h0old) > 1e-4 * h0old
        dhe = torch.abs(he0 - he0old) > 1e-4 * he0old
        return ~(dh & dhe)

    frozen = converged(h0, h0old, he0, he0old)
    niter = 0
    while niter < n_iterations and bool(torch.any(~frozen)):
        h0old_n = h0
        he0old_n = torch.clamp_min(he0, 0.0)

        pHots = div(1.0, 1.0 + 77.0 * he0old_n / (sqrtT * torch.clamp_min(h0old_n, tiny(h0old_n))))
        ch = ch1 - ch2 * AHe * (1.0 - he0old_n) * pHots / (1.0 - h0old_n)

        # helium quadratic with Taylor fallback
        bhe = (1.0 + 2.0 * AHe - h0) * che + 1.0
        che_bhe = che / bhe
        opAHeh0 = 1.0 + AHe - h0
        t1he = 4.0 * AHe * opAHeh0 * che_bhe * che_bhe
        disc_he = torch.sqrt(
            torch.clamp_min(bhe * bhe - 4.0 * AHe * opAHeh0 * che * che, 0.0)
        )
        he0_exact = (bhe - disc_he) / (2.0 * AHe * torch.clamp_min(che, tiny(che)))
        he0_new = torch.where(t1he < 1e-3, opAHeh0 * che_bhe, he0_exact)
        he0_new = torch.where(has_che, he0_new, torch.ones_like(he0_new))

        # hydrogen quadratic with Taylor fallback
        b = ch * (2.0 + AHe - he0_new * AHe) + 1.0
        ch_b = ch / b
        opA = 1.0 + AHe - he0_new * AHe
        t1 = 4.0 * ch_b * ch_b * opA
        disc_h = torch.sqrt(torch.clamp_min(b * b - 4.0 * ch * ch * opA, 0.0))
        sign_ch = torch.where(ch >= 0, 1.0, -1.0).to(ch.dtype)
        h0_exact = (b - disc_h) / (2.0 * sign_ch * torch.clamp_min(torch.abs(ch), tiny(ch)))
        h0_new = torch.where(t1 < 1e-3, ch_b * opA, h0_exact)

        # averaging damping: the reference increments its counter first, so
        # its `niter > 10` is this loop's 0-based index >= 10
        if niter + 1 > 10:
            h0_new = 0.5 * (h0_new + h0old_n)
            he0_new = 0.5 * (he0_new + he0old_n)

        # frozen cells keep their values
        h0_out = torch.where(frozen, h0, h0_new)
        he0_out = torch.where(frozen, he0, he0_new)
        h0old = torch.where(frozen, h0old, h0old_n)
        he0old = torch.where(frozen, he0old, he0old_n)
        h0, he0 = h0_out, he0_out
        frozen = frozen | converged(h0, h0old, he0, he0old)
        niter += 1

    # negligible radiation -> fully neutral
    neutral = jH < 1.0e-20
    h0 = torch.where(neutral, torch.ones_like(h0), h0)
    he0 = torch.where(neutral, torch.ones_like(he0), he0)
    return h0, he0


# ---------------------------------------------------------------------------
# Metal ionization chains (closed form, f64)
# ---------------------------------------------------------------------------


def metal_ion_fractions(j, ne, T, nh0, nhe0, nhp, alphas):
    """Closed-form coupled metal ionization chains with charge transfer.

    For each element the stage ratios R(i+1, i) = j_i / (ne·α_i + CT terms)
    combine into normalized stage fractions.  Following the reference's
    storage convention, the fraction returned for slot "X_pk" is that of the
    NEXT stage (the photoionization product of X_pk): x["N_n"] is the N⁺
    fraction and the N⁰ fraction is 1 - x[N_n] - x[N_p1] - x[N_p2].

    Args:
        j: dict name → photoionization rate (s⁻¹); ne: electron density;
        nh0 / nhe0 / nhp: neutral H, neutral He, ionized H densities (m⁻³);
        alphas: dict name → recombination rate at T (m³/s).

    Returns dict name → fraction for the 12 metal slots.
    """
    t4 = T * 1.0e-4
    safe_ne = torch.clamp_min(ne, 1e-30)

    def ratio(name, with_ion_H=False):
        denom = safe_ne * alphas[name] + nh0 * ct.recombination_rate_H(name, t4)
        denom = denom + nhe0 * ct.recombination_rate_He(name, t4)
        numer = j[name]
        if with_ion_H:
            numer = numer + nhp * ct.ionization_rate_H(name, t4)
        return numer / torch.clamp_min(denom, tiny(denom))

    def chain(first, *ratios):
        """Stage fractions of one element from R(2,1) and the next ratios."""
        cumulative = [first]
        for r in ratios:
            cumulative.append(r * cumulative[-1])
        total = 1.0 + cumulative[0]
        for c in cumulative[1:]:
            total = total + c
        inv = div(1.0, total)
        return [c * inv for c in cumulative]

    out = {}
    # carbon: no CT term for C+ (negligible per the reference)
    C21 = j["C_p1"] / torch.clamp_min(safe_ne * alphas["C_p1"], tiny(safe_ne))
    out["C_p1"], out["C_p2"] = chain(C21, ratio("C_p2"))
    out["N_n"], out["N_p1"], out["N_p2"] = chain(
        ratio("N_n", with_ion_H=True), ratio("N_p1"), ratio("N_p2"))
    out["O_n"], out["O_p1"] = chain(ratio("O_n", with_ion_H=True), ratio("O_p1"))
    Ne21 = j["Ne_n"] / torch.clamp_min(safe_ne * alphas["Ne_n"], tiny(safe_ne))
    out["Ne_n"], out["Ne_p1"] = chain(Ne21, ratio("Ne_p1"))
    out["S_p1"], out["S_p2"], out["S_p3"] = chain(
        ratio("S_p1"), ratio("S_p2"), ratio("S_p3"))
    return {name: out[name] for name in (
        "C_p1", "C_p2", "N_n", "N_p1", "N_p2", "O_n", "O_p1",
        "Ne_n", "Ne_p1", "S_p1", "S_p2", "S_p3")}
