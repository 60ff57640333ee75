"""Recombination rates (radiative + dielectronic) on tensors of T.

Port of ``cmacionize_tpu/ops/recombination.py`` (the reference's
src/VernerRecombinationRates.cpp): the Verner & Ferland 1996 rrfit radiative
fits plus the dielectronic corrections (Nussbaumer & Storey 1983 polynomials
for C/N/O/Ne, exponential sums for S), in SI m³ s⁻¹.

The expressions keep the JAX package's operation order.  Every division by a
Python number goes through :func:`div` (one correctly rounded division), and
K4 (``csrc/temperature.cu``) repeats these expressions operation for
operation, so that the card's kernel and this plain version agree to the
last bit where their transcendentals do.
"""

from __future__ import annotations

import torch

from cmacionize_torch.data import verner_rec_tables

CM3_TO_M3 = 1e-6

# (Z, N_electrons) pair per ion for the rrfit tables
ION_ZN = {
    "H_n": (1, 1),
    "He_n": (2, 2),
    "C_p1": (6, 5),
    "C_p2": (6, 4),
    "N_n": (7, 7),
    "N_p1": (7, 6),
    "N_p2": (7, 5),
    "O_n": (8, 8),
    "O_p1": (8, 7),
    "Ne_n": (10, 10),
    "Ne_p1": (10, 9),
    "S_p1": (16, 15),
    "S_p2": (16, 14),
    "S_p3": (16, 13),
}

# dielectronic corrections, low-T polynomial form (Nussbaumer & Storey 1983):
# rate_cm3 = 1e-12 (a/t + b + c t + d t²) t^-1.5 exp(-f/t), t = T/1e4 K
DIELECTRONIC_NS83 = {
    "C_p1": (1.8267, 4.1012, 4.8443, 0.2261, 0.5960),
    "C_p2": (2.3196, 10.7328, 6.8830, -0.1824, 0.4101),
    "N_n": (0.0, 0.6310, 0.1990, -0.0197, 0.4398),
    "N_p1": (0.0320, -0.6624, 4.3191, 0.0003, 0.5946),
    "N_p2": (-0.8806, 11.2406, 30.7066, -1.1721, 0.6127),
    "O_n": (-0.0001, 0.0001, 0.0956, 0.0193, 0.4106),
    "O_p1": (-0.0036, 0.7519, 1.5252, -0.0838, 0.2769),
    "Ne_p1": (0.0129, -0.1779, 0.9353, -0.0682, 0.4156),
}

K_PER_EV = 1.16045221e4

# H and He use dedicated case-B-appropriate fits rather than the rrfit tables
HYDROGEN_FIT = (7.982e-11, 0.748, 3.148, 7.036e5)
HELIUM_FIT = (3.294e-11, 0.691, 15.54, 3.676e7)

# the S dielectronic sums: (coefficient, exponent) pairs
S_P2_TERMS = ((8.0729e-9, -17.56), (1.1012e-10, -7.07))
S_P3_TERMS = (
    (5.817e-7, -362.8), (1.391e-6, -1058.0), (1.123e-5, -7160.0),
    (1.521e-4, -3.26e4), (1.875e-3, -1.235e5), (2.097e-2, -2.07e5),
)


def div(a, b):
    """``a / b`` rounded once, as ``jnp`` divides.  torch computes
    ``number / tensor`` (and, on CUDA, ``tensor / number``) through a
    reciprocal, which rounds twice; the number becomes a 0-d tensor first."""
    if not torch.is_tensor(a):
        a = b.new_full((), a)
    elif not torch.is_tensor(b):
        b = a.new_full((), b)
    return torch.div(a, b)


def _radiative_coefficients():
    """Per-ion radiative fit: ("rnew", (A, B, T0, T1)) or ("rrec", (a, b))."""
    rrec, rnew, _ = verner_rec_tables()
    coeffs = {"H_n": ("rnew", HYDROGEN_FIT), "He_n": ("rnew", HELIUM_FIT)}
    for name, (Z, N) in ION_ZN.items():
        if name in coeffs:
            continue
        # branch selection replicates the published rrfit routine's logic
        use_rnew = N <= 3 or N == 11 or (5 < Z < 9) or Z == 10 or (Z == 26 and N > 11)
        if use_rnew:
            coeffs[name] = ("rnew", tuple(float(rnew[i, Z, N]) for i in range(4)))
        else:
            coeffs[name] = ("rrec", tuple(float(rrec[i, Z, N]) for i in range(2)))
    return coeffs


RADIATIVE = _radiative_coefficients()


def _rnew_rate(T, A, B, T0, T1):
    """4-parameter Verner & Ferland 1996 fit (cm³/s)."""
    tt = torch.sqrt(div(T, T0))
    return div(A, tt * (1.0 + tt) ** (1.0 - B) * (1.0 + torch.sqrt(div(T, T1))) ** (1.0 + B))


def _rrec_rate(T, a, b):
    """Power-law fit (cm³/s)."""
    return a * (T * 1e-4) ** (-b)


def _dielectronic_ns83(T, a, b, c, d, f):
    t = T * 1e-4
    t_inv = div(1.0, t)
    return 1e-12 * (a * t_inv + b + c * t + d * t * t) * t**-1.5 * torch.exp(-f * t_inv)


def radiative_rate(ion_name: str, T):
    kind, cs = RADIATIVE[ion_name]
    if kind == "rnew":
        return _rnew_rate(T, *cs)
    return _rrec_rate(T, *cs)


def recombination_rate(ion_name: str, T):
    """Total recombination rate (radiative + dielectronic) in m³ s⁻¹."""
    if not torch.is_tensor(T):
        T = torch.tensor(T, dtype=torch.float64)
    rate = radiative_rate(ion_name, T)
    if ion_name in DIELECTRONIC_NS83:
        rate = rate + _dielectronic_ns83(T, *DIELECTRONIC_NS83[ion_name])
    elif ion_name == "S_p1":
        t_ev = div(T, K_PER_EV)
        rate = rate + 1.37e-9 * torch.exp(div(-14.95, t_ev)) * t_ev**-1.5
    elif ion_name == "S_p2":
        t_ev = div(T, K_PER_EV)
        (c0, e0), (c1, e1) = S_P2_TERMS
        rate = rate + (
            c0 * torch.exp(div(e0, t_ev)) + c1 * torch.exp(div(e1, t_ev))
        ) * t_ev**-1.5
    elif ion_name == "S_p3":
        T_inv = div(1.0, T)
        terms = [c * torch.exp(e * T_inv) for c, e in S_P3_TERMS]
        total = terms[0]
        for term in terms[1:]:
            total = total + term
        rate = rate + total * T**-1.5
    return torch.clamp_min(rate, 0.0) * CM3_TO_M3
