"""Riemann solvers for the finite-volume hydro scheme (elementwise torch).

Port of ``cmacionize_tpu/ops/riemann.py``: batched left/right primitive
states → interface fluxes, over whole face arrays at once.  State convention
per interface: density rho, normal velocity u, tangential velocities v, w,
pressure p; fluxes are (mass, normal momentum, tangential momenta, energy) in
the face frame.

The expressions keep the JAX package's operation order, and every division
is a correctly rounded one (:func:`_div`), so that f32 results agree with
JAX to round-off and K3 (``csrc/hydro_step.cu``, whose device solvers repeat
these expressions) agrees with this plain version on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FaceFlux(NamedTuple):
    mass: torch.Tensor
    mom_n: torch.Tensor  # normal momentum
    mom_t1: torch.Tensor
    mom_t2: torch.Tensor
    energy: torch.Tensor


def _div(a, b):
    """``a / b`` rounded once, as ``jnp`` divides.  torch computes
    ``number / tensor`` (and, on CUDA, ``tensor / number``) through a
    reciprocal, which rounds twice; the number is made a 0-d tensor first."""
    if not torch.is_tensor(a):
        a = b.new_full((), a)
    elif not torch.is_tensor(b):
        b = a.new_full((), b)
    return torch.div(a, b)


def _energy(rho, u, v, w, p, gamma):
    return _div(p, gamma - 1.0) + 0.5 * rho * (u * u + v * v + w * w)


def _physical_flux(rho, u, v, w, p, gamma):
    e = _energy(rho, u, v, w, p, gamma)
    return FaceFlux(
        mass=rho * u,
        mom_n=rho * u * u + p,
        mom_t1=rho * u * v,
        mom_t2=rho * u * w,
        energy=(e + p) * u,
    )


def hllc_flux(
    rhoL, uL, vL, wL, pL,
    rhoR, uR, vR, wR, pR,
    gamma: float = 5.0 / 3.0,
):
    """HLLC approximate Riemann solver (Toro ch. 10), vacuum-safe.

    PVRS pressure estimate with rarefaction/shock q-factors for the wave
    speeds; dry (zero-density) states short-circuit to zero flux.
    """
    tiny = 1e-30
    okL = rhoL > tiny
    okR = rhoR > tiny
    srhoL = torch.where(okL, rhoL, 1.0)
    srhoR = torch.where(okR, rhoR, 1.0)
    spL = torch.clamp_min(pL, 0.0)
    spR = torch.clamp_min(pR, 0.0)

    aL = torch.sqrt(gamma * spL / srhoL)
    aR = torch.sqrt(gamma * spR / srhoR)

    # PVRS pressure estimate
    rho_bar = 0.5 * (srhoL + srhoR)
    a_bar = 0.5 * (aL + aR)
    p_pvrs = 0.5 * (spL + spR) - 0.5 * (uR - uL) * rho_bar * a_bar
    p_star = torch.clamp_min(p_pvrs, 0.0)

    def q_factor(p_star, p):
        sp = torch.where(p > tiny, p, 1.0)
        ratio = p_star / sp
        q_shock = torch.sqrt(1.0 + (gamma + 1.0) / (2.0 * gamma) * (ratio - 1.0))
        return torch.where(ratio > 1.0, q_shock, 1.0)

    SL = uL - aL * q_factor(p_star, spL)
    SR = uR + aR * q_factor(p_star, spR)

    denom = srhoL * (SL - uL) - srhoR * (SR - uR)
    safe_denom = torch.where(torch.abs(denom) > tiny, denom, tiny)
    S_star = (
        spR - spL + srhoL * uL * (SL - uL) - srhoR * uR * (SR - uR)
    ) / safe_denom

    fL = _physical_flux(srhoL, uL, vL, wL, spL, gamma)
    fR = _physical_flux(srhoR, uR, vR, wR, spR, gamma)

    def star_flux(f, rho, u, v, w, p, S, S_star):
        """F* = F + S (U* - U) with the HLLC star state."""
        e = _energy(rho, u, v, w, p, gamma)
        coef = rho * (S - u) / torch.where(torch.abs(S - S_star) > tiny, S - S_star, tiny)
        rho_star = coef
        mom_n_star = coef * S_star
        mom_t1_star = coef * v
        mom_t2_star = coef * w
        denom = rho * (S - u)
        safe_denom_su = torch.where(torch.abs(denom) > tiny, denom, tiny)
        e_star = coef * (e / rho + (S_star - u) * (S_star + p / safe_denom_su))
        return FaceFlux(
            mass=f.mass + S * (rho_star - rho),
            mom_n=f.mom_n + S * (mom_n_star - rho * u),
            mom_t1=f.mom_t1 + S * (mom_t1_star - rho * v),
            mom_t2=f.mom_t2 + S * (mom_t2_star - rho * w),
            energy=f.energy + S * (e_star - e),
        )

    fLs = star_flux(fL, srhoL, uL, vL, wL, spL, SL, S_star)
    fRs = star_flux(fR, srhoR, uR, vR, wR, spR, SR, S_star)

    def pick(component_fL, component_fLs, component_fRs, component_fR):
        out = torch.where(SL >= 0.0, component_fL, 0.0)
        out = torch.where((SL < 0.0) & (S_star >= 0.0), component_fLs, out)
        out = torch.where((S_star < 0.0) & (SR > 0.0), component_fRs, out)
        out = torch.where(SR <= 0.0, component_fR, out)
        return out

    flux = FaceFlux(*(pick(*parts) for parts in zip(fL, fLs, fRs, fR)))

    # both-sides-vacuum faces carry no flux
    any_gas = okL | okR
    return FaceFlux(*(torch.where(any_gas, f, 0.0) for f in flux))


# --------------------------------------------------------------------------
# Exact (iterative) Riemann solver (Toro ch. 4)
# --------------------------------------------------------------------------


def _fK(p, rhoK, pK, aK, gamma):
    """Toro's f_K(p): rarefaction/shock relation for one side."""
    AK = _div(2.0, (gamma + 1.0) * rhoK)
    BK = (gamma - 1.0) / (gamma + 1.0) * pK
    shock = (p - pK) * torch.sqrt(AK / (p + BK))
    raref = (
        _div(2.0 * aK, gamma - 1.0)
        * ((p / pK) ** ((gamma - 1.0) / (2.0 * gamma)) - 1.0)
    )
    return torch.where(p > pK, shock, raref)


def _fK_prime(p, rhoK, pK, aK, gamma):
    AK = _div(2.0, (gamma + 1.0) * rhoK)
    BK = (gamma - 1.0) / (gamma + 1.0) * pK
    shock = torch.sqrt(AK / (p + BK)) * (1.0 - 0.5 * (p - pK) / (p + BK))
    raref = (p / pK) ** (-(gamma + 1.0) / (2.0 * gamma)) / (rhoK * aK)
    return torch.where(p > pK, shock, raref)


def exact_star_pressure(rhoL, uL, pL, rhoR, uR, pR, gamma=5.0 / 3.0, n_iter=40):
    """Newton–Raphson for the star-region pressure (elementwise, fixed count)."""
    aL = torch.sqrt(gamma * pL / rhoL)
    aR = torch.sqrt(gamma * pR / rhoR)
    du = uR - uL
    # two-rarefaction initial guess (robust for all cases)
    gz = (gamma - 1.0) / (2.0 * gamma)
    p0 = (
        (aL + aR - 0.5 * (gamma - 1.0) * du)
        / (aL / pL**gz + aR / pR**gz)
    ) ** (1.0 / gz)
    p = torch.maximum(p0, 1e-10 * torch.minimum(pL, pR))

    for _ in range(n_iter):
        f = _fK(p, rhoL, pL, aL, gamma) + _fK(p, rhoR, pR, aR, gamma) + du
        fp = _fK_prime(p, rhoL, pL, aL, gamma) + _fK_prime(p, rhoR, pR, aR, gamma)
        p_new = p - f / torch.clamp_min(fp, 1e-30)
        p = torch.maximum(p_new, 1e-10 * p)

    u_star = 0.5 * (uL + uR) + 0.5 * (
        _fK(p, rhoR, pR, aR, gamma) - _fK(p, rhoL, pL, aL, gamma)
    )
    return p, u_star


def exact_sample(rhoL, uL, pL, rhoR, uR, pR, s, gamma=5.0 / 3.0, n_iter=40):
    """Sample the exact Riemann solution at speed s = x/t (Toro §4.5).

    Returns (rho, u, p) at the sample point.
    """
    aL = torch.sqrt(gamma * pL / rhoL)
    aR = torch.sqrt(gamma * pR / rhoR)
    p_star, u_star = exact_star_pressure(rhoL, uL, pL, rhoR, uR, pR, gamma, n_iter)
    g1 = (gamma - 1.0) / (gamma + 1.0)

    # left side (s < u_star)
    rho_star_L_shock = rhoL * (p_star / pL + g1) / (g1 * p_star / pL + 1.0)
    rho_star_L_raref = rhoL * (p_star / pL) ** (1.0 / gamma)
    SL_shock = uL - aL * torch.sqrt(
        (gamma + 1.0) / (2.0 * gamma) * p_star / pL
        + (gamma - 1.0) / (2.0 * gamma)
    )
    aL_star = aL * (p_star / pL) ** ((gamma - 1.0) / (2.0 * gamma))
    SHL = uL - aL  # rarefaction head
    STL = u_star - aL_star  # rarefaction tail

    # inside left fan
    fan_u_L = 2.0 / (gamma + 1.0) * (aL + 0.5 * (gamma - 1.0) * uL + s)
    fan_a_L = 2.0 / (gamma + 1.0) * (aL + 0.5 * (gamma - 1.0) * (uL - s))
    fan_rho_L = rhoL * (fan_a_L / aL) ** (2.0 / (gamma - 1.0))
    fan_p_L = pL * (fan_a_L / aL) ** (2.0 * gamma / (gamma - 1.0))

    left_shock = p_star > pL
    rho_sh = torch.where(s < SL_shock, rhoL, rho_star_L_shock)
    u_sh = torch.where(s < SL_shock, uL, u_star)
    p_sh = torch.where(s < SL_shock, pL, p_star)
    rho_rf = torch.where(s < SHL, rhoL, torch.where(s > STL, rho_star_L_raref, fan_rho_L))
    u_rf = torch.where(s < SHL, uL, torch.where(s > STL, u_star, fan_u_L))
    p_rf = torch.where(s < SHL, pL, torch.where(s > STL, p_star, fan_p_L))
    rhoLs = torch.where(left_shock, rho_sh, rho_rf)
    uLs = torch.where(left_shock, u_sh, u_rf)
    pLs = torch.where(left_shock, p_sh, p_rf)

    # right side (s > u_star)
    rho_star_R_shock = rhoR * (p_star / pR + g1) / (g1 * p_star / pR + 1.0)
    rho_star_R_raref = rhoR * (p_star / pR) ** (1.0 / gamma)
    SR_shock = uR + aR * torch.sqrt(
        (gamma + 1.0) / (2.0 * gamma) * p_star / pR
        + (gamma - 1.0) / (2.0 * gamma)
    )
    aR_star = aR * (p_star / pR) ** ((gamma - 1.0) / (2.0 * gamma))
    SHR = uR + aR
    STR = u_star + aR_star

    fan_u_R = 2.0 / (gamma + 1.0) * (-aR + 0.5 * (gamma - 1.0) * uR + s)
    fan_a_R = 2.0 / (gamma + 1.0) * (aR - 0.5 * (gamma - 1.0) * (uR - s))
    fan_rho_R = rhoR * (fan_a_R / aR) ** (2.0 / (gamma - 1.0))
    fan_p_R = pR * (fan_a_R / aR) ** (2.0 * gamma / (gamma - 1.0))

    right_shock = p_star > pR
    rho_sh = torch.where(s > SR_shock, rhoR, rho_star_R_shock)
    u_sh = torch.where(s > SR_shock, uR, u_star)
    p_sh = torch.where(s > SR_shock, pR, p_star)
    rho_rf = torch.where(s > SHR, rhoR, torch.where(s < STR, rho_star_R_raref, fan_rho_R))
    u_rf = torch.where(s > SHR, uR, torch.where(s < STR, u_star, fan_u_R))
    p_rf = torch.where(s > SHR, pR, torch.where(s < STR, p_star, fan_p_R))
    rhoRs = torch.where(right_shock, rho_sh, rho_rf)
    uRs = torch.where(right_shock, u_sh, u_rf)
    pRs = torch.where(right_shock, p_sh, p_rf)

    on_left = s <= u_star
    return (
        torch.where(on_left, rhoLs, rhoRs),
        torch.where(on_left, uLs, uRs),
        torch.where(on_left, pLs, pRs),
    )


def exact_flux(
    rhoL, uL, vL, wL, pL, rhoR, uR, vR, wR, pR,
    gamma=5.0 / 3.0, n_iter=20,
) -> FaceFlux:
    """Exact Riemann interface flux with full vacuum handling.

    The exact solution sampled at s = x/t = 0, converted to the physical
    flux.  Vacuum left/right states (ρ or P ≤ 1e-40), vacuum generation
    (2(a_L + a_R)/(γ-1) ≤ u_R - u_L) and the both-vacuum case are masks.
    Tangential velocities are upwinded by the sign of the sampled normal
    velocity.
    """
    tiny = 1e-40
    vac_L = (rhoL <= tiny) | (pL <= tiny)
    vac_R = (rhoR <= tiny) | (pR <= tiny)
    rhoL_s = torch.where(vac_L, 1.0, rhoL)
    pL_s = torch.where(vac_L, 1.0, torch.clamp_min(pL, tiny))
    rhoR_s = torch.where(vac_R, 1.0, rhoR)
    pR_s = torch.where(vac_R, 1.0, torch.clamp_min(pR, tiny))
    aL = torch.sqrt(gamma * pL_s / rhoL_s)
    aR = torch.sqrt(gamma * pR_s / rhoR_s)
    gm1 = gamma - 1.0

    # vacuum generation: the two rarefactions separate completely
    vac_gen = (~vac_L) & (~vac_R) & (_div(2.0 * (aL + aR), gm1) <= uR - uL)

    # regular exact solution sampled at s = 0
    rho0, u0, p0 = exact_sample(
        rhoL_s, uL, pL_s, rhoR_s, uR, pR_s, torch.zeros_like(rhoL_s),
        gamma=gamma, n_iter=n_iter)

    # one-sided rarefaction into vacuum (Toro §4.6); right state is vacuum:
    # head uL - aL, vacuum front uL + 2aL/(γ-1)
    shl = uL - aL
    svl = uL + _div(2.0 * aL, gm1)
    fan_a = torch.clamp_min(2.0 / (gamma + 1.0) * (aL + 0.5 * gm1 * uL), 0.0)
    fan_u = 2.0 / (gamma + 1.0) * (aL + 0.5 * gm1 * uL)
    fan_rho = rhoL_s * (fan_a / aL) ** (2.0 / gm1)
    fan_p = pL_s * (fan_a / aL) ** (2.0 * gamma / gm1)
    rho_lv = torch.where(shl >= 0.0, rhoL_s, torch.where(svl <= 0.0, 0.0, fan_rho))
    u_lv = torch.where(shl >= 0.0, uL, torch.where(svl <= 0.0, 0.0, fan_u))
    p_lv = torch.where(shl >= 0.0, pL_s, torch.where(svl <= 0.0, 0.0, fan_p))

    shr = uR + aR
    svr = uR - _div(2.0 * aR, gm1)
    fan_a = torch.clamp_min(2.0 / (gamma + 1.0) * (aR - 0.5 * gm1 * uR), 0.0)
    fan_u = 2.0 / (gamma + 1.0) * (-aR + 0.5 * gm1 * uR)
    fan_rho = rhoR_s * (fan_a / aR) ** (2.0 / gm1)
    fan_p = pR_s * (fan_a / aR) ** (2.0 * gamma / gm1)
    rho_rv = torch.where(shr <= 0.0, rhoR_s, torch.where(svr >= 0.0, 0.0, fan_rho))
    u_rv = torch.where(shr <= 0.0, uR, torch.where(svr >= 0.0, 0.0, fan_u))
    p_rv = torch.where(shr <= 0.0, pR_s, torch.where(svr >= 0.0, 0.0, fan_p))

    # vacuum generation: left fan for s < vacuum front, right fan beyond
    rho_vg = torch.where(svl >= 0.0, rho_lv, rho_rv)
    u_vg = torch.where(svl >= 0.0, u_lv, u_rv)
    p_vg = torch.where(svl >= 0.0, p_lv, p_rv)

    def select(both, right_vac, left_vac, gen, regular):
        return torch.where(
            vac_L & vac_R, both,
            torch.where(vac_R, right_vac,
                        torch.where(vac_L, left_vac,
                                    torch.where(vac_gen, gen, regular))))

    rho = select(0.0, rho_lv, rho_rv, rho_vg, rho0)
    u = select(0.0, u_lv, u_rv, u_vg, u0)
    p = select(0.0, p_lv, p_rv, p_vg, p0)

    # tangential velocities ride the contact: upwind by the interface u
    v = torch.where(u > 0.0, vL, vR)
    w = torch.where(u > 0.0, wL, wR)
    return _physical_flux(rho, u, v, w, p, gamma)
