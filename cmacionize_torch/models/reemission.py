"""Diffuse re-emission: per-cell channel probabilities and re-emission spectra.

Port of ``cmacionize_tpu/models/reemission.py`` (the reference's
PhysicalDiffuseReemissionHandler and its Lyman-continuum and two-photon
spectra): an absorbed packet is re-emitted with a channel-dependent new
frequency (Wood, Mathis & Ercolano 2004, §3.3).  The tables are built on the
host in numpy (:meth:`ReemissionSpectra.build`, carried over); the whole
absorbed batch is re-emitted in one vectorized pass on the device.

Every uniform is drawn from the explicit ``torch.Generator``, each from its
own draw.  The JAX ``reemit_batch`` draws ``u_sub2`` and the two-photon
frequency from the same key, so the Lyα → two-photon channel there samples
only the lower 56% of the two-photon CDF (ROADMAP queue 3); the port does not
copy that reuse.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cmacionize_torch import constants
from cmacionize_torch.ops import cross_sections as xsec_mod
from cmacionize_torch.ops.recombination import div

NU_MIN = 3.288e15  # 13.6 eV (Hz)
FREQ_19P8EV = 4.788e15  # He 2^3S -> 1^1S line (Hz)

# He 2-photon emission distribution A(y), y = nu/nu0 with nu0 = 4.98e15 Hz
# (published data: Drake, Victor & Dalgarno 1969, table II)
_HE2Q_Y = np.linspace(0.0, 1.0, 41)
_HE2Q_A = np.array([
    0.00e0, 7.77e0, 2.52e1, 4.35e1, 5.99e1, 7.42e1, 8.64e1, 9.69e1, 1.06e2,
    1.13e2, 1.20e2, 1.25e2, 1.30e2, 1.34e2, 1.37e2, 1.40e2, 1.42e2, 1.43e2,
    1.45e2, 1.45e2, 1.45e2, 1.45e2, 1.45e2, 1.43e2, 1.42e2, 1.40e2, 1.37e2,
    1.34e2, 1.30e2, 1.25e2, 1.20e2, 1.13e2, 1.06e2, 9.69e1, 8.64e1, 7.42e1,
    5.99e1, 4.35e1, 2.52e1, 7.77e0, 0.00e0,
])


def _uniform(generator: torch.Generator, n: int) -> torch.Tensor:
    return torch.rand(n, generator=generator, device=generator.device, dtype=torch.float32)


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)``: linear interpolation in a 1-D table,
    clamped to fp[0] below xp[0] and to fp[-1] above xp[-1]; a zero-width
    interval gives its left value."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    epsilon = float(np.spacing(np.finfo(np.float32 if xp.dtype == torch.float32 else np.float64).eps))
    dx0 = torch.abs(dx) <= epsilon
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def reemission_probabilities(T):
    """Per-cell re-emission probabilities at the temperatures T.

    Returns (p_H, (c1, c2, c3, c4)): the probability that an H-absorbed
    packet is re-emitted as H Lyman continuum, and the cumulative
    probabilities of the four helium channels (LyC, the 19.8 eV 2^3S line,
    the two-photon continuum, Lyα).
    """
    T4 = T * 1e-4
    alpha_1_H = 1.58e-13 * T4 ** (-0.53)
    alpha_A_agn = 4.18e-13 * T4 ** (-0.7)
    p_H = alpha_1_H / alpha_A_agn

    alpha_1_He = 1.54e-13 * T4 ** (-0.486)
    alpha_e_2tS = 2.1e-13 * T4 ** (-0.381)
    alpha_e_2sS = 2.06e-14 * T4 ** (-0.451)
    alpha_e_2sP = 4.17e-14 * T4 ** (-0.695)
    total = alpha_1_He + alpha_e_2tS + alpha_e_2sS + alpha_e_2sP
    c1 = alpha_1_He / total
    c2 = c1 + alpha_e_2tS / total
    c3 = c2 + alpha_e_2sS / total
    c4 = c3 + alpha_e_2sP / total
    return p_H, (c1, c2, c3, c4)


def _cdf_from_pdf(freqs, pdf):
    pdf = np.maximum(pdf, 0.0)
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (pdf[1:] + pdf[:-1]) * np.diff(freqs))])
    total = cdf[-1]
    if total <= 0.0:
        return np.linspace(0.0, 1.0, len(freqs))
    return cdf / total


@dataclasses.dataclass(frozen=True)
class ReemissionSpectra:
    """Inverse-CDF tables of the diffuse re-emission channels.

    H and He Lyman continua depend on temperature: their CDFs are tabulated
    on a temperature grid and sampled with the nearest-T row and linear
    interpolation in frequency.
    """

    temperatures: np.ndarray  # [NT]
    frequencies: np.ndarray  # [NF]
    h_lyc_cdf: np.ndarray  # [NT, NF]
    he_lyc_cdf: np.ndarray  # [NT, NF]
    he_2pc_freqs: np.ndarray  # [NF2]
    he_2pc_cdf: np.ndarray  # [NF2]

    @classmethod
    def build(cls, n_temp: int = 64, n_freq: int = 256) -> "ReemissionSpectra":
        temps = 1500.0 + (np.arange(n_temp) + 0.5) * 13500.0 / n_temp
        freqs = np.linspace(NU_MIN, 4.0 * NU_MIN, n_freq)
        sigma_H = xsec_mod.ion_cross_section("H_n", freqs)
        sigma_He = xsec_mod.ion_cross_section("He_n", freqs)
        h_over_k = constants.PLANCK / constants.BOLTZMANN

        h_cdf = np.zeros((n_temp, n_freq))
        he_cdf = np.zeros((n_temp, n_freq))
        for iT, T in enumerate(temps):
            # nu^2 sigma exp(-h(nu-nu_th)/kT): the free-bound photon-number
            # spectrum (WME04 eq. 8 divided by h nu)
            h_pdf = freqs**2 * sigma_H * np.exp(-h_over_k * (freqs - NU_MIN) / T)
            h_cdf[iT] = _cdf_from_pdf(freqs, h_pdf)
            nu_he = 1.81 * NU_MIN
            he_pdf = np.where(
                freqs >= nu_he,
                freqs**2 * sigma_He * np.exp(-h_over_k * (freqs - nu_he) / T),
                0.0,
            )
            he_cdf[iT] = _cdf_from_pdf(freqs, he_pdf)

        # He two-photon continuum, H-ionizing part (nu in [nu_min, 1.6 nu_min])
        nu0 = 4.98e15
        freqs2 = np.linspace(NU_MIN, 1.6 * NU_MIN, 128)
        a_interp = np.interp(freqs2 / nu0, _HE2Q_Y, _HE2Q_A, left=0.0, right=0.0)
        cdf2 = _cdf_from_pdf(freqs2, a_interp)
        return cls(temps, freqs, h_cdf, he_cdf, freqs2, cdf2)

    def on_device(self, device) -> "DeviceSpectra":
        """The f32 sampling tables on ``device``."""
        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        return DeviceSpectra(
            t0=float(self.temperatures[0]),
            dT=float(self.temperatures[1] - self.temperatures[0]),
            frequencies=f32(self.frequencies),
            h_lyc_cdf=f32(self.h_lyc_cdf),
            he_lyc_cdf=f32(self.he_lyc_cdf),
            he_2pc_freqs=f32(self.he_2pc_freqs),
            he_2pc_cdf=f32(self.he_2pc_cdf),
        )


@dataclasses.dataclass(frozen=True)
class DeviceSpectra:
    """ReemissionSpectra's tables as f32 tensors on the sampling device."""

    t0: float
    dT: float
    frequencies: torch.Tensor  # [NF]
    h_lyc_cdf: torch.Tensor  # [NT, NF]
    he_lyc_cdf: torch.Tensor  # [NT, NF]
    he_2pc_freqs: torch.Tensor  # [NF2]
    he_2pc_cdf: torch.Tensor  # [NF2]

    def _sample_tdep(self, cdf_table, xi, T):
        """Inverse-CDF sample of the nearest-T row at the uniforms ``xi``.

        The row index is formed in f64, as JAX forms it from the table's f64
        temperatures.  The search is a binary search per packet over its row
        (``jnp.searchsorted``'s side="left"), so no [P, NF] rows are
        gathered."""
        n_t, n_f = cdf_table.shape
        iT = torch.clamp(
            (div(T.double() - self.t0, self.dT) + 0.5).to(torch.int32), 0, n_t - 1)
        flat = cdf_table.reshape(-1)
        base = iT.to(torch.int64) * n_f
        # first index of the row whose value is >= xi, searched in [lo, hi)
        lo = torch.zeros_like(base)
        hi = torch.full_like(base, n_f)
        for _ in range(int(n_f).bit_length()):
            open_ = lo < hi
            mid = (lo + hi) // 2
            right = open_ & (flat[base + torch.clamp(mid, max=n_f - 1)] < xi)
            lo = torch.where(right, mid + 1, lo)
            hi = torch.where(open_ & ~right, mid, hi)
        idx = torch.clamp(lo, 1, n_f - 1)
        c_lo = flat[base + idx - 1]
        c_hi = flat[base + idx]
        f_lo = self.frequencies[idx - 1]
        f_hi = self.frequencies[idx]
        frac = (xi - c_lo) / torch.clamp_min(c_hi - c_lo, 1e-12)
        return f_lo + frac * (f_hi - f_lo)

    def sample_h_lyc(self, generator, T):
        return self._sample_tdep(self.h_lyc_cdf, _uniform(generator, T.numel()), T)

    def sample_he_lyc(self, generator, T):
        return self._sample_tdep(self.he_lyc_cdf, _uniform(generator, T.numel()), T)

    def sample_he_2pc(self, generator, n):
        return interp(_uniform(generator, n), self.he_2pc_cdf, self.he_2pc_freqs)


def reemit_batch(generator, spectra: DeviceSpectra, absorbed, sigma_H_pkt, sigma_He_pkt,
                 xH_cell, xHe_cell, T_cell, AHe: float):
    """Vectorized diffuse re-emission of a terminated batch (f32).

    absorbed: [P] bool; sigma_*_pkt: the packets' cross sections at their old
    frequency; xH_cell, xHe_cell, T_cell: neutral fractions and temperature
    of each packet's absorption cell.

    Returns (reemit [P] bool, new_frequency [P] f32, h_channel [P] bool):
    re-emitted packets fly on at the new frequency (the caller draws their
    direction and τ), the others are absorbed for good; ``h_channel`` marks
    hydrogen Lyman-continuum re-emission (the rest are helium channels).
    """
    n = absorbed.shape[0]
    u_species = _uniform(generator, n)
    u_channel = _uniform(generator, n)
    u_sub = _uniform(generator, n)
    u_sub2 = _uniform(generator, n)

    p_H_reemit, (c1, c2, c3, c4) = reemission_probabilities(T_cell)

    wH = xH_cell * sigma_H_pkt
    wHe = xHe_cell * AHe * sigma_He_pkt
    p_H_abs = wH / torch.clamp_min(wH + wHe, 1e-300)
    absorbed_by_H = u_species <= p_H_abs

    # frequencies of every channel, sampled for all packets; masks select
    freq_h_lyc = spectra.sample_h_lyc(generator, T_cell)
    freq_he_lyc = spectra.sample_he_lyc(generator, T_cell)
    freq_he_2pc = spectra.sample_he_2pc(generator, n)

    # hydrogen branch: re-emitted as H LyC with probability p_H_reemit
    h_reemits = absorbed_by_H & (u_channel <= p_H_reemit)

    # helium branch channels (cumulative)
    he = ~absorbed_by_H
    he_lyc = he & (u_channel <= c1)
    he_line = he & (u_channel > c1) & (u_channel <= c2)
    he_tpc = he & (u_channel > c2) & (u_channel <= c3)
    he_lya = he & (u_channel > c3) & (u_channel <= c4)

    # two-photon continuum: 56% of the two photons ionize hydrogen
    he_tpc_emit = he_tpc & (u_sub < 0.56)

    # Lyα: on-the-spot absorption by H (-> the H LyC chain) or conversion
    # to the two-photon continuum
    sqrtTxH = torch.sqrt(T_cell) * xH_cell
    pHots = sqrtTxH / (sqrtTxH + 77.0 * xHe_cell)
    lya_ots = he_lya & (u_sub < pHots)
    lya_ots_emit = lya_ots & (u_sub2 <= p_H_reemit)
    lya_tpc = he_lya & (u_sub >= pHots)
    lya_tpc_emit = lya_tpc & (u_sub2 < 0.56)

    h_channel = h_reemits | lya_ots_emit
    reemit = absorbed & (h_channel | he_lyc | he_line | he_tpc_emit | lya_tpc_emit)
    new_freq = torch.where(
        h_channel, freq_h_lyc,
        torch.where(he_lyc, freq_he_lyc, torch.where(he_line, FREQ_19P8EV, freq_he_2pc)),
    )
    return reemit, new_freq, h_channel
