"""Tabulated stellar-atmosphere photon source spectra (host numpy).

Port of ``cmacionize_tpu/models/atmosphere_spectra.py``: readers +
ionizing-range resampling for the four tabulated spectrum families
the reference supports (its src/PhotonSourceSpectrumFactory.hpp):

* WMBasic O-star grids        (WMBasicPhotonSourceSpectrum.cpp)
* Castelli-Kurucz atmospheres (CastelliKuruczPhotonSourceSpectrum.cpp, HDF5)
* Pegase 3 SSP models         (Pegase3PhotonSourceSpectrum.cpp)
* PopStar SSP models          (PopStarPhotonSourceSpectrum.cpp)

All four share the reference's pipeline: read the native table, convert
wavelength (Angstrom / m) to frequency, resample onto the 1000-bin linear
ionizing frequency grid [nu_HI, 4 nu_HI] with the trapezoid-in-photon-number
bin weights ``0.5 (e1/nu2 + e2/nu1) (nu2 - nu1)``, accumulate into a
cumulative distribution for inverse-CDF sampling, and keep the total
ionizing flux.  The sampled output plugs into
``cmacionize_torch.models.sources.TabulatedSpectrum`` and, through its CDF,
into the multi-frequency driver's per-bin weights.

The actual data tarballs (sed_*.dat, pegase_chab.all, spneb_cha_*,
CastelliKuruczData.hdf5) are fetched at configure time by the reference's
build and are not redistributed here; the readers accept any directory and
are unit-tested against synthetic fixtures in the documented formats.
The Castelli-Kurucz reader imports ``h5py`` only when it is called.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from cmacionize_torch import constants
from cmacionize_torch.models.sources import TabulatedSpectrum

__all__ = [
    "wmbasic_spectrum",
    "castelli_kurucz_spectrum",
    "pegase3_spectrum",
    "popstar_spectrum",
    "atmosphere_spectrum_from_params",
]

#: 13.6 eV in Hz — the reference hard-codes 3.289e15
#: (WMBasicPhotonSourceSpectrum.cpp:105).
_NU_ION = 3.289e15
_NUM_FREQ = 1000


def _resample_ionizing(
    file_nu: np.ndarray, file_e: np.ndarray, num_freq: int = _NUM_FREQ
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Resample (nu, e_nu) onto the ionizing grid; return (nu, cdf, total).

    Implements the bin weights of WMBasicPhotonSourceSpectrum.cpp:114-133:
    linear interpolation of the tabulated e_nu at both bin edges, weight
    ``0.5 (e1/nu2 + e2/nu1) (nu2 - nu1)`` (photon-number trapezoid), then a
    running sum.  ``total`` is the unnormalized last element, in the units
    of ``file_e``·Hz/ν.
    """
    order = np.argsort(file_nu)
    file_nu = np.asarray(file_nu, np.float64)[order]
    file_e = np.asarray(file_e, np.float64)[order]
    nu = np.linspace(_NU_ION, 4.0 * _NU_ION, num_freq)
    e = np.interp(nu, file_nu, file_e)
    weights = 0.5 * (e[:-1] / nu[1:] + e[1:] / nu[:-1]) * np.diff(nu)
    cdf = np.concatenate([[0.0], np.cumsum(weights)])
    total = float(cdf[-1])
    if total <= 0.0:
        raise ValueError("spectrum has no ionizing flux in [nu_HI, 4 nu_HI]")
    return nu, cdf / total, total


def _wavelength_table_to_nu(
    wavelength_angstrom: np.ndarray, flux_per_wavelength: np.ndarray
):
    """(λ[Å], F_λ) → (ν[Hz], F_ν) with the reference's λ²-in-Å convention
    (Pegase3PhotonSourceSpectrum.cpp:158-165)."""
    lam = np.asarray(wavelength_angstrom, np.float64)
    nu = constants.LIGHTSPEED * 1.0e10 / lam
    return nu, np.asarray(flux_per_wavelength, np.float64) * lam * lam


# ---------------------------------------------------------------------------
# WMBasic
# ---------------------------------------------------------------------------


def _wmbasic_log_g_name(surface_gravity: float) -> str:
    """m s^-2 → the '<100·log10(g_cgs) rounded to 20>' filename token
    (WMBasicPhotonSourceSpectrum.cpp:200-207)."""
    log_g = np.log10(surface_gravity * 100.0)
    return str(int(round(log_g * 5.0) * 20))


def read_wmbasic_file(path: str):
    """Parse one sed_*.dat table: 3 header lines, a count line, 4 more
    header lines, then (wavelength[Å], eddington flux) rows
    (WMBasicPhotonSourceSpectrum.cpp:64-97)."""
    with open(path) as f:
        lines = f.read().splitlines()
    num = int(lines[3].split()[2])
    rows = [ln.split() for ln in lines[8:8 + num]]
    lam = np.array([float(r[0]) for r in rows])
    edd = np.array([float(r[1]) for r in rows])
    nu = constants.LIGHTSPEED * 1.0e10 / lam
    return nu, edd


def wmbasic_spectrum(
    temperature: float,
    surface_gravity: float,
    data_location: str,
) -> Tuple[TabulatedSpectrum, float]:
    """WMBasic O-star spectrum; returns (spectrum, total ionizing flux).

    Flux in photons m^-2 s^-1, integrated over solid angle — the erg→J,
    cm^-2→m^-2, /h, ×4π chain of WMBasicPhotonSourceSpectrum.cpp:137-151.
    """
    fname = os.path.join(
        data_location,
        f"sed_{temperature:g}_{_wmbasic_log_g_name(surface_gravity)}"
        "_0020.dat",
    )
    nu_t, edd = read_wmbasic_file(fname)
    nu, cdf, total = _resample_ionizing(nu_t, edd)
    total_flux = 1.0e-7 * total / constants.PLANCK * 4.0 * np.pi * 1.0e4
    return TabulatedSpectrum(frequencies=nu, cdf=cdf), total_flux


# ---------------------------------------------------------------------------
# Castelli-Kurucz
# ---------------------------------------------------------------------------


def castelli_kurucz_spectrum(
    temperature: float,
    surface_gravity: float,
    metallicity: float,
    data_file: str,
) -> TabulatedSpectrum:
    """Quadri-linearly (log-space) interpolated Castelli-Kurucz atmosphere.

    The HDF5 layout (CastelliKuruczPhotonSourceSpectrum.cpp:147-158):
    datasets ``lambda [nl]`` (m), ``Z [nZ]``, ``Teff [nT]`` (K), ``g [ng]``
    (m s^-2), ``Flambda [nl, nZ, nT, ng]``.  Interpolation is linear in the
    logs of Z/Teff/g/λ; F_λ is converted to photon-number weight by λ/ν
    (:247-252).
    """
    import h5py

    with h5py.File(data_file, "r") as f:
        lam = np.asarray(f["lambda"])
        Z = np.asarray(f["Z"])
        Teff = np.asarray(f["Teff"])
        g = np.asarray(f["g"])
        Flam = np.asarray(f["Flambda"])

    def _bracket(val, arr, name):
        if not (arr[0] <= val <= arr[-1]):
            raise ValueError(
                f"{name}={val} outside tabulated range [{arr[0]}, {arr[-1]}]")
        i = int(np.clip(np.searchsorted(arr, val) - 1, 0, len(arr) - 2))
        f = (np.log(val) - np.log(arr[i])) / (
            np.log(arr[i + 1]) - np.log(arr[i]))
        return i, f

    iZ, fZ = _bracket(metallicity, Z, "Z")
    iT, fT = _bracket(temperature, Teff, "Teff")
    ig, fg = _bracket(surface_gravity, g, "g")

    nu = np.linspace(_NU_ION, 4.0 * _NU_ION, _NUM_FREQ)
    lam_q = constants.LIGHTSPEED / nu  # m, descending
    il = np.clip(np.searchsorted(lam, lam_q) - 1, 0, len(lam) - 2)
    fl = (np.log(lam_q) - np.log(lam[il])) / (
        np.log(lam[il + 1]) - np.log(lam[il]))

    # 16-corner log-space-fraction interpolation (cpp:48-100)
    F = np.zeros(_NUM_FREQ)
    for dZ in (0, 1):
        for dT in (0, 1):
            for dg in (0, 1):
                for dl in (0, 1):
                    w = (
                        (fZ if dZ else 1.0 - fZ)
                        * (fT if dT else 1.0 - fT)
                        * (fg if dg else 1.0 - fg)
                        * (fl if dl else 1.0 - fl)
                    )
                    F += w * Flam[il + dl, iZ + dZ, iT + dT, ig + dg]
    e_nu = F * lam_q / nu  # F_λ → per-frequency weight (cpp:249-252)
    weights = 0.5 * (e_nu[:-1] / nu[1:] + e_nu[1:] / nu[:-1]) * np.diff(nu)
    cdf = np.concatenate([[0.0], np.cumsum(weights)])
    if cdf[-1] <= 0.0:
        raise ValueError("spectrum has no ionizing flux in [nu_HI, 4 nu_HI]")
    return TabulatedSpectrum(frequencies=nu, cdf=cdf / cdf[-1])


# ---------------------------------------------------------------------------
# Pegase 3
# ---------------------------------------------------------------------------


def pegase3_spectrum(
    age_in_yr: float, metallicity: float, data_location: str
) -> TabulatedSpectrum:
    """Pegase 3 SSP spectrum for an exact (age, Z) table entry.

    ``pegase_chab.all`` is the index: one ``name age metallicity`` row per
    table (Pegase3PhotonSourceSpectrum.cpp:50-125); each table has two
    comment lines then (wavelength[Å], L_λ) rows.
    """
    index = os.path.join(data_location, "pegase_chab.all")
    names, ages, zs = [], [], []
    with open(index) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                names.append(parts[0])
                ages.append(float(parts[1]))
                zs.append(float(parts[2]))
    ages_arr = np.asarray(ages)
    zs_arr = np.asarray(zs)
    match = np.nonzero((ages_arr == age_in_yr) & (zs_arr == metallicity))[0]
    if len(match) == 0:
        raise ValueError(
            f"no Pegase3 table for age={age_in_yr} yr Z={metallicity}; "
            f"valid ages: {sorted(set(ages))}, "
            f"valid metallicities: {sorted(set(zs))}")
    fname = os.path.join(data_location, names[int(match[0])])
    data = np.loadtxt(fname, skiprows=2)
    nu_t, e_t = _wavelength_table_to_nu(data[:, 0], data[:, 1])
    nu, cdf, _ = _resample_ionizing(nu_t, e_t)
    return TabulatedSpectrum(frequencies=nu, cdf=cdf)


# ---------------------------------------------------------------------------
# PopStar
# ---------------------------------------------------------------------------


def popstar_spectrum(
    log_age_in_yr: float, metallicity: float, data_location: str
) -> TabulatedSpectrum:
    """PopStar SSP spectrum (Chabrier IMF, 0.15-100 Msol).

    Filename ``spneb_cha_0.15_100_z<Z*1e4, 4 digits>_t<log age, 2 decimals>``
    (PopStarPhotonSourceSpectrum.cpp:50-58); headerless
    (wavelength[Å], L_λ) rows.
    """
    fname = os.path.join(
        data_location,
        f"spneb_cha_0.15_100_z{int(metallicity * 1e4):04d}"
        f"_t{log_age_in_yr:.2f}",
    )
    data = np.loadtxt(fname)
    nu_t, e_t = _wavelength_table_to_nu(data[:, 0], data[:, 1])
    nu, cdf, _ = _resample_ionizing(nu_t, e_t)
    return TabulatedSpectrum(frequencies=nu, cdf=cdf)


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------


def atmosphere_spectrum_from_params(params, prefix="PhotonSourceSpectrum"):
    """Dispatch over the tabulated type strings of
    PhotonSourceSpectrumFactory.hpp:99-112.  Returns a TabulatedSpectrum.

    The data directory comes from ``<prefix>:data location`` (our addition:
    the reference bakes the paths in at configure time, which an installed
    package cannot)."""
    stype = params.get_string(f"{prefix}:type")
    loc = params.get_string(f"{prefix}:data location", ".")
    if stype == "WMBasic":
        spectrum, _ = wmbasic_spectrum(
            params.get_physical_value(
                f"{prefix}:temperature", "temperature", "40000. K"),
            params.get_physical_value(
                f"{prefix}:surface gravity", "acceleration", "25. m s^-2"),
            loc,
        )
        return spectrum
    if stype == "CastelliKurucz":
        return castelli_kurucz_spectrum(
            params.get_physical_value(
                f"{prefix}:temperature", "temperature", "40000. K"),
            params.get_physical_value(
                f"{prefix}:surface gravity", "acceleration", "317. m s^-2"),
            params.get_number(f"{prefix}:metallicity", 0.02),
            loc,
        )
    if stype == "Pegase3":
        return pegase3_spectrum(
            params.get_number(f"{prefix}:age", 1.0e6),
            params.get_number(f"{prefix}:metallicity", 0.02),
            loc,
        )
    if stype == "PopStar":
        return popstar_spectrum(
            params.get_number(f"{prefix}:log age", 6.0),
            params.get_number(f"{prefix}:metallicity", 0.02),
            loc,
        )
    raise ValueError(f"unknown tabulated spectrum type '{stype}'")
