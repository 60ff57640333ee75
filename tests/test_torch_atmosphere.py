"""The port's tabulated atmosphere spectra against the JAX package's.

Mirrors tests/test_atmosphere_spectra.py: the reference's data tarballs are
not in the repository, so each reader runs on a synthetic table written in
its documented format, with a Planck shape so that the resampled CDF can be
checked against the analytic Planck spectrum.  The same fixture goes through
``cmacionize_tpu/models/atmosphere_spectra.py`` and
``cmacionize_torch/models/atmosphere_spectra.py``; both are host numpy with
the same operations, so frequencies and CDFs agree to the last bits (stated
as rtol 1e-12).  The Castelli-Kurucz reader needs h5py, which this file
imports only inside its tests.
"""

import numpy as np
import pytest
import torch

from cmacionize_torch import constants
from cmacionize_torch.models import atmosphere_spectra as atm
from cmacionize_torch.models import ions, sources
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.models.multifreq_simulation import (
    MultiFreqConfig,
    MultiFreqIonizationSimulation,
)
from cmacionize_torch.utils.params import ParameterFile
from cmacionize_tpu.models import atmosphere_spectra as jatm
from cmacionize_tpu.models.sources import planck_spectrum
from cmacionize_tpu.utils.params import ParameterFile as JaxParameterFile

T_STAR = 40000.0
NU_ION = 3.289e15


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _planck_flambda(lam_m):
    """B_λ(T) (arbitrary scale) for the synthetic tables."""
    h, c, k = constants.PLANCK, constants.LIGHTSPEED, constants.BOLTZMANN
    x = h * c / (lam_m * k * T_STAR)
    return 1.0 / (lam_m ** 5 * np.expm1(np.clip(x, None, 500.0)))


def _assert_planck_cdf(spec, atol=0.02):
    ref = planck_spectrum(T_STAR)
    np.testing.assert_allclose(
        spec.cdf, np.interp(spec.frequencies, ref.frequencies, ref.cdf), atol=atol)


def _assert_same(spec, ref):
    np.testing.assert_array_equal(spec.frequencies, ref.frequencies)
    np.testing.assert_allclose(spec.cdf, ref.cdf, rtol=1e-12, atol=0)


def write_wmbasic_fixture(path):
    """A sed_*.dat table: wavelengths bracketing [ν_ion, 4 ν_ion], an
    Eddington flux of Planck shape."""
    lam_a = np.linspace(150.0, 1100.0, 400)
    e_nu = _planck_flambda(lam_a * 1e-10) * (lam_a * 1e-10) ** 2
    lines = ["WM-basic model atmosphere", "T_eff = 40000 K", "", f"number of: {len(lam_a)}",
             "", "wavelength flux", "(A) (erg)", ""]
    lines += [f"{la:.6e} {e:.6e}" for la, e in zip(lam_a, e_nu)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _write_wavelength_table(path, skiprows):
    lam_a = np.linspace(150.0, 1100.0, 400)
    l_lam = _planck_flambda(lam_a * 1e-10)
    with open(path, "w") as f:
        for _ in range(skiprows):
            f.write("# header\n")
        for la, e in zip(lam_a, l_lam):
            f.write(f"{la:.6e} {e:.6e}\n")


def _write_ck_fixture(path):
    import h5py

    lam = np.geomspace(1.0e-8, 2.0e-7, 300)  # m
    Teff = np.array([30000.0, 40000.0, 50000.0])
    F = np.zeros((len(lam), 3, len(Teff), 3))
    for iT, T in enumerate(Teff):
        x = constants.PLANCK * constants.LIGHTSPEED / (lam * constants.BOLTZMANN * T)
        F[:, :, iT, :] = (1.0 / (lam ** 5 * np.expm1(x)))[:, None, None]
    with h5py.File(path, "w") as f:
        f["lambda"] = lam
        f["Z"] = np.array([0.004, 0.02, 0.04])
        f["Teff"] = Teff
        f["g"] = np.array([100.0, 300.0, 1000.0])
        f["Flambda"] = F


# ------------------------------------------------------------------ WMBasic


def test_wmbasic_log_g_filename_token():
    assert atm._wmbasic_log_g_name(100.0) == "400"
    assert atm._wmbasic_log_g_name(10 ** 3.61 / 100.0) == "360"


def test_wmbasic_reads_and_resamples(tmp_path):
    write_wmbasic_fixture(tmp_path / "sed_40000_400_0020.dat")
    spec, total = atm.wmbasic_spectrum(40000.0, 100.0, str(tmp_path))
    ref, ref_total = jatm.wmbasic_spectrum(40000.0, 100.0, str(tmp_path))
    assert isinstance(spec, sources.TabulatedSpectrum)
    assert total == pytest.approx(ref_total, rel=1e-12) and total > 0.0
    assert spec.frequencies[0] == NU_ION and spec.frequencies[-1] == 4.0 * NU_ION
    assert spec.cdf[0] == 0.0 and spec.cdf[-1] == 1.0
    _assert_same(spec, ref)
    _assert_planck_cdf(spec)


def test_wmbasic_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        atm.wmbasic_spectrum(33000.0, 100.0, str(tmp_path))


# ---------------------------------------------------------- Castelli-Kurucz


def test_castelli_kurucz_node_and_between_nodes(tmp_path):
    pytest.importorskip("h5py")
    fname = str(tmp_path / "ck.hdf5")
    _write_ck_fixture(fname)
    spec = atm.castelli_kurucz_spectrum(40000.0, 300.0, 0.02, fname)
    _assert_same(spec, jatm.castelli_kurucz_spectrum(40000.0, 300.0, 0.02, fname))
    _assert_planck_cdf(spec)
    mid = atm.castelli_kurucz_spectrum(35000.0, 200.0, 0.01, fname)
    _assert_same(mid, jatm.castelli_kurucz_spectrum(35000.0, 200.0, 0.01, fname))
    assert mid.cdf[0] == 0.0 and mid.cdf[-1] == 1.0 and np.all(np.diff(mid.cdf) >= 0)
    with pytest.raises(ValueError, match="outside tabulated range"):
        atm.castelli_kurucz_spectrum(99000.0, 300.0, 0.02, fname)


# ------------------------------------------------------- Pegase3, PopStar


def test_pegase3_index_lookup(tmp_path):
    (tmp_path / "pegase_chab.all").write_text(
        "spec_1 1000000.0 0.02\nspec_2 2000000.0 0.02\nspec_3 1000000.0 0.05\n")
    _write_wavelength_table(tmp_path / "spec_2", skiprows=2)
    spec = atm.pegase3_spectrum(2.0e6, 0.02, str(tmp_path))
    _assert_same(spec, jatm.pegase3_spectrum(2.0e6, 0.02, str(tmp_path)))
    _assert_planck_cdf(spec)
    with pytest.raises(ValueError, match="valid ages"):
        atm.pegase3_spectrum(5.0e6, 0.02, str(tmp_path))


def test_popstar_filename_convention(tmp_path):
    _write_wavelength_table(tmp_path / "spneb_cha_0.15_100_z0080_t6.50", skiprows=0)
    spec = atm.popstar_spectrum(6.5, 0.008, str(tmp_path))
    _assert_same(spec, jatm.popstar_spectrum(6.5, 0.008, str(tmp_path)))
    _assert_planck_cdf(spec)


# ------------------------------------------------------------------ factory


@pytest.mark.parametrize("kind", ["WMBasic", "PopStar"])
def test_factory_dispatch(tmp_path, kind):
    if kind == "WMBasic":
        write_wmbasic_fixture(tmp_path / "sed_40000_400_0020.dat")
        extra = "  temperature: 40000. K\n  surface gravity: 100. m s^-2\n"
    else:
        _write_wavelength_table(tmp_path / "spneb_cha_0.15_100_z0200_t6.00", skiprows=0)
        extra = "  log age: 6.0\n  metallicity: 0.02\n"
    yml = tmp_path / "p.yml"
    yml.write_text(f"PhotonSourceSpectrum:\n  type: {kind}\n  data location: {tmp_path}\n"
                   + extra)
    spec = atm.atmosphere_spectrum_from_params(ParameterFile(str(yml)))
    _assert_same(spec, jatm.atmosphere_spectrum_from_params(JaxParameterFile(str(yml))))
    _assert_planck_cdf(spec)


def test_factory_rejects_unknown_type():
    params = ParameterFile({"PhotonSourceSpectrum": {"type": "Kurucz"}})
    with pytest.raises(ValueError, match="unknown tabulated spectrum"):
        atm.atmosphere_spectrum_from_params(params)


def test_sampling_draws_in_band():
    """TabulatedSpectrum.sample with a torch.Generator: in band, and
    distributed as the table (a uniform CDF gives uniform frequencies)."""
    nu = np.linspace(NU_ION, 4 * NU_ION, 100)
    spec = sources.TabulatedSpectrum(frequencies=nu, cdf=np.linspace(0.0, 1.0, 100))
    gen = torch.Generator().manual_seed(0)
    s = spec.sample(gen, 20000).double().numpy()
    assert ((s >= NU_ION * (1 - 1e-6)) & (s <= 4 * NU_ION * (1 + 1e-6))).all()
    assert abs(s.mean() / (2.5 * NU_ION) - 1.0) < 0.01


def test_interp_matches_numpy():
    rng = np.random.default_rng(1)
    xp = np.sort(np.concatenate([rng.uniform(0, 1, 50), [0.3, 0.3]]))
    fp = np.cumsum(rng.uniform(0, 1, xp.size))
    x = rng.uniform(-0.1, 1.1, 1000)
    got = sources.interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp)).numpy()
    np.testing.assert_allclose(got, np.interp(x, xp, fp), rtol=1e-12, atol=1e-12)


# ------------------------------------------------- the multi-frequency driver


def test_tabulated_spectrum_feeds_the_bin_pdf():
    """A tabulated spectrum plugged into the driver: the per-bin weights are
    the CDF increments across the bins (the JAX driver's, :421-426), and
    the packets' bins follow them."""
    from cmacionize_tpu.models import multifreq_simulation as jmf
    from cmacionize_tpu.models.grid import GridGeometry as JaxGridGeometry

    pc = 3.086e16
    nu = np.linspace(NU_ION, 4 * NU_ION, 200)
    cdf = ((nu - nu[0]) / (nu[-1] - nu[0])) ** 2
    kwargs = dict(
        number_density=1e8, initial_temperature=8000.0, source_position=(0.0, 0.0, 0.0),
        luminosity=1e49, spectrum_type="wmbasic", spectrum_temperature=40000.0,
        spectrum_frequency=3.3e15, n_photons=1000, n_iterations=1,
        abundances=dict(ions.DEFAULT_ABUNDANCES), do_temperature=False, n_bins=32,
        n_reemission_rounds=1, spectrum_table=(nu, cdf))
    box = dict(anchor=(-1.5 * pc,) * 3, sides=(3 * pc,) * 3, shape=(8, 8, 8))
    sim = MultiFreqIonizationSimulation(
        MultiFreqConfig(geometry=GridGeometry(**box), **kwargs), "cpu", seed=0)
    jsim = jmf.MultiFreqIonizationSimulation(
        jmf.MultiFreqConfig(geometry=JaxGridGeometry(**box), **kwargs), seed=0)
    assert sim.spectrum_cdf[0] == 0.0
    np.testing.assert_allclose(sim.spectrum_cdf[-1], 1.0, rtol=1e-12)
    np.testing.assert_allclose(sim.spectrum_cdf, jsim.spectrum_cdf, rtol=1e-12, atol=1e-15)
    fbin = sources.sample_bins(torch.Generator().manual_seed(1), 200000,
                               torch.tensor(sim.spectrum_cdf, dtype=torch.float32))
    share = np.bincount(fbin.numpy(), minlength=32) / 200000
    np.testing.assert_allclose(share, np.diff(sim.spectrum_cdf), atol=3e-3)
