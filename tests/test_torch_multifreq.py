"""The port's multi-frequency driver end to end on the CPU.

``cmacionize_torch.models.multifreq_simulation`` runs the plain versions of
K2 and K4 here.  Its random stream cannot reproduce jax.random, so whole runs
are held to the published Lexington bands and to the JAX package's run within
Monte Carlo noise; the configuration reader and a state carried over from the
JAX simulation are held to the JAX package exactly or per cell.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from cmacionize_torch.models import ions
from cmacionize_torch.models.density_functions import density_function_from_params
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.models.ionization_simulation import (
    HOnlyConfig,
    HOnlyIonizationSimulation,
)
from cmacionize_torch.models.multifreq_simulation import (
    MultiFreqConfig,
    MultiFreqIonizationSimulation,
)
from cmacionize_torch.ops import cross_sections, recombination
from cmacionize_torch.utils.params import ParameterFile
from cmacionize_tpu.models import multifreq_simulation as jmf
from cmacionize_tpu.models.grid import GridGeometry as JaxGridGeometry
from cmacionize_tpu.utils.params import ParameterFile as JaxParameterFile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "benchmarks")
PC = 3.086e16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ configuration


@pytest.mark.parametrize(
    "name", ["lexingtonHII20.param", "lexingtonHII40.param", "stromgren_diffuse.param"])
def test_from_params_matches_jax(name):
    path = os.path.join(BENCH_DIR, name)
    got = MultiFreqConfig.from_params(ParameterFile(path))
    ref = jmf.MultiFreqConfig.from_params(JaxParameterFile(path))
    # the JAX-only fields hold what the port supports
    assert ref.temperature_backend == "f64-host" and ref.spectrum_table is None
    for field in dataclasses.fields(got):
        value, expected = getattr(got, field.name), getattr(ref, field.name)
        if field.name == "geometry":
            value, expected = dataclasses.astuple(value), dataclasses.astuple(expected)
        assert value == expected, field.name
    assert isinstance(got.n_photons, int) and isinstance(got.geometry.shape[0], int)


DEFERRED = {
    "trackers": ("TrackerManager", "filename", "trackers.yml"),
    "parallel": ("Parallel", "number of devices", 4),
    "restart": ("RestartManager", "output folder", "restart"),
}


@pytest.mark.parametrize("block, key, value", DEFERRED.values(), ids=DEFERRED.keys())
def test_from_params_raises_for_what_is_deferred(block, key, value):
    params = ParameterFile(os.path.join(BENCH_DIR, "lexingtonHII20.param"))
    params._tree.setdefault(block, {})[key] = value
    with pytest.raises(NotImplementedError):
        MultiFreqConfig.from_params(params)


@pytest.mark.parametrize("backend", ["f32-device", "f64-host", "gpu-magic"])
def test_from_params_reads_the_temperature_backend(backend):
    """The backend string is read as the JAX package reads it; only
    "f32-device" selects the f32 solve (see test_unknown_backend_runs_f64)."""
    params = ParameterFile(os.path.join(BENCH_DIR, "lexingtonHII20.param"))
    params._tree.setdefault("TemperatureCalculator", {})["backend"] = backend
    jparams = JaxParameterFile(os.path.join(BENCH_DIR, "lexingtonHII20.param"))
    jparams._tree.setdefault("TemperatureCalculator", {})["backend"] = backend
    got = MultiFreqConfig.from_params(params)
    assert got.temperature_backend == backend
    assert jmf.MultiFreqConfig.from_params(jparams).temperature_backend == backend


def test_from_params_reads_a_tabulated_atmosphere(tmp_path):
    """``PhotonSourceSpectrum: type: WMBasic`` on a synthetic table (the
    format of tests/test_atmosphere_spectra.py): the same table as JAX's."""
    from test_torch_atmosphere import write_wmbasic_fixture

    write_wmbasic_fixture(tmp_path / "sed_40000_400_0020.dat")
    trees = []
    for reader in (ParameterFile, JaxParameterFile):
        params = reader(os.path.join(BENCH_DIR, "lexingtonHII20.param"))
        params._tree["PhotonSourceSpectrum"] = {
            "type": "WMBasic", "data location": str(tmp_path), "temperature": "40000. K",
            "surface gravity": "100. m s^-2"}
        trees.append(params)
    got = MultiFreqConfig.from_params(trees[0])
    ref = jmf.MultiFreqConfig.from_params(trees[1])
    assert got.spectrum_type == "wmbasic"
    np.testing.assert_array_equal(got.spectrum_table[0], ref.spectrum_table[0])
    np.testing.assert_allclose(got.spectrum_table[1], ref.spectrum_table[1], rtol=1e-12, atol=0)


def _cell_state_inputs(n=512, seed=31):
    rng = np.random.default_rng(seed)
    jH = 10.0 ** rng.uniform(-13, -7, n)
    j = {name: torch.tensor(jH * (1.0 if name == "H_n" else 0.3)) for name in ions.ION_NAMES}
    h = (torch.tensor(jH * 4e-19), torch.tensor(jH * 2e-19))
    nd = torch.tensor(np.where(np.arange(n) < 16, 0.0, 1e8))
    return j, h, nd, torch.full((n,), 8000.0, dtype=torch.float64)


def test_unknown_backend_runs_f64():
    """As in the JAX package, any backend string but "f32-device" runs the
    f64 solve: identical results to "f64-host"; "f32-device" runs the f32
    solve and hands back f64 fields that track it."""
    from cmacionize_torch.models.multifreq_simulation import solve_cell_state

    j, h, nd, T = _cell_state_inputs()
    abund = dict(ions.DEFAULT_ABUNDANCES)
    ref_T, ref_x, ref_sweeps = solve_cell_state(j, h, nd, T, abund, True)
    T2, x2, sweeps2 = solve_cell_state(j, h, nd, T, abund, True, backend="gpu-magic")
    assert torch.equal(T2, ref_T) and torch.equal(sweeps2, ref_sweeps)
    for name in ions.ION_NAMES:
        assert torch.equal(x2[name], ref_x[name]), name
    T3, x3, _ = solve_cell_state(j, h, nd, T, abund, True, backend="f32-device")
    assert T3.dtype == torch.float64 and x3["O_n"].dtype == torch.float64
    assert not torch.equal(T3, ref_T)
    rel = ((T3 - ref_T).abs() / ref_T)[16:]
    assert float(rel.median()) < 3e-3
    assert bool((T3[:16] == 500.0).all()) and bool((x3["H_n"][:16] == 1.0).all())


def test_fixed_alpha_ignores_the_backend():
    """With FixedValue recombination rates the f32 backend is not taken
    (cmacionize_tpu/models/multifreq_simulation.py:107): the f64 solve."""
    from cmacionize_torch.models.multifreq_simulation import solve_cell_state

    j, h, nd, T = _cell_state_inputs()
    abund = dict(ions.DEFAULT_ABUNDANCES)
    fixed = (("H_n", 2.7e-19), ("He_n", 4.3e-19))
    ref = solve_cell_state(j, h, nd, T, abund, True, fixed_alpha=fixed)
    got = solve_cell_state(j, h, nd, T, abund, True, fixed_alpha=fixed, backend="f32-device")
    assert torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2])
    assert got[0].dtype == torch.float64
    for name in ions.ION_NAMES:
        assert torch.equal(got[1][name], ref[1][name]), name


# ------------------------------------------------------- Lexington HII20


@pytest.fixture(scope="module")
def hii20():
    """tests/test_lexington.py's run on the port: lexingtonHII20.param at 16³,
    5e4 packets, 8 iterations, 64 bins, 4 re-emission generations, seed 11,
    through the entry point (BlockSyntax cavity, its initial temperature)."""
    prev = os.getcwd()
    os.chdir(BENCH_DIR)
    try:
        params = ParameterFile("lexingtonHII20.param")
        config = MultiFreqConfig.from_params(params)
        config = dataclasses.replace(
            config, geometry=dataclasses.replace(config.geometry, shape=(16, 16, 16)),
            n_photons=50000, n_iterations=8, n_bins=64, n_reemission_rounds=4)
        df = density_function_from_params(params, config.geometry)
    finally:
        os.chdir(prev)
    sim = MultiFreqIonizationSimulation(
        config, density=df.number_density, initial_temperature=df.temperature,
        seed=11, device="cpu")
    xion, T = sim.run()
    r = np.sqrt((config.geometry.cell_centers() ** 2).sum(-1))
    return sim, {
        "r": r, "T": T.numpy(), "nd": df.number_density,
        **{name: value.numpy() for name, value in xion.items()},
    }


def _shell(res, r_lo, r_hi):
    return (res["r"] > r_lo * PC) & (res["r"] < r_hi * PC) & (res["nd"] > 0)


def test_hii20_interior_temperature_band(hii20):
    _, res = hii20
    assert 6000.0 < float(res["T"][_shell(res, 1.0, 2.0)].mean()) < 8300.0


def test_hii20_hydrogen_highly_ionized_through_2p5_pc(hii20):
    _, res = hii20
    assert float(np.median(res["H_n"][_shell(res, 1.0, 2.5)])) < 3e-3


def test_hii20_helium_front_inside_hydrogen_front(hii20):
    _, res = hii20
    assert (res["He_n"] < 0.5).sum() <= 1.05 * (res["H_n"] < 0.5).sum()


def test_hii20_oxygen_singly_ionized_zone(hii20):
    _, res = hii20
    sel = _shell(res, 1.0, 2.0)
    # slot "O_n" holds the O+ fraction, "O_p1" the O++ fraction
    assert float(np.median(res["O_n"][sel])) > 0.9
    assert float(np.median(res["O_p1"][sel])) < 0.1


def test_hii20_cavity_carries_no_density(hii20):
    _, res = hii20
    inside = res["r"] < 0.8 * 3.0e16
    assert (res["nd"][inside] == 0).all()
    assert (res["T"][inside] == 500.0).all() and (res["H_n"][inside] == 1.0).all()


def test_hii20_driver_records(hii20):
    sim, _ = hii20
    assert sim.iteration == 8 and len(sim.phase_seconds) == 8
    # the temperature balance runs from iteration 3 (loop index) on
    assert len(sim.sweeps) == 8 - sim.config.minimum_iteration_number
    assert all(int(s.max()) <= 100 and int(s.min()) >= 1 for s in sim.sweeps)
    counts = [r.tolist() for r in sim.reemitted]
    assert all(len(c) == 4 for c in counts)
    # each generation re-emits fewer packets than the one before
    assert all(c[0] > c[1] > c[2] > c[3] for c in counts[1:])


# ------------------------------------------------ side by side with the JAX run


def _mini_kwargs():
    """tests/test_multifreq.py's configuration."""
    return dict(
        number_density=1e8, initial_temperature=8000.0, source_position=(0.0, 0.0, 0.0),
        luminosity=1e49, spectrum_type="planck", spectrum_temperature=40000.0,
        spectrum_frequency=3.3e15, n_photons=20000, n_iterations=6,
        abundances=dict(ions.DEFAULT_ABUNDANCES), do_temperature=True,
        minimum_iteration_number=2, diffuse_field=True, n_bins=64, n_reemission_rounds=3,
    )


BOX = dict(anchor=(-1.5 * PC,) * 3, sides=(3 * PC,) * 3, shape=(16, 16, 16))


@pytest.fixture(scope="module")
def side_by_side():
    jsim = jmf.MultiFreqIonizationSimulation(
        jmf.MultiFreqConfig(geometry=JaxGridGeometry(**BOX), **_mini_kwargs()), seed=3)
    jxion, jT = jsim.run()
    psim = MultiFreqIonizationSimulation(
        MultiFreqConfig(geometry=GridGeometry(**BOX), **_mini_kwargs()), "cpu", seed=3)
    pxion, pT = psim.run()
    return (jsim, np.asarray(jxion["H_n"]), np.asarray(jxion["He_n"]), np.asarray(jT),
            psim, pxion["H_n"].numpy(), pxion["He_n"].numpy(), pT.numpy())


def test_side_by_side_with_jax(side_by_side):
    """Ionized volumes within 10% and the mean T of the ionized cells within
    3% (independent random streams)."""
    _, jxH, jxHe, jT, _, pxH, pxHe, pT = side_by_side
    for j, p in ((jxH, pxH), (jxHe, pxHe)):
        assert (p < 0.5).sum() == pytest.approx((j < 0.5).sum(), rel=0.10)
    assert pT[pxH < 0.5].mean() == pytest.approx(jT[jxH < 0.5].mean(), rel=0.03)
    assert pxH[8, 8, 8] < 0.1 and 5000.0 < pT[8, 8, 8] < 25000.0


def test_load_reference_state_continues_the_jax_state(side_by_side):
    """The JAX state carried into the port: the next solve, on the same
    integrals, gives JAX's T and ionization state per cell (the tolerances of
    test_torch_temperature.py's solve)."""
    jsim, _, _, _, psim, _, _, _ = side_by_side
    integrals, _ = psim._mc_shoot(
        torch.clamp(psim.xion["H_n"], 0, 1), torch.clamp(psim.xion["He_n"], 0, 1),
        psim.temperature)
    ref_T, ref_xion, _ = jsim._solve_state(np.asarray(integrals.numpy()), True)
    psim.load_reference_state(
        {name: np.asarray(v) for name, v in jsim.xion.items()},
        np.asarray(jsim.temperature), np.asarray(jsim.number_density))
    for name in ions.ION_NAMES:
        np.testing.assert_array_equal(psim.xion[name].numpy(), np.asarray(jsim.xion[name]))
    T, xion, _, sweeps = psim._solve_state(integrals, True)
    ref_T = np.asarray(ref_T)
    rel = np.abs(T.numpy() - ref_T) / ref_T
    assert np.mean(rel <= 1e-8) >= 0.95 and rel.max() <= 5e-3, (np.mean(rel <= 1e-8), rel.max())
    for name in ions.ION_NAMES:
        np.testing.assert_allclose(xion[name].numpy(), np.asarray(ref_xion[name]),
                                   rtol=1e-5, atol=1e-9, err_msg=name)
    assert sweeps.shape == (16, 16, 16)
    with pytest.raises(ValueError):
        psim.load_reference_state(
            {name: np.zeros((8, 8, 8)) for name in ions.ION_NAMES},
            np.zeros((8, 8, 8)), np.zeros((8, 8, 8)))


# ---------------------------------------------------------- monochromatic


def test_monochromatic_matches_h_only_driver():
    """tests/test_multifreq.py:61 on the port: a 13.6 eV line, no He, no
    temperature balance, no re-emission: the multi-frequency driver finds
    the H-only driver's ionized volume within 20%."""
    abund = dict(ions.DEFAULT_ABUNDANCES, He=0.0)
    kwargs = dict(_mini_kwargs(), spectrum_type="monochromatic", abundances=abund,
                  do_temperature=False, diffuse_field=False, luminosity=2e49)
    config = MultiFreqConfig(geometry=GridGeometry(**BOX), **kwargs)
    sim = MultiFreqIonizationSimulation(config, "cpu", seed=11)
    xion, T = sim.run()
    assert sim.sweeps == [] and bool((T == 8000.0).all())
    sigma = float(cross_sections.ion_cross_section("H_n", np.asarray([sim.bin_centers[0]]))[0])
    h_only = HOnlyIonizationSimulation(
        HOnlyConfig(
            geometry=config.geometry, number_density=config.number_density,
            temperature=config.initial_temperature, source_position=config.source_position,
            luminosity=config.luminosity, cross_section=sigma,
            recombination_rate=float(recombination.recombination_rate("H_n", 8000.0)),
            n_photons=config.n_photons, n_iterations=config.n_iterations,
        ),
        "cpu", seed=11,
    )
    xH_ref = h_only.run().numpy()
    v1 = (xion["H_n"].numpy() < 0.5).sum()
    assert v1 == pytest.approx((xH_ref < 0.5).sum(), rel=0.2)
    assert v1 > 0


# ------------------------------------------------------ stromgren_diffuse


def _diffuse_volume(diffuse):
    """tests/test_stromgren_diffuse.py's run on the port: the ionized volume
    Σ (1 - x_H) V of a 13.6 eV source at 16³, 5e4 packets × 8 iterations."""
    box = 10.0 * PC
    config = MultiFreqConfig(
        geometry=GridGeometry((-box / 2,) * 3, (box,) * 3, (16, 16, 16)),
        number_density=1.0e8, initial_temperature=8000.0, source_position=(0.0, 0.0, 0.0),
        luminosity=4.26e49, spectrum_type="monochromatic", spectrum_temperature=40000.0,
        spectrum_frequency=3.2899e15, n_photons=50000, n_iterations=8,
        abundances=dict(ions.DEFAULT_ABUNDANCES), do_temperature=False,
        diffuse_field=diffuse, n_bins=64, n_reemission_rounds=6 if diffuse else 0,
    )
    sim = MultiFreqIonizationSimulation(config, "cpu", seed=5)
    xion, _ = sim.run()
    return float(((1.0 - xion["H_n"].numpy()) * config.geometry.cell_volume).sum())


def test_diffuse_field_between_case_a_and_case_b():
    """With re-emission the ionized volume grows from the case-A toward the
    case-B Strömgren volume (α_B = 0.62 α_A at 8000 K), as in the JAX test."""
    alpha_a = float(recombination.recombination_rate("H_n", 8000.0))
    v_case_a = 4.26e49 / (alpha_a * 1e16)
    v_case_b = v_case_a / 0.62
    v_off, v_on = _diffuse_volume(False), _diffuse_volume(True)
    assert v_off == pytest.approx(v_case_a, rel=0.2)
    assert 1.2 * v_off < v_on < 1.7 * v_off
    assert v_on == pytest.approx(v_case_b, rel=0.2)
