"""cmacionize_torch's dust-scattering RT against the JAX package's, on the CPU.

The port's driver and peel-off on CPU tensors run their plain PyTorch
versions (``ops/peel_off.py``); the same numpy inputs, and the same uniform
draws where a function samples, go through ``cmacionize_tpu``'s functions.
The JAX side runs with ``jax_enable_x64`` off, as the production CLI does
(under x64 its ``_ccd_pixel`` computes in f64).  The first tests mirror
tests/test_dust.py on the port.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch.models import dust_simulation as dust
from cmacionize_torch.models.dusty_galaxy import image_measures
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.ops import peel_off
from cmacionize_torch.utils.params import ParameterFile
from cmacionize_tpu.models import dust_simulation as jax_dust
from cmacionize_tpu.models.grid import GridGeometry as JaxGridGeometry

KPC = dust.KPC


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _galaxy(shape=(32, 32, 32), n_photons=64, **kw):
    """The dusty_galaxy disc (n0 1 cm^-3, V band) in the [-12, 12) kpc box."""
    geometry = GridGeometry((-12 * KPC,) * 3, (24 * KPC,) * 3, shape)
    base = dict(geometry=geometry, dust_central_density=21.9 * 1.674e-27 * 1e6,
                dust_scale_radius=6 * KPC, dust_scale_height=0.22 * KPC,
                stellar_scale_radius=5 * KPC, stellar_scale_height=0.6 * KPC,
                n_photons=n_photons, ccd_pixels=(48, 40), view_theta=np.deg2rad(89.7),
                view_phi=0.0)
    base.update(kw)
    return dust.DustConfig(**base)


def _jax_config(config):
    fields = dataclasses.asdict(config)
    return jax_dust.DustConfig(geometry=JaxGridGeometry(**fields.pop("geometry")), **fields)


def _sims(config, seed=42):
    return (dust.DustSimulation(config, device="cpu", seed=seed),
            jax_dust.DustSimulation(_jax_config(config), seed=seed))


# the views of the peel-off parity tests: edge-on (the dusty_galaxy view),
# face-on, and an oblique view through a window narrower than the box
VIEWS = {
    "edge-on": {},
    "face-on": dict(view_theta=0.0),
    "window": dict(view_theta=np.deg2rad(35.0), view_phi=0.3,
                   ccd_anchor=(-5 * KPC, -4 * KPC), ccd_sides=(9 * KPC, 7 * KPC)),
}


def _rel_l1(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / np.abs(b).sum())


def _rel(a, b):
    """max |a − b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _events(rng, shape, n):
    """Event positions (cell units), unit directions, weights and an active
    mask, made with numpy."""
    pos = rng.uniform(0.0, 1.0, (n, 3)) * (np.asarray(shape) - 1e-3)
    pos[: n // 8] = np.round(pos[: n // 8] * 4) / 4  # on cell walls
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = rng.uniform(0.5, 1.5, n) / n
    active = rng.uniform(size=n) < 0.8
    return (pos.astype(np.float32), d.astype(np.float32), w.astype(np.float32), active)


# -- mirrors of tests/test_dust.py:21, :34, :50, :77 -------------------------


def test_hg_sampling_statistics():
    # mean cosine of the HG phase function equals g
    g = 0.44
    xi = torch.tensor(np.random.default_rng(0).uniform(size=200000), dtype=torch.float32)
    cos = dust.henyey_greenstein_cos(xi, g).numpy()
    assert cos.mean() == pytest.approx(g, abs=0.01)
    assert cos.min() >= -1 and cos.max() <= 1
    # phase function normalizes over the sphere
    mu = np.linspace(-1, 1, 20001)
    phase = peel_off.henyey_greenstein_phase(torch.tensor(mu), g).numpy()
    assert 2 * np.pi * np.trapezoid(phase, mu) == pytest.approx(1.0, rel=1e-4)


def test_rotation_preserves_angle():
    rng = np.random.default_rng(1)
    n = 1000
    cos_t = rng.uniform(-1, 1, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    sin_t = np.sqrt(1 - cos_t**2)
    dx, dy, dz = (torch.tensor(a, dtype=torch.float32) for a in (
        sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t))
    cos_scat = torch.full((n,), 0.3)
    ndx, ndy, ndz = dust._rotate_to_new_direction(
        dx, dy, dz, cos_scat, torch.tensor(rng.uniform(0, 2 * np.pi, n), dtype=torch.float32))
    np.testing.assert_allclose((dx * ndx + dy * ndy + dz * ndz).numpy(), 0.3, atol=1e-4)
    np.testing.assert_allclose((ndx**2 + ndy**2 + ndz**2).numpy(), 1.0, atol=1e-5)


def test_dust_image_centrally_concentrated():
    geometry = GridGeometry((-10 * KPC, -10 * KPC, -5 * KPC), (20 * KPC, 20 * KPC, 10 * KPC),
                            (32, 32, 16))
    config = dust.DustConfig(
        geometry=geometry, dust_central_density=2e-21, dust_scale_radius=5 * KPC,
        dust_scale_height=0.3 * KPC, stellar_scale_radius=4 * KPC,
        stellar_scale_height=0.25 * KPC, n_photons=20000, n_scatterings=2,
        ccd_pixels=(32, 32))
    image = dust.DustSimulation(config, device="cpu", seed=3).run().numpy()
    assert image.shape == (32, 32)
    assert np.all(np.isfinite(image)) and image.sum() > 0
    # face-on exponential disc: central surface brightness dominates
    center = image[12:20, 12:20].mean()
    edge = np.concatenate([image[:4].ravel(), image[-4:].ravel()]).mean()
    assert center > 5 * edge


def test_peel_off_tau_nonzero_through_opaque_disc():
    """The 1e4 target keeps τ resolvable in f32 (a 1e30 target once rounded
    every peel-off τ to zero in the JAX package)."""
    sim = dust.DustSimulation(_galaxy((64, 64, 64)), device="cpu")
    tau = float(peel_off.peel_off_tau_reference(
        sim.chi, torch.tensor([[32.2, 32.2, 32.2]]), view=sim.view)[0])
    assert 2.0 < tau < 10.0, tau


def test_peel_off_march_crosses_the_box_within_the_step_cap():
    """The step cap 4·(nx+ny+nz) leaves room for the longest march: from the
    corner facing away from the observer across the whole 201³ box."""
    config = _galaxy((201, 201, 201), view_theta=np.arccos(1 / np.sqrt(3)),
                     view_phi=np.pi / 4)
    sim = dust.DustSimulation(config, device="cpu")
    stats = {}
    tau = peel_off.peel_off_tau_reference(sim.chi, torch.tensor([[0.01, 0.02, 0.03]]),
                                          view=sim.view, stats=stats)
    steps = int(stats["packet_steps"])
    assert 3 * 200 <= steps <= sum(sim.view.shape) < sim.view.max_steps
    assert float(tau[0]) > 0.0


def test_mesh_raises():
    sim = dust.DustSimulation(_galaxy((8, 8, 8)), device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        sim.run(mesh=object())


# -- deterministic parity with shared draws ----------------------------------


def test_hg_and_rotation_match_jax():
    n = 4096
    key = jax.random.PRNGKey(5)
    k1, k2, k3 = jax.random.split(key, 3)
    with jax.enable_x64(False):
        cos_j = np.asarray(jax_dust.henyey_greenstein_cos(k1, 0.44, n))
        xi = np.asarray(jax.random.uniform(k1, (n,), jnp.float32))
        cos_p = dust.henyey_greenstein_cos(torch.tensor(xi), 0.44).numpy()
        assert _rel(cos_p, cos_j) <= 1e-6
        mu = np.linspace(-1, 1, n).astype(np.float32)
        phase_j = np.asarray(jax_dust.henyey_greenstein_phase(jnp.asarray(mu), 0.44))
        phase_p = peel_off.henyey_greenstein_phase(torch.tensor(mu), 0.44).numpy()
        np.testing.assert_allclose(phase_p, phase_j, rtol=1e-6)

        d = np.random.default_rng(2).normal(size=(n, 3))
        d[:64] = [0.0, 0.001, 1.0]  # near ±z: the other helper axis
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        new_j = jax_dust._rotate_to_new_direction(k2, *(jnp.asarray(d[:, i]) for i in range(3)),
                                                  jnp.asarray(cos_j))
        phi = np.asarray(jax.random.uniform(k2, (n,), jnp.float32, 0.0, 2.0 * np.pi))
        new_p = dust._rotate_to_new_direction(*(torch.tensor(d[:, i]) for i in range(3)),
                                              torch.tensor(cos_j), torch.tensor(phi))
        for a, b in zip(new_p, new_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_emit_and_chi_match_jax():
    config = _galaxy((40, 40, 40), n_photons=20000)
    sim, jsim = _sims(config)
    assert np.array_equal(sim.chi.numpy(), np.asarray(jsim.chi))  # bit for bit
    n = config.n_photons
    key = jax.random.PRNGKey(9)
    keys = jax.random.split(key, 9)
    with jax.enable_x64(False):
        gpos_j, valid_j = (np.asarray(a) for a in jsim._emit(key, n))
        draws = [np.asarray(jax.random.uniform(k, (n,), jnp.float32, lo, hi))
                 for k, (lo, hi) in zip(keys, dust.EMIT_DRAW_RANGES)]
    gpos_p, valid_p = sim._emit([torch.tensor(a) for a in draws])
    assert np.array_equal(valid_p.numpy(), valid_j)
    assert 0 < valid_j.sum() < n  # some draws leave the box
    assert np.abs(gpos_p.numpy() - gpos_j).max() <= 1e-6 * max(config.geometry.shape)


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_peel_off_tau_and_pixel_match_jax(view):
    config = _galaxy(**VIEWS[view])
    sim, jsim = _sims(config)
    pos, _, _, _ = _events(np.random.default_rng(3), config.geometry.shape, 4096)
    with jax.enable_x64(False):
        tau_j = np.asarray(jsim._peel_off_tau(jnp.asarray(pos)))
        pix_j = np.asarray(jsim._ccd_pixel(jnp.asarray(pos)))
    tau_p = peel_off.peel_off_tau_reference(sim.chi, torch.tensor(pos), view=sim.view).numpy()
    pix_p = peel_off.ccd_pixel_reference(torch.tensor(pos), view=sim.view).numpy()
    assert tau_p.max() > 0.1
    assert np.array_equal(tau_p, tau_j)
    assert np.array_equal(pix_p, pix_j)
    npx, npy = config.ccd_pixels
    assert pix_p.min() >= 0 and pix_p.max() < npx * npy
    if view == "window":  # the clip into the edge pixels is exercised
        px, py = pix_p // npy, pix_p % npy
        assert ((px == 0) | (px == npx - 1) | (py == 0) | (py == npy - 1)).mean() > 0.1


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_plain_peel_off_matches_jax_composite(view):
    """The plain K8 (peel_off_deposit_reference with peel_off_factor) against
    the JAX driver's emission and scattering peel-offs (dust_simulation.py:
    398-400, 431-438)."""
    config = _galaxy(**VIEWS[view])
    sim, jsim = _sims(config)
    pos, d, w, active = _events(np.random.default_rng(4), config.geometry.shape, 4096)
    npix = config.ccd_pixels[0] * config.ccd_pixels[1]
    obs = np.asarray(jsim.config.observer_direction, dtype=np.float32)
    obs = obs / np.linalg.norm(obs)
    with jax.enable_x64(False):
        gpos = jnp.asarray(pos)
        tau = jsim._peel_off_tau(gpos)
        pix = jsim._ccd_pixel(gpos)
        weight = jnp.where(jnp.asarray(active), jnp.asarray(w), 0.0)
        ccd_emit = jnp.zeros(npix, jnp.float32).at[pix].add(
            weight / (4.0 * np.pi) * jnp.exp(-tau))
        dx, dy, dz = (jnp.asarray(d[:, i]) for i in range(3))
        cos_obs = dx * obs[0] + dy * obs[1] + dz * obs[2]
        phase = jax_dust.henyey_greenstein_phase(cos_obs, config.hgg)
        contribution = jnp.where(jnp.asarray(active),
                                 jnp.asarray(w) * config.albedo * phase * jnp.exp(-tau), 0.0)
        ccd_scatter = jnp.zeros(npix, jnp.float32).at[pix].add(contribution)

    t = torch.tensor
    emit = torch.zeros(npix)
    factor = peel_off.peel_off_factor(t(w) * t(active), view=sim.view)
    tau_p, pix_p = peel_off.peel_off_deposit_reference(sim.chi, t(pos), factor, t(active), emit,
                                                       view=sim.view)
    assert np.array_equal(tau_p.numpy(), np.asarray(tau))
    assert np.array_equal(pix_p.numpy(), np.asarray(pix))
    assert _rel_l1(emit.numpy(), ccd_emit) <= 1e-6
    scatter = torch.zeros(npix)
    peel_off.peel_off_deposit(sim.chi, t(pos), t(w), t(active), scatter, view=sim.view,
                              direction=t(d), albedo=config.albedo, hgg=config.hgg)
    assert _rel_l1(scatter.numpy(), ccd_scatter) <= 1e-6


def test_dust_config_from_params_matches_cli(tmp_path):
    """dust_config_from_params against the configuration cmacionize_tpu's
    CLI (_run_dust) hands its DustSimulation, for the dusty_galaxy keys and
    a K-band window."""
    from cmacionize_tpu import cli
    from cmacionize_tpu.utils.logging import NullLog
    from cmacionize_tpu.utils.params import ParameterFile as JaxParameterFile

    tree = {
        "SimulationBox": {"anchor": "[-12. kpc, -12. kpc, -12. kpc]",
                          "sides": "[24. kpc, 24. kpc, 24. kpc]",
                          "periodicity": [False, False, False]},
        "DensityGrid": {"number of cells": [201, 201, 201]},
        "DensityFunction": {"central density": "1. cm^-3"},
        "DustSimulation": {"number of photons": 500000, "polarization": True},
        "CCDImage": {"image width": 200, "image height": 200, "view theta": "89.7 degrees"},
    }
    window = {**tree, "dust": {"band": "K"},
              "CCDImage": {"image width": 64, "image height": 32, "view theta": "30 degrees",
                           "view phi": "0.5 radians", "anchor x": "-3 kpc", "anchor y": "-2 kpc",
                           "sides x": "6 kpc", "sides y": "4 kpc"},
              "ContinuousPhotonSource": {"bulge over total ratio": 0.1}}
    seen = []

    class Capture:
        def __init__(self, config, log=None, seed=42):
            seen.append(config)

        def run_polarized(self):
            shape = seen[-1].ccd_pixels
            return {k: np.zeros(shape) for k in "IQUV"}

    original = jax_dust.DustSimulation
    jax_dust.DustSimulation = Capture
    try:
        for case in (tree, window):
            with pytest.MonkeyPatch.context() as mp:
                mp.chdir(tmp_path)
                cli._run_dust(JaxParameterFile(case), NullLog(), seed=1)
            ours = dataclasses.asdict(dust.dust_config_from_params(ParameterFile(case)))
            theirs = dataclasses.asdict(seen[-1])
            assert ours == theirs
    finally:
        jax_dust.DustSimulation = original


# -- the drivers against JAX, statistically ----------------------------------

# At 48^3, 2e4 photons, 12 orders, edge-on, a 32 x 32 CCD, the JAX driver's
# seeds 1 and 2 differ by correlation 0.9902, centroid 0.037 px, profile
# 0.140, flux 0.56%, Q/I 4.7e-4 and U/I 1.0e-3; over the 28 pairs of seeds
# 1-8 by correlation >= 0.9884, centroid <= 0.196 px, profile <= 0.257, flux
# <= 1.35%, and Q/I, U/I scatter with standard deviations 4.4e-4, 3.3e-4.
# The bars hold the port's seed against JAX's with room for that spread.
DRIVER_BARS = {"correlation": 0.98, "centroid_px": 0.4, "profile": 0.5, "flux": 0.03}
MAX_STOKES_RATIO_DIFF = 2e-3


@pytest.fixture(scope="module")
def driver_runs():
    config = _galaxy((48, 48, 48), n_photons=20000, ccd_pixels=(32, 32))
    jconfig = _jax_config(config)
    with jax.enable_x64(False):
        jax_runs = {seed: (np.asarray(jax_dust.DustSimulation(jconfig, seed=seed).run()),
                           {k: np.asarray(v) for k, v in jax_dust.DustSimulation(
                               jconfig, seed=seed).run_polarized().items()})
                    for seed in (1, 2)}
    sim = dust.DustSimulation(config, device="cpu", seed=1)
    image = sim.run().numpy()
    orders = list(sim.scattered_per_order)
    planes = {k: v.numpy() for k, v in dust.DustSimulation(
        config, device="cpu", seed=1).run_polarized().items()}
    return jax_runs, image, orders, planes


def _within_bars(m):
    return (m["correlation"] >= DRIVER_BARS["correlation"]
            and m["centroid_px"] <= DRIVER_BARS["centroid_px"]
            and m["profile"] <= DRIVER_BARS["profile"]
            and abs(m["flux"]) <= DRIVER_BARS["flux"])


def test_run_matches_jax_statistically(driver_runs):
    jax_runs, image, orders, _ = driver_runs
    assert image.shape == (32, 32) and np.isfinite(image).all()
    assert _within_bars(image_measures(jax_runs[1][0], jax_runs[2][0]))  # JAX's own spread
    m = image_measures(jax_runs[1][0], image)
    assert _within_bars(m), m
    # scattering orders fall off geometrically and the run stops early
    assert orders[0] > orders[1] > orders[2] > 0 and len(orders) <= 12


def test_run_polarized_matches_jax_statistically(driver_runs):
    jax_runs, _, _, planes = driver_runs
    assert set(planes) == {"I", "Q", "U", "V"}
    m = image_measures(jax_runs[1][1]["I"], planes["I"])
    assert _within_bars(m), m
    for k in "QU":
        ours = planes[k].sum() / planes["I"].sum()
        theirs = [p[k].sum() / p["I"].sum() for _, p in jax_runs.values()]
        assert abs(theirs[0] - theirs[1]) <= MAX_STOKES_RATIO_DIFF
        assert abs(ours - theirs[0]) <= MAX_STOKES_RATIO_DIFF, (k, ours, theirs)
    # V stays zero without linear→circular conversion
    assert np.abs(planes["V"]).max() <= 1e-8 * planes["I"].max()
    # the edge-on disc's scattered light is polarized parallel to the disc
    assert planes["Q"].sum() < 0


def test_drivers_use_cpu_when_asked_and_cuda_otherwise():
    sim = dust.DustSimulation(_galaxy((8, 8, 8)), device="cpu")
    assert sim.chi.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dust.DustSimulation(_galaxy((8, 8, 8)))
