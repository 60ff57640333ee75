"""cmacionize_torch's polarized dust scattering against the JAX package's,
on the CPU.

The first tests mirror tests/test_polarization.py on the port; the parity
tests hand the same numpy inputs (and JAX's own azimuth draws) to
``cmacionize_tpu.ops.polarization`` and to the port, and hold the plain K8p
(``ops/peel_off.py:peel_off_polarized_reference``) against the JAX driver's
polarized peel-off composite (dust_simulation.py:509-518).  Tolerances are
relative to each output's largest magnitude: both sides round once per
operation in the same order, and only transcendentals (pow, acos, cos, exp)
may differ in the last bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch.models import dust_simulation as dust
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.ops import peel_off
from cmacionize_torch.ops import polarization as pol
from cmacionize_tpu.models import dust_simulation as jax_dust
from cmacionize_tpu.models.grid import GridGeometry as JaxGridGeometry
from cmacionize_tpu.ops import polarization as jax_pol

MAX_REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _band(**kw):
    base = dict(hgg=0.44, pl=0.43, albedo=0.54, kappa=21.9, sc=0.0, pc=0.0)
    base.update(kw)
    return pol.ScatteringBand(**base)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


# -- mirrors of tests/test_polarization.py:17, :32, :58, :76, :93 ------------


def test_scattering_matrix_limits():
    band = _band()
    g = band.hgg
    P1, P2, P3, P4 = pol.scattering_matrix(torch.tensor(1.0), band)
    assert float(P1) == pytest.approx((1 - g * g) / (1 - g) ** 3, rel=1e-6)
    assert float(P2) == 0.0
    assert float(P3) == pytest.approx(float(P1), rel=1e-6)
    P1, P2, P3, P4 = pol.scattering_matrix(torch.tensor(0.0), band)
    assert float(-P2 / P1) == pytest.approx(band.pl, rel=1e-6)
    assert float(P3) == 0.0
    assert float(P4) == 0.0  # pc = 0


def test_unpolarized_90deg_single_scatter_degree():
    """Unpolarized light scattered by 90° acquires degree = pl."""
    band = _band()
    n = 512
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    nref = torch.stack(pol.initial_reference_normal(d[:, 0], d[:, 1], d[:, 2]), 1)
    psi = _t(np.random.default_rng(0).uniform(0, 2 * np.pi, n))
    I, Z = torch.ones(n), torch.zeros(n)
    d2, n2, I2, Q2, U2, V2 = pol.scatter_polarized(psi, d, nref, I, Z, Z, Z, torch.zeros(n), band)
    np.testing.assert_allclose(torch.linalg.norm(d2, dim=1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(d2[:, 2].numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(I2.numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(torch.sqrt(Q2**2 + U2**2).numpy(), band.pl, rtol=1e-5)
    np.testing.assert_allclose((d2 * n2).sum(1).numpy(), 0.0, atol=1e-5)


def test_forward_scatter_preserves_stokes():
    band = _band()
    n = 64
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    nref = torch.tensor([[1.0, 0.0, 0.0]]).repeat(n, 1)
    psi = _t(np.random.default_rng(1).uniform(0, 2 * np.pi, n))
    Z = torch.zeros(n)
    d2, n2, I2, Q2, U2, V2 = pol.scatter_polarized(
        psi, d, nref, torch.ones(n), torch.full((n,), 0.3), Z, Z, torch.ones(n), band)
    np.testing.assert_allclose(d2.numpy(), d.numpy(), atol=1e-6)
    np.testing.assert_allclose(torch.sqrt(Q2**2 + U2**2).numpy(), 0.3, atol=1e-5)
    np.testing.assert_allclose(I2.numpy(), 1.0, atol=1e-6)


def test_peel_off_degenerate_direction():
    """Packets already flying toward the observer peel off with the
    forward-scattering matrix (no polarization change)."""
    band = _band()
    one = torch.ones(1)
    I_o, Q_o, U_o, V_o = pol.peel_off_polarized(
        torch.tensor([[0.0, 0.0, 1.0]]), torch.tensor([[1.0, 0.0, 0.0]]), one, 0.2 * one,
        torch.zeros(1), torch.zeros(1), (0.0, 0.0, 1.0), (1.0, 0.0, 0.0), band)
    g = band.hgg
    assert float(I_o[0]) == pytest.approx((1 - g * g) / (1 - g) ** 3 / (4 * np.pi), rel=1e-5)
    assert float(Q_o[0] / I_o[0]) == pytest.approx(0.2, rel=1e-4)


def test_polarized_dust_image_centrosymmetric():
    """Face-on image of a compact source in a dust slab: single-scattered
    light is tangentially polarized (Q_r < 0), and V stays 0 with pc = 0."""
    pc_m = 3.086e16
    geom = GridGeometry(anchor=(-5 * pc_m,) * 3, sides=(10 * pc_m,) * 3, shape=(16, 16, 16))
    config = dust.DustConfig(
        geometry=geom, dust_central_density=2.0 / (10 * pc_m), dust_scale_radius=100 * pc_m,
        dust_scale_height=100 * pc_m, stellar_scale_radius=0.1 * pc_m,
        stellar_scale_height=0.1 * pc_m, n_photons=40000, n_scatterings=1,
        ccd_pixels=(32, 32), polarization=True)
    images = {k: v.numpy() for k, v in
              dust.DustSimulation(config, device="cpu", seed=7).run_polarized().items()}
    assert set(images) == {"I", "Q", "U", "V"}
    assert images["I"].sum() > 0
    assert np.abs(images["V"]).max() <= 1e-8 * images["I"].max()
    npx = 32
    # CCD axis 0 is x (pix = px * npy + py)
    xx, yy = np.meshgrid(np.arange(npx) + 0.5 - npx / 2, np.arange(npx) + 0.5 - npx / 2,
                         indexing="ij")
    phi = np.arctan2(yy, xx)
    Qr = images["Q"] * np.cos(2 * phi) + images["U"] * np.sin(2 * phi)
    r = np.sqrt(xx**2 + yy**2)
    ring = (r > 6) & (r < 14)
    q_r_sum = Qr[ring].sum()
    assert q_r_sum < 0
    assert np.abs(q_r_sum) / images["I"][ring].sum() > 0.02


# -- parity with shared inputs -----------------------------------------------


def _state(seed, n):
    """Directions (some along ±ẑ and along the observer), reference normals
    ⊥ d, and a partly polarized Stokes state, made with numpy."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d[:16] = [0.0, 0.0, 1.0]
    d[16:32] = [0.0, 0.001, -1.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    a = rng.normal(size=(n, 3))
    nref = a - (a * d).sum(1, keepdims=True) * d
    nref /= np.linalg.norm(nref, axis=1, keepdims=True)
    I = rng.uniform(0.5, 1.5, n)
    Q, U = (rng.uniform(-0.3, 0.3, n) * I for _ in range(2))
    V = rng.uniform(-0.05, 0.05, n) * I
    cos_t = rng.uniform(-1.0, 1.0, n)
    cos_t[:8] = (1.0, -1.0, 0.0, 0.999999, -0.999999, 0.5, -0.5, 1e-7)
    return [np.asarray(x, np.float32) for x in (d, nref, I, Q, U, V, cos_t)]


BANDS = {"V": dict(), "K, skewed": dict(hgg=0.02, pl=0.93, albedo=0.21, kappa=2.0, sc=0.3,
                                         pc=0.2)}


@pytest.mark.parametrize("band_name", sorted(BANDS))
def test_scattering_matrix_and_scatter_match_jax(band_name):
    band = _band(**BANDS[band_name])
    jband = jax_pol.ScatteringBand(**dataclasses.asdict(band))
    n = 4096
    d, nref, I, Q, U, V, cos_t = _state(11, n)
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(False):
        for ours, theirs in zip(pol.scattering_matrix(_t(cos_t), band),
                                jax_pol.scattering_matrix(jnp.asarray(cos_t), jband)):
            assert _rel(ours.numpy(), theirs) <= MAX_REL
        out_j = jax_pol.scatter_polarized(key, *(jnp.asarray(x) for x in (d, nref, I, Q, U, V)),
                                          jnp.asarray(cos_t), jband)
        psi = np.asarray(jax.random.uniform(key, (n,), jnp.float32, 0.0, 2.0 * np.pi))
    out_p = pol.scatter_polarized(_t(psi), *(_t(x) for x in (d, nref, I, Q, U, V)), _t(cos_t),
                                  band)
    for name, ours, theirs in zip(("d", "nref", "I", "Q", "U", "V"), out_p, out_j):
        assert _rel(ours.numpy(), theirs) <= MAX_REL, name


@pytest.mark.parametrize("band_name", sorted(BANDS))
def test_peel_off_polarized_matches_jax(band_name):
    band = _band(**BANDS[band_name])
    jband = jax_pol.ScatteringBand(**dataclasses.asdict(band))
    d, nref, I, Q, U, V, _ = _state(12, 4096)
    obs = np.asarray([0.3, -0.2, 0.9], np.float32)
    obs = obs / np.linalg.norm(obs)
    d[32:48] = obs  # flying toward the observer: the degenerate branch
    ex = np.cross([0.0, 0.0, 1.0], obs).astype(np.float32)
    ex = ex / np.linalg.norm(ex)
    with jax.enable_x64(False):
        out_j = jax_pol.peel_off_polarized(*(jnp.asarray(x) for x in (d, nref, I, Q, U, V)),
                                           obs, ex, jband)
    out_p = pol.peel_off_polarized(*(_t(x) for x in (d, nref, I, Q, U, V)),
                                   tuple(float(c) for c in obs), tuple(float(c) for c in ex), band)
    for name, ours, theirs in zip("IQUV", out_p, out_j):
        assert _rel(ours.numpy(), theirs) <= MAX_REL, name


def test_plain_polarized_peel_off_matches_jax_composite():
    """The plain K8p against the JAX driver's polarized peel-off: τ, pixel,
    peel_off_polarized, albedo · exp(−τ) and the four deposits."""
    KPC = dust.KPC
    config = dust.DustConfig(
        geometry=GridGeometry((-12 * KPC,) * 3, (24 * KPC,) * 3, (32, 32, 32)),
        dust_central_density=21.9 * 1.674e-27 * 1e6, dust_scale_radius=6 * KPC,
        dust_scale_height=0.22 * KPC, stellar_scale_radius=5 * KPC,
        stellar_scale_height=0.6 * KPC, n_photons=64, ccd_pixels=(48, 40),
        view_theta=np.deg2rad(80.0), view_phi=0.4)
    fields = dataclasses.asdict(config)
    jsim = jax_dust.DustSimulation(jax_dust.DustConfig(
        geometry=JaxGridGeometry(**fields.pop("geometry")), **fields))
    sim = dust.DustSimulation(config, device="cpu")
    band = pol.ScatteringBand(hgg=config.hgg, pl=config.pl, albedo=config.albedo, kappa=0.0)
    jband = jax_pol.ScatteringBand(**dataclasses.asdict(band))
    n = 4096
    rng = np.random.default_rng(13)
    pos = (rng.uniform(size=(n, 3)) * 31.99).astype(np.float32)
    d, nref, I, Q, U, V, _ = _state(14, n)
    active = rng.uniform(size=n) < 0.8
    npix = 48 * 40
    obs = np.asarray(jsim.config.observer_direction, dtype=np.float32)
    obs = obs / np.linalg.norm(obs)
    with jax.enable_x64(False):
        gpos = jnp.asarray(pos)
        outs = jax_pol.peel_off_polarized(*(jnp.asarray(x) for x in (d, nref, I, Q, U, V)),
                                          obs, np.asarray(jsim._e1, np.float32), jband)
        tau = jsim._peel_off_tau(gpos)
        pix = jsim._ccd_pixel(gpos)
        att = jnp.where(jnp.asarray(active), config.albedo * jnp.exp(-tau), 0.0)
        planes_j = [np.asarray(jnp.zeros(npix, jnp.float32).at[pix].add(o * att)) for o in outs]
    planes = tuple(torch.zeros(npix) for _ in range(4))
    tau_p, pix_p = peel_off.peel_off_polarized_reference(
        sim.chi, _t(pos), _t(d), _t(nref), tuple(_t(x) for x in (I, Q, U, V)),
        torch.tensor(active), planes, view=sim.view, band=band)
    assert np.array_equal(tau_p.numpy(), np.asarray(tau))
    assert np.array_equal(pix_p.numpy(), np.asarray(pix))
    for k, ours, theirs in zip("IQUV", planes, planes_j):
        rel_l1 = np.abs(ours.numpy() - theirs).sum() / np.abs(theirs).sum()
        assert rel_l1 <= MAX_REL, (k, rel_l1)
    # the dispatch runs the same plain version on CPU tensors
    again = tuple(torch.zeros(npix) for _ in range(4))
    peel_off.peel_off_deposit_polarized(
        sim.chi, _t(pos), _t(d), _t(nref), tuple(_t(x) for x in (I, Q, U, V)),
        torch.tensor(active), again, view=sim.view, band=band)
    for a, b in zip(again, planes):
        assert torch.equal(a, b)
