"""cmacionize_torch hydrogen balance and point-source emission against the
JAX package, on the CPU.

Elementwise physics takes the same numpy inputs in both packages (JAX pinned
to f32).  Emission cannot share random streams (torch generators do not
reproduce jax.random), so it is compared in distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch.models import sources
from cmacionize_torch.ops import ionization
from cmacionize_tpu.models import sources as jax_sources
from cmacionize_tpu.ops import ionization as jax_ionization


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_hydrogen_neutral_fraction_matches_jax():
    rng = np.random.default_rng(0)
    shape = (12, 10, 8)
    # photoionization rates over 16 decades, with unirradiated and empty cells
    jH = (10.0 ** rng.uniform(-14, 2, shape)).astype(np.float32)
    jH.reshape(-1)[:40] = 0.0
    nH = (10.0 ** rng.uniform(4, 10, shape)).astype(np.float32)
    nH.reshape(-1)[30:60] = 0.0
    alpha = 4e-19
    x_torch = ionization.hydrogen_neutral_fraction(
        torch.from_numpy(jH), torch.from_numpy(nH), alpha
    ).numpy()
    x_jax = np.asarray(
        jax_ionization.hydrogen_neutral_fraction(jnp.asarray(jH), jnp.asarray(nH), alpha)
    )
    assert x_torch.dtype == x_jax.dtype == np.float32
    np.testing.assert_allclose(x_torch, x_jax, rtol=1e-6)
    assert (x_torch[jH == 0] == 1.0).all() and (x_torch[nH == 0] == 1.0).all()


def test_hydrogen_balance_limits():
    nH = torch.tensor(1e8)
    alpha = 4e-19
    # no radiation -> fully neutral
    assert float(ionization.hydrogen_neutral_fraction(torch.tensor(0.0), nH, alpha)) == 1.0
    # enormous radiation -> floor (1e-14 rounds to 9.9999998e-15 in f32)
    x = float(ionization.hydrogen_neutral_fraction(torch.tensor(1e10), nH, alpha))
    assert x >= 0.99 * ionization.NEUTRAL_FRACTION_FLOOR
    assert x < 1e-10


@pytest.mark.parametrize("jH", [1e-12, 1e-9, 1e-6, 1e-3, 1.0])
def test_hydrogen_balance_solves_quadratic(jH):
    # the root satisfies jH x = alpha nH (1-x)^2 over a wide dynamic range (f32)
    nH = 1e8
    alpha = 4e-19
    x = float(ionization.hydrogen_neutral_fraction(torch.tensor(jH), torch.tensor(nH), alpha))
    assert jH * x == pytest.approx(alpha * nH * (1 - x) ** 2, rel=2e-3)


def test_normalize_mean_intensity_matches_jax():
    tally = np.random.default_rng(1).uniform(0, 5, 100).astype(np.float32)
    args = (4.26e49, 1e5, 1.7e47)
    out_t = ionization.normalize_mean_intensity(torch.from_numpy(tally), *args).numpy()
    out_j = np.asarray(jax_ionization.normalize_mean_intensity(jnp.asarray(tally), *args))
    np.testing.assert_allclose(out_t, out_j, rtol=1e-6)


def _moments(dx, dy, dz, tau):
    d = np.stack([dx, dy, dz], 1)
    return d.mean(0), (d**2).mean(0), tau.mean(), tau.var()


def test_emission_distribution_matches_jax():
    n = 20_000
    gpos = (12.0, 7.5, 3.25)
    gen = torch.Generator().manual_seed(3)
    px, py, pz, dx, dy, dz, tau, w = (t.numpy() for t in sources.emit_point_source(gen, n, gpos))
    jpx, jpy, jpz, jdx, jdy, jdz, jtau, _, jw = (
        np.asarray(a) for a in jax_sources.emit_point_source(jax.random.PRNGKey(3), n, gpos)
    )
    assert px.dtype == np.float32 and jpx.dtype == np.float32
    np.testing.assert_allclose(np.sqrt(dx**2 + dy**2 + dz**2), 1.0, rtol=1e-5)
    # positions: the source nudged 1e-4 cells along the direction
    np.testing.assert_allclose(px, gpos[0] + 1e-4 * dx, rtol=1e-6)
    np.testing.assert_allclose(pz, gpos[2] + 1e-4 * dz, rtol=1e-6)
    assert (w == 1.0).all() and (jw == 1.0).all()
    assert (tau >= 0).all() and np.isfinite(tau).all()
    # isotropy and τ ~ Exp(1) in both packages, within Monte Carlo noise
    # (5 standard errors of the mean at n = 2e4)
    mean_t, sq_t, tau_mean_t, tau_var_t = _moments(dx, dy, dz, tau)
    mean_j, sq_j, tau_mean_j, tau_var_j = _moments(jdx, jdy, jdz, jtau)
    se = 5.0 / np.sqrt(n)
    np.testing.assert_allclose(mean_t, 0.0, atol=se * np.sqrt(1 / 3))
    np.testing.assert_allclose(mean_t, mean_j, atol=2 * se * np.sqrt(1 / 3))
    np.testing.assert_allclose(sq_t, 1 / 3, atol=se * np.sqrt(4 / 45))
    np.testing.assert_allclose(sq_t, sq_j, atol=2 * se * np.sqrt(4 / 45))
    assert tau_mean_t == pytest.approx(1.0, abs=se)
    assert tau_mean_t == pytest.approx(tau_mean_j, abs=2 * se)
    assert tau_var_t == pytest.approx(tau_var_j, abs=4 * se * np.sqrt(8))


def test_emission_is_reproducible_from_the_generator_seed():
    def emit(seed):
        gen = torch.Generator().manual_seed(seed)
        return sources.emit_point_source(gen, 1000, (1.0, 2.0, 3.0))

    for a, b in zip(emit(11), emit(11)):
        assert torch.equal(a, b)
    assert not torch.equal(emit(11)[3], emit(12)[3])


def test_emission_runs_on_the_generator_device():
    gen = torch.Generator(device="cpu").manual_seed(0)
    out = sources.emit_point_source(gen, 16, (0.0, 0.0, 0.0))
    assert all(t.device == gen.device and t.dtype == torch.float32 for t in out)
    dirs = sources.isotropic_directions(gen, 16, dtype=torch.float64)
    assert all(t.dtype == torch.float64 for t in dirs)
