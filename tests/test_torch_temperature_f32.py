"""The port's f32 temperature backend against the JAX package's.

``TemperatureCalculator: backend: f32-device`` runs the log-secant in f32 with
every gain and loss coefficient multiplied by DEVICE_SOLVE_SCALE and the
collision strengths interpolated from an f32 log-Ω table.  The same numpy
inputs, made from a seed, go through the JAX functions
(``cmacionize_tpu/ops/{temperature,line_cooling}.py``, f32 arrays under the
x64 flag that ``tests/conftest.py`` sets, as the JAX driver runs them) and the
port's plain versions (``cmacionize_torch/ops/``, K4f's twins) on the CPU.

XLA and torch differ in the last bit of f32 exp/log/pow, XLA fuses some
products into FMAs, and the log-secant turns last-bit differences into a
slightly different iterate, so per-cell agreement is stated as fractions of
cells.  XLA's CPU runtime flushes f32 subnormals and torch keeps them: on
these inputs flushing in torch (``torch.set_flush_denormal(True)``) changed
no result, so the comparison does not flush.
"""

import numpy as np
import pytest
import torch

from cmacionize_torch.kernels import temperature as ktemp
from cmacionize_torch.ops import line_cooling as tlc
from cmacionize_torch.ops import temperature as ttemp
from cmacionize_tpu.models import ions
from cmacionize_tpu.ops import line_cooling as jlc
from cmacionize_tpu.ops import temperature as jtemp

ABUND = {"He": 0.1, "C": 2.2e-4, "N": 4.0e-5, "O": 3.3e-4, "Ne": 5.0e-5, "S": 9.0e-6}
METALS = tuple(ions.ION_NAMES[2:])
S = ttemp.DEVICE_SOLVE_SCALE


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a, np.float64), dtype=dtype)


def _lexington_states(n=4096, seed=17):
    """tests/test_temperature.py:189-213's random Lexington states."""
    rng = np.random.default_rng(seed)
    jH = 10.0 ** rng.uniform(-14, -7, n)
    fac = {"H_n": 1.0, "He_n": 0.6, "C_p1": 0.2, "C_p2": 0.05, "N_n": 0.3, "N_p1": 0.1,
           "N_p2": 0.02, "O_n": 0.4, "O_p1": 0.1, "Ne_n": 0.2, "Ne_p1": 0.05, "S_p1": 0.1,
           "S_p2": 0.03, "S_p3": 0.01}
    j = {name: jH * f for name, f in fac.items()}
    return j, (jH * 4.0e-19, jH * 2.0e-19), np.full(n, 1.0e8), np.full(n, 8000.0)


def _wide_states(n=4096, seed=11):
    """Wider cells (tests/test_torch_temperature.py's recipe): T from 100 K to
    20 kK, densities over four decades, the first 64 without gas."""
    rng = np.random.default_rng(seed)
    jH = 10.0 ** rng.uniform(-14, -6, n)
    scale = {"H_n": 1.0, "He_n": 0.7}
    j = {name: jH * scale.get(name, 10.0 ** rng.uniform(-3, 0)) for name in ions.ION_NAMES}
    hH = jH * 10.0 ** rng.uniform(-19.0, -18.0, n)
    nd = 10.0 ** rng.uniform(6, 10, n)
    T = 10.0 ** rng.uniform(2.0, 4.3, n)
    nd[:64] = 0.0
    return j, (hH, 0.5 * hH), nd, T


def _port(fn, j, h, nd, T, **kw):
    return fn(_t(T), {k: _t(v) for k, v in j.items()}, (_t(h[0]), _t(h[1])), _t(nd), ABUND, **kw)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    both = np.isnan(got) & np.isnan(ref)
    return np.nan_to_num(np.where(both, 0.0, np.abs(got - ref) / np.abs(ref)), nan=np.inf)


def _abs(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    both = np.isnan(got) & np.isnan(ref)
    return np.nan_to_num(np.where(both, 0.0, np.abs(got - ref)), nan=np.inf)


# ------------------------------------------------------- the pieces in f32


def test_omega_table_is_the_jax_table():
    grid, five, two = tlc.omega_tables()
    jgrid, jfive, jtwo = jlc._omega_tables()
    np.testing.assert_array_equal(grid, jgrid)
    np.testing.assert_array_equal(five, jfive)
    np.testing.assert_array_equal(two, jtwo)
    assert tlc.omega_grid_constants() == (float(jgrid[0]), float(jgrid[1] - jgrid[0]))


def test_omega_interpolation():
    """Ω at 2000 temperatures over the secant's range (and beyond it, where
    the clamp holds), against JAX's interpolation: a last-bit difference of
    log T moves the node fraction by up to ~1e-6.  Measured: 93% of the
    values identical, 99.9% within 5e-7 relative, all within 6.3e-6;
    required >= 99% within 5e-7 and all within 2e-5."""
    T = np.float32(10.0 ** np.random.default_rng(5).uniform(1.5, 10.5, 2000))
    import jax.numpy as jnp

    for which in ("five", "two"):
        ref = np.asarray(jlc._omega_interp(jnp.asarray(T), which))
        got = tlc.omega_interpolated(torch.tensor(T), which).numpy()
        assert got.dtype == np.float32 and got.shape == ref.shape
        rel = _rel(got, ref)
        assert np.mean(rel <= 5e-7) >= 0.99 and rel.max() <= 2e-5, (which, rel.max())


def test_cooling_rate_f32_scaled():
    """The scaled f32 line cooling: within 1e-4 relative of JAX's (the 5×5
    eliminations in f32, last-bit differences of exp; measured 2.1e-6)."""
    rng = np.random.default_rng(2)
    n = 2048
    T = np.float32(10.0 ** rng.uniform(2.0, 4.6, n))
    ne = np.float32(10.0 ** rng.uniform(6, 10, n))
    abund = np.float32(10.0 ** rng.uniform(-6, -3, (n, 13)))
    import jax.numpy as jnp

    ref = np.asarray(jlc.cooling_rate(T, ne, abund, dtype=jnp.float32, scale=S))
    got = tlc.cooling_rate(torch.tensor(T), torch.tensor(ne), torch.tensor(abund), scale=S)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4)
    pops = tlc.five_level_populations(torch.tensor(T), torch.tensor(ne)).numpy()
    ref_pops = np.asarray(jlc.five_level_populations(T, ne, dtype=jnp.float32))
    np.testing.assert_allclose(pops, ref_pops, rtol=1e-4, atol=1e-10)


@pytest.mark.parametrize("pahfac, crfac", [(1.0, 0.0), (0.0, 0.5)])
def test_balance_f32_scaled(pahfac, crfac):
    """One f32 balance at scale 1e26 against JAX's, per cell.  In f32 the
    H-He fixed point's quadratics cancel (b² - 4ch²·opA, 1 - h0 in nearly
    neutral cells), and XLA fuses some of their products into FMAs, so a
    last-bit difference grows.  Measured (960 cells at T + 3000 K): h0 and
    he0 99.3% within 1e-4 relative, all within 2.2e-4; gain 91% within 1e-4,
    96% within 1e-3, all within 3.4e-2 (the PAH term's ne of nearly
    neutral cells); loss the same.  Required: h0, he0 >= 99% within 1e-4,
    all within 1e-3; gain, loss >= 90% within 1e-4, >= 95% within 1e-3,
    all within 0.1; all fields f32."""
    j, h, nd, T = _wide_states(1024, seed=3)
    keep = nd > 0
    j = {k: v[keep] for k, v in j.items()}
    h, nd, T = (h[0][keep], h[1][keep]), nd[keep], T[keep] + 3000.0
    f32 = np.float32
    ref = jtemp.cooling_heating_balance(
        f32(T), {k: f32(v) for k, v in j.items()}, (f32(h[0]), f32(h[1])), f32(nd), ABUND,
        pahfac=pahfac, crfac=crfac, scale=S)
    got = ttemp.cooling_heating_balance(
        _t(T, torch.float32), {k: _t(v, torch.float32) for k, v in j.items()},
        (_t(h[0], torch.float32), _t(h[1], torch.float32)), _t(nd, torch.float32), ABUND,
        pahfac=pahfac, crfac=crfac, scale=S)
    assert got.gain.dtype == torch.float32 and got.loss.dtype == torch.float32
    for name in ("h0", "he0"):
        rel = _rel(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
        assert np.mean(rel <= 1e-4) >= 0.99 and rel.max() <= 1e-3, (name, rel.max())
    for name in ("gain", "loss"):
        rel = _rel(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
        assert np.mean(rel <= 1e-4) >= 0.90 and np.mean(rel <= 1e-3) >= 0.95, name
        assert rel.max() <= 0.1, (name, rel.max())
    # the scaled balance tracks the f64 balance (scale 1) by the scale
    ref64 = ttemp.cooling_heating_balance(
        _t(T), {k: _t(v) for k, v in j.items()}, (_t(h[0]), _t(h[1])), _t(nd), ABUND,
        pahfac=pahfac, crfac=crfac)
    ratio = got.gain.double() / (ref64.gain * S)
    assert float(torch.median((ratio - 1.0).abs())) < 1e-4


def test_kernel_tables_hold_the_plain_roundings():
    """K4f's table holds each Python-number product rounded once from f64, as
    JAX's weak typing rounds it; at scale 1 the f64 table holds K4's own
    constants, so the f64 arithmetic does not move."""
    kw = dict(pahfac=1.0, crfac=0.5, epsilon=1e-3, minimum_ionized_temperature=4000.0)
    f64 = ktemp.kernel_tables(ABUND, **kw)
    f32 = ktemp.kernel_tables(ABUND, scale=S, **kw).astype(np.float32)
    np.testing.assert_array_equal(f64[14:20], [1.0, 1.21765423e-18, 1.5e-37, 1.42e-40,
                                               2.85e-40, 1.55e-39])
    assert f64[25] == 0.5 * 1.2e-25 and f64[12] == ktemp.constants.BOLTZMANN
    assert f32[17] == np.float32(1.42e-40 * S) and f32[15] == np.float32(1.21765423e-18 * S)
    assert f32[20] == np.float32(1.0 + 2.0 * 0.1) and f32[23] == np.float32(4.0 * 0.1)
    assert f32[10] == np.float32(ktemp.LOG_BRACKET) and f32[12] == np.float32(
        ktemp.constants.BOLTZMANN * S)
    omega = ktemp.omega_table()
    assert omega.shape == (512, 103) and omega.dtype == np.float32
    np.testing.assert_array_equal(omega[:, :100].reshape(512, 10, 10), tlc.omega_tables()[1])


# ------------------------------------------------------------- the solve


@pytest.fixture(scope="module")
def lexington_solves():
    j, h, nd, T = _lexington_states()
    ref = jtemp.solve_temperature_device(T, j, h, nd, ABUND, pahfac=1.0)
    got = _port(ttemp.solve_temperature_device_reference, j, h, nd, T, pahfac=1.0)
    return ref, got


def test_device_solve_on_random_lexington_states(lexington_solves):
    """solve_temperature_device_reference against JAX solve_temperature_device
    per cell on tests/test_temperature.py's 4096 states.  Measured: 99.3% of
    cells within 1e-5 relative in T, all within 7.3e-5; h0, he0 and metals
    within 2.2e-5.  Required: >= 98% within 1e-5, all within 5e-4; the state
    within 1e-4."""
    ref, got = lexington_solves
    assert got.T.dtype == torch.float32 and got.sweeps.dtype == torch.int32
    rel = _rel(got.T.numpy(), np.asarray(ref[0]))
    assert np.mean(rel <= 1e-5) >= 0.98, np.mean(rel <= 1e-5)
    assert rel.max() <= 5e-4, rel.max()
    assert _abs(got.h0.numpy(), ref[1]).max() <= 1e-4
    assert _abs(got.he0.numpy(), ref[2]).max() <= 1e-4
    for name in METALS:
        assert _abs(got.metals[name].numpy(), ref[3][name]).max() <= 1e-4, name


def test_device_solve_tracks_the_f64_solve(lexington_solves):
    """tests/test_temperature.py:214-224's bands, for the port: the f32 solve
    against the port's f64 solve on the same states."""
    _, got = lexington_solves
    j, h, nd, T = _lexington_states()
    f64 = _port(ttemp.solve_temperature, j, h, nd, T, pahfac=1.0)
    rel = _rel(got.T.numpy(), f64.T.numpy())
    assert np.median(rel) < 3e-3 and np.quantile(rel, 0.95) < 2e-2
    np.testing.assert_allclose(got.h0.double().numpy(), f64.h0.numpy(), rtol=5e-2, atol=1e-6)


@pytest.mark.parametrize("crfac", [0.0, 0.5])
def test_device_solve_on_wide_states(crfac):
    """Cells from 100 K to 20 kK over four decades of density, 64 without
    gas (they run every sweep): measured 99.6% of cells within 1e-4
    relative in T, all within 3.3e-4; required >= 99% and all within 5e-3,
    the state within 2e-3 (measured 8.5e-4)."""
    j, h, nd, T = _wide_states()
    ref = jtemp.solve_temperature_device(T, j, h, nd, ABUND, pahfac=1.0, crfac=crfac)
    got = _port(ttemp.solve_temperature_device, j, h, nd, T, pahfac=1.0, crfac=crfac)
    rel = _rel(got.T.numpy(), np.asarray(ref[0]))
    assert np.mean(rel <= 1e-4) >= 0.99, np.mean(rel <= 1e-4)
    assert rel.max() <= 5e-3, rel.max()
    assert (got.sweeps.numpy()[:64] == 100).all()
    assert np.isfinite(got.T.numpy()).all()
    for got_f, ref_f in ((got.h0, ref[1]), (got.he0, ref[2])):
        assert _abs(got_f.numpy(), ref_f).max() <= 2e-3
    for name in METALS:
        assert _abs(got.metals[name].numpy(), ref[3][name]).max() <= 2e-3, name


def test_unchunked_solve_equals_the_chunked_one():
    """The port drops solve_temperature_device_chunked: on 700 cells JAX's
    chunked call (chunk=512, so one chunk padded with neutral cells) gives
    its unchunked call's per-cell results, bit for bit, and the port
    matches it as it matches the unchunked call."""
    j, h, nd, T = (a[:700] if isinstance(a, np.ndarray) else a
                   for a in _wide_states(700, seed=23))
    kw = dict(pahfac=1.0, crfac=0.0)
    chunked = jtemp.solve_temperature_device_chunked(T, j, h, nd, ABUND, chunk=512, **kw)
    whole = jtemp.solve_temperature_device(T, j, h, nd, ABUND, **kw)
    for a, b in zip(chunked[:3], whole[:3]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got = _port(ttemp.solve_temperature_device, j, h, nd, T, **kw)
    rel = _rel(got.T.numpy(), np.asarray(chunked[0]))
    assert np.mean(rel <= 1e-4) >= 0.99 and rel.max() <= 5e-3, (np.mean(rel <= 1e-4), rel.max())


def test_f64_solve_is_unchanged():
    """The f64 backend keeps its dtype and its arithmetic: the default scale
    is 1, and the solve equals the f64 reference with scale=1.0 passed, bit
    for bit (test_torch_temperature.py holds it against JAX)."""
    j, h, nd, T = _wide_states(256, seed=9)
    got = _port(ttemp.solve_temperature, j, h, nd, T, pahfac=1.0)
    same = _port(ttemp.solve_temperature_reference, j, h, nd, T, pahfac=1.0, scale=1.0)
    assert got.T.dtype == torch.float64
    np.testing.assert_array_equal(got.T.numpy(), same.T.numpy())
    np.testing.assert_array_equal(got.sweeps.numpy(), same.sweeps.numpy())
    ref = jtemp.solve_temperature(T, j, h, nd, ABUND, pahfac=1.0)
    rel = _rel(got.T.numpy(), np.asarray(ref[0]))
    assert np.mean(rel <= 1e-8) >= 0.95 and rel.max() <= 5e-3
