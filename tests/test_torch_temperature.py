"""The port's f64 ionization balances and temperature solve against JAX's.

The same numpy inputs, made from a seed, go through the JAX functions
(``cmacionize_tpu/ops/{ionization,temperature}.py``) and the port's plain
versions (``cmacionize_torch/ops/{ionization,temperature}.py``, K4's twin),
all in f64 on the CPU.  The solve's cells follow the recipe of
``tests/test_temperature.py::test_compacted_solve_bitwise_identical`` with
its abundances, plus cells without gas.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from cmacionize_torch.ops import ionization as tion
from cmacionize_torch.ops import recombination as trec
from cmacionize_torch.ops import temperature as ttemp
from cmacionize_tpu.models import ions
from cmacionize_tpu.ops import ionization as jion
from cmacionize_tpu.ops import recombination as jrec
from cmacionize_tpu.ops import temperature as jtemp

ABUND = {"He": 0.1, "C": 2.2e-4, "N": 4.0e-5, "O": 3.3e-4, "Ne": 5.0e-5, "S": 9.0e-6}
METALS = tuple(ions.ION_NAMES[2:])
N_CELLS = 4096
N_VACUUM = 64


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _cells(seed, n):
    """Lexington-like random cells (the recipe of test_temperature.py)."""
    rng = np.random.default_rng(seed)
    jH = 10.0 ** rng.uniform(-14, -6, n)
    scale = {"H_n": 1.0, "He_n": 0.7}
    j = {name: jH * scale.get(name, 10.0 ** rng.uniform(-3, 0)) for name in ions.ION_NAMES}
    hH = jH * 10.0 ** rng.uniform(-19.0, -18.0, n)
    nd = 10.0 ** rng.uniform(6, 10, n)
    T = 10.0 ** rng.uniform(2.0, 4.3, n)
    return j, (hH, 0.5 * hH), nd, T


@pytest.fixture(scope="module")
def cells():
    j, h, nd, T = _cells(11, N_CELLS)
    nd[:N_VACUUM] = 0.0  # cells without gas
    return j, h, nd, T


@pytest.fixture(scope="module")
def solved(cells):
    """JAX's jitted solve (one compile) and the port's plain solve."""
    j, h, nd, T = cells
    ref_fn = jax.jit(functools.partial(jtemp.solve_temperature, pahfac=1.0, crfac=0.0))
    ref = ref_fn(T, j, h, nd, ABUND)
    ref = (np.asarray(ref[0]), np.asarray(ref[1]), np.asarray(ref[2]),
           {k: np.asarray(v) for k, v in ref[3].items()})
    got = ttemp.solve_temperature(
        _t(T), {k: _t(v) for k, v in j.items()}, (_t(h[0]), _t(h[1])), _t(nd), ABUND,
        pahfac=1.0, crfac=0.0)
    return ref, got


def test_hydrogen_helium_neutral_fractions(cells):
    j, _, nd, T = cells
    nd = np.where(nd > 0, nd, 1e8)
    alphaH = np.asarray(jrec.recombination_rate("H_n", T))
    alphaHe = np.asarray(jrec.recombination_rate("He_n", T))
    ref = jion.hydrogen_helium_neutral_fractions(j["H_n"], j["He_n"], nd, 0.1, T, alphaH, alphaHe)
    got = tion.hydrogen_helium_neutral_fractions(
        _t(j["H_n"]), _t(j["He_n"]), _t(nd), 0.1, _t(T), _t(alphaH), _t(alphaHe))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-300)


def test_metal_ion_fractions(cells):
    j, _, nd, T = cells
    rng = np.random.default_rng(3)
    h0 = 10.0 ** rng.uniform(-5, 0, N_CELLS)
    he0 = rng.uniform(0, 1, N_CELLS)
    ne = nd * (1.0 - h0 + 0.1 * (1.0 - he0))
    alphas = {name: np.asarray(jrec.recombination_rate(name, T)) for name in METALS}
    args = (ne, T, nd * h0, nd * he0 * 0.1, nd * (1.0 - h0))
    ref = jion.metal_ion_fractions({n: j[n] for n in METALS}, *args, alphas)
    got = tion.metal_ion_fractions(
        {n: _t(j[n]) for n in METALS}, *(_t(a) for a in args),
        {n: _t(a) for n, a in alphas.items()})
    assert tuple(got) == METALS
    for name in METALS:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=1e-12,
                                   atol=1e-300, err_msg=name)


@pytest.mark.parametrize("pahfac, crfac", [(1.0, 0.0), (0.0, 0.5)])
def test_cooling_heating_balance(cells, pahfac, crfac):
    """One evaluation at T + 3000 K: all fields within 1e-9 relative (the
    H-He fixed point's early exit amplifies last-bit rate differences;
    measured at most 1.1e-10 on one cell of 4032)."""
    j, h, nd, T = cells
    keep = nd > 0
    j = {k: v[keep] for k, v in j.items()}
    h, nd, T = (h[0][keep], h[1][keep]), nd[keep], T[keep] + 3000.0
    ref = jtemp.cooling_heating_balance(T, j, h, nd, ABUND, pahfac=pahfac, crfac=crfac)
    got = ttemp.cooling_heating_balance(
        _t(T), {k: _t(v) for k, v in j.items()}, (_t(h[0]), _t(h[1])), _t(nd), ABUND,
        pahfac=pahfac, crfac=crfac)
    for name in ("h0", "he0", "gain", "loss"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=0, err_msg=name)
    for name in METALS:
        np.testing.assert_allclose(got.metals[name].numpy(), np.asarray(ref.metals[name]),
                                   rtol=1e-9, atol=1e-300, err_msg=name)


def test_solve_temperature_per_cell(solved):
    """T per cell against JAX's jitted solve.  XLA and torch differ in the
    last bits of exp/log/pow, and the branchy secant turns that into a
    slightly different iterate for some cells.  Measured (CPU, 4096 cells,
    64 without gas): 100% of cells within 1e-8 relative, 17% within 1e-12,
    the largest deviation 4.5e-9; required: >= 95% within 1e-8 and all
    within 5e-3."""
    ref, got = solved
    T_ref, T_got = ref[0], got.T.numpy()
    same_nan = np.isnan(T_ref) & np.isnan(T_got)
    rel = np.where(same_nan, 0.0, np.abs(T_got - T_ref) / np.abs(T_ref))
    assert not np.isnan(rel).any()
    assert np.mean(rel <= 1e-8) >= 0.95, np.mean(rel <= 1e-8)
    assert rel.max() <= 5e-3, rel.max()


def test_solve_temperature_state(solved):
    """The ionization state that goes with T: within 1e-5 relative (measured
    at most 3.4e-6, on 3 cells of 4096, where T differs by a few 1e-9)."""
    ref, got = solved
    np.testing.assert_allclose(got.h0.numpy(), ref[1], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got.he0.numpy(), ref[2], rtol=1e-5, atol=1e-9)
    for name in METALS:
        np.testing.assert_allclose(got.metals[name].numpy(), ref[3][name], rtol=1e-5,
                                   atol=1e-9, err_msg=name)


def test_cells_without_gas_run_every_sweep(solved, cells):
    _, got = solved
    sweeps = got.sweeps.numpy()
    assert got.sweeps.dtype == torch.int32
    assert (sweeps[:N_VACUUM] == 100).all()
    assert sweeps.min() >= 1 and sweeps.max() == 100
    assert np.isfinite(got.T.numpy()).all()
    # most cells with gas converge before the last sweep
    assert (sweeps < 100).mean() > 0.5


def test_reference_solve_handles_shaped_fields(cells):
    j, h, nd, T = (c for c in cells)
    sl = slice(N_VACUUM, N_VACUUM + 64)
    flat = ttemp.solve_temperature(
        _t(T[sl]), {k: _t(v[sl]) for k, v in j.items()}, (_t(h[0][sl]), _t(h[1][sl])),
        _t(nd[sl]), ABUND)
    shaped = ttemp.solve_temperature(
        _t(T[sl]).reshape(4, 4, 4), {k: _t(v[sl]).reshape(4, 4, 4) for k, v in j.items()},
        (_t(h[0][sl]).reshape(4, 4, 4), _t(h[1][sl]).reshape(4, 4, 4)),
        _t(nd[sl]).reshape(4, 4, 4), ABUND)
    assert shaped.T.shape == (4, 4, 4) and shaped.metals["O_n"].shape == (4, 4, 4)
    np.testing.assert_array_equal(shaped.T.reshape(-1).numpy(), flat.T.numpy())
    np.testing.assert_array_equal(shaped.sweeps.reshape(-1).numpy(), flat.sweeps.numpy())


def test_recombination_division_rounds_once():
    x = torch.tensor([3.0, 7.0, 1e-300], dtype=torch.float64)
    np.testing.assert_array_equal(trec.div(1.0, x).numpy(), 1.0 / x.numpy())
    np.testing.assert_array_equal(trec.div(x, 3.0).numpy(), x.numpy() / 3.0)
