"""The port's atomic data and rates against the JAX package's.

Same numpy inputs, made from a seed, go through the JAX function and its
port (`cmacionize_torch/ops/{cross_sections,recombination,charge_transfer,
line_cooling}.py`).  The cross sections are host numpy in both packages and
agree exactly; the rates and level populations are f64 on tensors, where
XLA's and torch's exp/log/pow differ in the last bits (measured below 1e-13
relative), so they are held to 1e-12 relative.
"""

import numpy as np
import pytest
import torch

from cmacionize_torch import data
from cmacionize_torch.models import ions as tions
from cmacionize_torch.ops import charge_transfer as tct
from cmacionize_torch.ops import cross_sections as txsec
from cmacionize_torch.ops import line_cooling as tlc
from cmacionize_torch.ops import recombination as trec
from cmacionize_tpu.models import ions as jions
from cmacionize_tpu.ops import charge_transfer as jct
from cmacionize_tpu.ops import cross_sections as jxsec
from cmacionize_tpu.ops import line_cooling as jlc
from cmacionize_tpu.ops import recombination as jrec

RTOL = 1e-12
NU_MIN = 3.288e15


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def test_ions_match():
    assert tions.ION_NAMES == jions.ION_NAMES
    assert tions.DEFAULT_ABUNDANCES == jions.DEFAULT_ABUNDANCES
    assert tions.ELEMENT_NAMES == jions.ELEMENT_NAMES
    assert tions.METAL_NAMES == jions.ION_NAMES[2:]


@pytest.mark.parametrize("name", ["verner_photo.npz", "verner_rec.npz", "linecooling.npz"])
def test_tables_read_by_path(name):
    from cmacionize_tpu.data import _load

    ref = _load(name)
    got = data.load(name)
    assert sorted(got) == sorted(ref.files)
    for key in ref.files:
        np.testing.assert_array_equal(got[key], ref[key])


def test_cross_section_table_at_bin_centres():
    edges = np.linspace(NU_MIN, 4.0 * NU_MIN, 129)
    centres = 0.5 * (edges[1:] + edges[:-1])
    got = txsec.tabulate_cross_sections(centres)
    assert got.shape == (14, 128)
    np.testing.assert_array_equal(got, jxsec.tabulate_cross_sections(centres))
    assert (got[0] > 0).all() and (got[1] > 0).any()


@pytest.mark.parametrize("name", jions.ION_NAMES)
def test_recombination_rate(name):
    T = np.geomspace(100.0, 1e5, 400)
    got = trec.recombination_rate(name, _t(T)).numpy()
    ref = np.asarray(jrec.recombination_rate(name, T))
    assert (got > 0).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


def test_recombination_rate_of_a_number_is_f64():
    got = trec.recombination_rate("H_n", 8000.0)
    assert got.dtype == torch.float64
    assert float(got) == pytest.approx(float(jrec.recombination_rate("H_n", 8000.0)), rel=RTOL)


@pytest.mark.parametrize("which", ["recombination_rate_H", "ionization_rate_H", "recombination_rate_He"])
def test_charge_transfer(which):
    t4 = np.geomspace(1e-4, 30.0, 300)  # crosses every fit's validity window
    for name in jions.ION_NAMES:
        got = getattr(tct, which)(name, _t(t4)).numpy()
        ref = np.asarray(getattr(jct, which)(name, t4))
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0, err_msg=name)


@pytest.fixture(scope="module")
def random_plasma():
    rng = np.random.default_rng(5)
    T = 10.0 ** rng.uniform(3.0, 5.0, 3000)
    ne = 10.0 ** rng.uniform(4.0, 12.0, 3000)
    abund = rng.uniform(0.0, 5e-4, (3000, 13))
    return T, ne, abund


def test_five_level_populations(random_plasma):
    T, ne, _ = random_plasma
    got = tlc.five_level_populations(_t(T), _t(ne)).numpy()
    ref = np.asarray(jlc.five_level_populations(T, ne))
    assert got.shape == (3000, 10, 5)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-12)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-22)


def test_solve5x5_matches_jax_bitwise():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(500, 5, 5))
    A[:50, :, 0] = 0.0  # pivoting from lower rows
    b = rng.normal(size=(500, 5))
    got = tlc.solve5x5(_t(A), _t(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlc.solve5x5(A, b)))


def test_two_level_populations(random_plasma):
    T, ne, _ = random_plasma
    got = tlc.two_level_populations(_t(T), _t(ne)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlc.two_level_populations(T, ne)), rtol=RTOL)


def test_cooling_rate(random_plasma):
    T, ne, abund = random_plasma
    got = tlc.cooling_rate(_t(T), _t(ne), _t(abund)).numpy()
    ref = np.asarray(jlc.cooling_rate(T, ne, abund))
    assert (got > 1e-99).all()
    np.testing.assert_allclose(got, ref, rtol=1e-10)
