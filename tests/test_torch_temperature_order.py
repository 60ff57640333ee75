"""The premises and helpers of K4's and K4f's persistent grid on the CPU.

K4 and K4f (``cmacionize_torch/csrc/temperature.cu``) hand cells to lanes
from a work counter, so a cell may run on any lane, beside any other cells,
in any order.  That is right only if no cell's result depends on another
cell: JAX's lockstep ``solve_temperature`` on seeded cells, and on the same
cells permuted, gives the permuted answer bit for bit, and so do the port's
plain versions.  Beside that: :func:`kernels.temperature.lanes_busy` (the
share of lanes a one-thread-a-cell launch keeps busy) on hand-made sweep
counts, the tables kept per configuration (:func:`device_tables`,
:func:`device_omega_table`) against :func:`kernel_tables` and
:func:`omega_table`, and :func:`ptxas_report` on a build log.  The kernels
themselves are in tests/test_torch_cuda.py.
"""

import functools
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cmacionize_torch import kernels
from cmacionize_torch.kernels import build
from cmacionize_torch.kernels import temperature as k4
from cmacionize_torch.ops import temperature as ttemp
from cmacionize_tpu.models import ions
from cmacionize_tpu.ops import temperature as jtemp

ABUND = {"He": 0.1, "C": 2.2e-4, "N": 4.0e-5, "O": 3.3e-4, "Ne": 5.0e-5, "S": 9.0e-6}
N_CELLS = 384


def _cells(seed, n):
    """Lexington-like random cells (the recipe of test_temperature.py), the
    first 16 without gas and the next 16 without radiation."""
    rng = np.random.default_rng(seed)
    jH = 10.0 ** rng.uniform(-14, -6, n)
    scale = {"H_n": 1.0, "He_n": 0.7}
    j = {name: jH * scale.get(name, 10.0 ** rng.uniform(-3, 0)) for name in ions.ION_NAMES}
    hH = jH * 10.0 ** rng.uniform(-19.0, -18.0, n)
    nd = 10.0 ** rng.uniform(6, 10, n)
    nd[:16] = 0.0
    for value in j.values():
        value[16:32] = 0.0
    hH[16:32] = 0.0
    T = 10.0 ** rng.uniform(2.0, 4.3, n)
    return T, j, (hH, 0.5 * hH), nd


def _permuted(cells, order):
    T, j, h, nd = cells
    return T[order], {k: v[order] for k, v in j.items()}, (h[0][order], h[1][order]), nd[order]


def _same_bits(a, b):
    """Equal bit for bit, NaN where NaN (numpy arrays)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    same = (a.view(np.int64 if a.dtype == np.float64 else np.int32)
            == b.view(np.int64 if b.dtype == np.float64 else np.int32))
    if a.dtype.kind == "f":
        same |= np.isnan(a) & np.isnan(b)
    assert bool(same.all()), int((~same).sum())


@pytest.fixture(scope="module")
def cells():
    return _cells(21, N_CELLS)


@pytest.fixture(scope="module")
def order():
    return np.random.default_rng(5).permutation(N_CELLS)


def test_jax_solve_of_permuted_cells_is_the_permuted_solve(cells, order):
    """The premise of lanes refilled from a counter, in the reference: JAX's
    lockstep solve gives each cell the same bits wherever it sits."""
    solve = jax.jit(functools.partial(jtemp.solve_temperature, pahfac=1.0, crfac=0.0))
    ref = solve(*cells, ABUND)
    got = solve(*_permuted(cells, order), ABUND)
    for r, g in zip(ref[:3], got[:3]):
        _same_bits(np.asarray(r)[order], np.asarray(g))
    for name in ref[3]:
        _same_bits(np.asarray(ref[3][name])[order], np.asarray(got[3][name]))


def _torch_cells(c):
    T, j, h, nd = c
    t = functools.partial(torch.tensor, dtype=torch.float64)
    return t(T), {k: t(v) for k, v in j.items()}, (t(h[0]), t(h[1])), t(nd)


def _plain_differences(solve, cells, order) -> int:
    """The outputs of ``solve`` on the cells permuted that differ from its
    outputs on the cells, permuted, in their bits (NaN equal to NaN)."""
    ref = solve(*_torch_cells(cells), ABUND, pahfac=1.0)
    got = solve(*_torch_cells(_permuted(cells, order)), ABUND, pahfac=1.0)
    pairs = [(getattr(ref, k).numpy()[order], getattr(got, k).numpy())
             for k in ("T", "h0", "he0", "sweeps")]
    pairs += [(v.numpy()[order], got.metals[k].numpy()) for k, v in ref.metals.items()]
    return sum(int((~((a == b) | (np.isnan(a) & np.isnan(b)))).sum()) for a, b in pairs)


CHILD = """
import sys
import numpy as np
sys.path[:0] = [{tests!r}, {root!r}]
import test_torch_temperature_order as t
from cmacionize_torch.ops import temperature
cells = t._cells(21, t.N_CELLS)
order = np.random.default_rng(5).permutation(t.N_CELLS)
print(t._plain_differences(temperature.solve_temperature_reference, cells, order))
"""


def test_plain_f64_solve_of_permuted_cells_is_the_permuted_solve():
    """K4's twin does the same, sweeps too, with torch's CPU kernels in
    their scalar form (``ATEN_CPU_CAPABILITY=default``, in a child process):
    the vectorised CPU kernels round exp, log and pow differently in a
    vector's body and in its tail, so where the plain version's compaction
    puts a cell can change its last bits."""
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, ATEN_CPU_CAPABILITY="default", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD.format(tests=tests, root=os.path.dirname(tests))],
        capture_output=True, text=True, env=env, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "0"


def test_plain_f32_solve_of_permuted_cells_within_k4f_tolerances(cells, order):
    """K4f's twin, in-process: torch's f32 CPU kernels are not the same
    function in a vector's body and its tail, and f32's cancellations grow a
    last-bit difference, so the permuted solve is held to the tolerances of
    K4f against its plain version (>= 99% of cells within 1e-4 relative in
    T, all within 5e-3, >= 99% with the same sweep count)."""
    solve = ttemp.solve_temperature_device_reference
    ref = solve(*_torch_cells(cells), ABUND, pahfac=1.0)
    got = solve(*_torch_cells(_permuted(cells, order)), ABUND, pahfac=1.0)
    a, b = ref.T.double().numpy()[order], got.T.double().numpy()
    rel = np.where(np.isnan(a) & np.isnan(b), 0.0, np.abs(a - b) / np.abs(a))
    rel = np.nan_to_num(rel, nan=np.inf)
    assert (rel <= 1e-4).mean() >= 0.99 and rel.max() <= 5e-3
    assert (ref.sweeps.numpy()[order] == got.sweeps.numpy()).mean() >= 0.99
    assert int(ref.sweeps[:16].min()) == 100  # cells without gas never settle


@pytest.mark.parametrize("sweeps, warp, expected", [
    ([5] * 64, 32, 1.0),
    ([1] * 31 + [100], 32, 131 / 3200),
    ([1] * 32 + [2] * 32, 32, 1.0),
    ([3, 1, 2, 2], 2, 8 / 10),
    ([4, 4, 4], 2, 12 / 16),  # the last warp padded with an idle lane
    ([0, 0], 2, 1.0),
    ([], 32, 1.0),
])
def test_lanes_busy_on_hand_made_sweeps(sweeps, warp, expected):
    got = k4.lanes_busy(torch.tensor(sweeps, dtype=torch.int32), warp=warp)
    assert got == pytest.approx(expected, rel=1e-12)


def test_lanes_busy_in_cell_order_and_sorted():
    """Cells that need many sweeps spread over every warp keep few lanes
    busy; the same counts sorted keep almost all."""
    sweeps = torch.ones(32 * 64, dtype=torch.int32)
    sweeps[::32] = 100
    assert k4.lanes_busy(sweeps) == pytest.approx((31 + 100) / 3200)
    assert k4.lanes_busy(torch.sort(sweeps).values) == 1.0


KWARGS = dict(pahfac=1.0, crfac=0.0, epsilon=1e-3, minimum_ionized_temperature=4000.0,
              scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_device_tables_equal_kernel_tables_and_are_kept(dtype):
    device = torch.device("cpu")
    kwargs = dict(KWARGS, scale=k4.DEVICE_SOLVE_SCALE if dtype == torch.float32 else 1.0)
    tables = k4.device_tables(dtype, device, ABUND, **kwargs)
    assert tables.dtype == dtype and tables.device == device
    expected = torch.tensor(k4.kernel_tables(ABUND, **kwargs), dtype=dtype)
    assert torch.equal(tables, expected)
    # the same configuration (a copy of the dict, in another order) is the
    # same kept tensor
    again = k4.device_tables(dtype, device, dict(reversed(list(ABUND.items()))), **kwargs)
    assert again is tables


@pytest.mark.parametrize("change", [
    {"pahfac": 0.0}, {"crfac": 0.5}, {"epsilon": 1e-4}, {"minimum_ionized_temperature": 3000.0},
    {"scale": 2.0}, {"abundances": dict(ABUND, O=4.0e-4)}, {"dtype": torch.float32},
])
def test_device_tables_change_with_the_configuration(change):
    device = torch.device("cpu")
    base = k4.device_tables(torch.float64, device, ABUND, **KWARGS)
    change = dict(change)
    dtype = change.pop("dtype", torch.float64)
    abundances = change.pop("abundances", ABUND)
    kwargs = dict(KWARGS, **change)
    other = k4.device_tables(dtype, device, abundances, **kwargs)
    assert other is not base
    expected = torch.tensor(k4.kernel_tables(abundances, **kwargs), dtype=dtype)
    assert torch.equal(other, expected)
    assert not torch.equal(other.double(), base)


def test_device_omega_table_is_kept():
    table = k4.device_omega_table(torch.device("cpu"))
    assert table.dtype == torch.float32 and tuple(table.shape) == (512, 103)
    assert torch.equal(table, torch.from_numpy(k4.omega_table()))
    assert k4.device_omega_table(torch.device("cpu")) is table


def _ptxas_entry(args, stack, stores, loads, registers):
    name = (f"_ZN12_GLOBAL__N_118temperature_kernel{args}"
            "EEvPKT_PKfS3_S3_S3_S3_PS1_S6_S6_S6_PiPjii")
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    {stack} bytes stack frame, {stores} bytes spill stores, "
            f"{loads} bytes spill loads\n"
            f"ptxas info    : Used {registers} registers, 6624 bytes smem, 456 bytes cmem[0]\n")


PTXAS_LOG = ("ptxas info    : 0 bytes gmem\n" + _ptxas_entry("IfLi3E", 0, 0, 0, 100)
             + _ptxas_entry("IfLi1E", 112, 8, 12, 120) + _ptxas_entry("IdLi3E", 224, 0, 0, 206)
             + _ptxas_entry("IdLi1E", 384, 184, 260, 168)
             + "ptxas info    : Function properties for _ZN5other_kernelEv\n"
             "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
             "ptxas info    : Used 10 registers\n")


def test_ptxas_report_reads_each_instantiation():
    assert k4.ptxas_report(PTXAS_LOG) == {
        "K4": {"stack": 384, "spill_stores": 184, "spill_loads": 260, "registers": 168},
        "K4f": {"stack": 112, "spill_stores": 8, "spill_loads": 12, "registers": 120},
        "K4 (3 lanes)": {"stack": 224, "spill_stores": 0, "spill_loads": 0, "registers": 206},
        "K4f (3 lanes)": {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 100},
    }


@pytest.mark.parametrize("n, lanes", [(1, 3), (12000, 3), (50688, 3), (50689, 1),
                                      (262144, 1), (2_101_184, 1)])
def test_lanes_per_cell_splits_a_cell_only_where_the_cells_leave_lanes_idle(
        monkeypatch, n, lanes):
    # a card that holds 6 blocks of 64 threads on each of 132 SMs with one
    # lane a cell: 50688 resident lanes
    monkeypatch.setattr(k4, "_GRID", {("cuda:0", torch.float64, 1): 6 * 132})
    assert k4.lanes_per_cell(n, torch.device("cuda:0"), torch.float64) == lanes


def test_threads_match_the_source():
    source = (build.CSRC_DIR / "temperature.cu").read_text()
    assert re.search(r"constexpr int kThreads = (\d+);", source).group(1) == str(k4.THREADS)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrappers_refuse_tensors_off_the_card_and_count_nothing(device):
    T, j, h, nd = _cells(3, 8)

    def t(a):
        return torch.tensor(a, dtype=torch.float64).to(device)

    kernels.LAUNCHES.clear()
    kwargs = dict(pahfac=0.0, crfac=0.0, epsilon=1e-3, max_iterations=100,
                  minimum_ionized_temperature=4000.0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        k4.solve_temperature_cuda(t(T), {k: t(v) for k, v in j.items()}, (t(h[0]), t(h[1])),
                                  t(nd), ABUND, **kwargs)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        k4.solve_temperature_device_cuda(
            t(T).float(), {k: t(v).float() for k, v in j.items()},
            (t(h[0]).float(), t(h[1]).float()), t(nd).float(), ABUND, **kwargs)
    assert kernels.LAUNCHES["temperature"] == kernels.LAUNCHES["temperature_f32"] == 0
    assert k4._TEMPERATURE.function is None and k4._TEMPERATURE_F32.function is None
