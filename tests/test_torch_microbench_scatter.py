"""The port's scatter/gather microbenchmark and its gathers K11 and K11r, on
the CPU.

The Pallas bodies of ``tools/microbench_scatter.py`` (``gather_kernel``,
:94-96, and ``gather2d_kernel``, :127-135) are closures inside its
``main()``, so they are restated here in numpy and the plain versions are
held to them bit for bit.  On CPU tensors the wrappers run the plain
versions; the kernels themselves are held to them on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cmacionize_torch.kernels import gather as gather_mod
from cmacionize_torch.tools import microbench_scatter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CELL = 16**3
BLK = 1 << 13
LINES = ("scatter-add random", "scatter-add sorted", "argsort+segsum", "segsum presorted",
         "gather random", "gather sorted", "K11 gather 1d", "K11r gather 2d")


def _pallas_gather(tbl, idx):
    """tools/microbench_scatter.py:94-96, block by block."""
    out = np.empty(idx.shape, np.float32)
    for g in range(0, idx.size, BLK):
        out[g:g + BLK] = np.take(tbl, idx[g:g + BLK], axis=0)
    return out


def _pallas_gather2d(tbl2, rows, lanes):
    """tools/microbench_scatter.py:127-135: whole rows, then a one-hot pick."""
    out = np.empty(rows.shape, np.float32)
    width = tbl2.shape[1]
    for g in range(0, rows.size, BLK):
        r, l = rows[g:g + BLK], lanes[g:g + BLK]
        picked = np.take(tbl2, r, axis=0)
        onehot = (np.arange(width)[None, :] == l[:, None]).astype(np.float32)
        out[g:g + BLK] = np.sum(picked * onehot, axis=1, dtype=np.float32)
    return out


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N_CELL, n).astype(np.int32)
    idx[:2] = (0, N_CELL - 1)  # the table's first and last entries
    tbl = rng.normal(size=N_CELL).astype(np.float32)
    return tbl, idx


@pytest.mark.parametrize("n", [2 * BLK, 3 * BLK + 17])
def test_gather_reference_matches_pallas_body(n):
    tbl, idx = _inputs(0, n)
    out = gather_mod.gather(torch.tensor(tbl), torch.tensor(idx))
    np.testing.assert_array_equal(out.numpy(), _pallas_gather(tbl, idx))
    np.testing.assert_array_equal(
        gather_mod.gather_reference(torch.tensor(tbl), torch.tensor(idx)).numpy(),
        _pallas_gather(tbl, idx))


@pytest.mark.parametrize("n", [2 * BLK, 3 * BLK + 17])
def test_gather2d_reference_matches_pallas_body(n):
    tbl, idx = _inputs(1, n)
    tbl2 = tbl.reshape(-1, 128)
    rows, lanes = idx // 128, idx % 128
    expected = _pallas_gather2d(tbl2, rows, lanes)
    np.testing.assert_array_equal(expected, tbl[idx])
    out = gather_mod.gather2d(*(torch.tensor(a) for a in (tbl2, rows, lanes)))
    np.testing.assert_array_equal(out.numpy(), expected)


def test_main_on_cpu_prints_every_line(capsys):
    seconds = microbench_scatter.main(device="cpu", n_packets=2**14, n_cell=N_CELL)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line[:24].rstrip() for line in lines] == list(LINES)
    assert list(seconds) == list(LINES) and all(s > 0 for s in seconds.values())
    for line in lines:
        assert " ms " in line and "M elem/s" in line
    assert lines[-2].endswith("correct=True") and lines[-1].endswith("correct=True")


@pytest.mark.parametrize("plain", ["gather_reference", "gather2d_reference"])
def test_main_raises_on_a_wrong_gather(plain, monkeypatch):
    original = getattr(gather_mod, plain)
    monkeypatch.setattr(gather_mod, plain, lambda *args: original(*args) + 1.0)
    with pytest.raises(RuntimeError, match="differs"):
        microbench_scatter.main(device="cpu", n_packets=2**14, n_cell=N_CELL)


def test_segment_sum_matches_index_add():
    rng = np.random.default_rng(2)
    idx = torch.tensor(np.sort(rng.integers(0, 64, 1000)), dtype=torch.int32)
    v = torch.tensor(rng.uniform(size=1000), dtype=torch.float32)
    expected = torch.zeros(80).index_add_(0, idx, v)
    torch.testing.assert_close(microbench_scatter.segment_sum(v, idx, 80), expected)


def test_main_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        microbench_scatter.main()


def test_module_runs_as_a_script_on_the_cpu():
    # at the tool's sizes (2^20 indices, 64^3 cells): ~5 s on the CPU
    proc = subprocess.run(
        [sys.executable, "-m", "cmacionize_torch.tools.microbench_scatter", "--device", "cpu"],
        # one thread: beside the other test processes, torch's thread per core
        # stalls the child past its limit, and these sizes gain nothing from threads
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                           MKL_NUM_THREADS="1"),
        capture_output=True, text=True,
        timeout=120, check=False,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("correct=True") == 2
