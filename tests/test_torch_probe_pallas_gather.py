"""The port's dynamic-indexing probes against the JAX tool's Pallas kernels,
on the CPU.

``tools/probe_pallas_gather.py`` is imported by path.  The ``run`` of each of
its ``b_*`` functions calls ``pl.pallas_call`` without ``interpret``, which
the CPU refuses, so the tests swap in ``pallas_call(..., interpret=True)``
while they trace it; the JAX package and the tool stay as they are.  The port's functions on CPU
tensors run their plain versions (``kernels/probe_gather.py``,
``kernels/gather.py:gather2d_reference``); the kernels themselves are held to
them on the card (tests/test_torch_cuda.py, chip_smoke.py).

The gathers copy bits, so they must be identical.  The scatter-add sums
duplicate indices: identical for integer weights, and within rtol 1e-6 for
random positive f32 weights (an order of addition may differ).  Indices lie
in range: in interpret mode ``take_along_axis`` wraps -1 and fills NaN past
the end (XLA's fill mode, not the TPU's), and the port's contract is
in-range indices.
"""

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from cmacionize_torch.kernels import gather as gather_mod
from cmacionize_torch.kernels import probe_gather
from cmacionize_torch.tools import probe_pallas_gather as port

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import probe_pallas_gather as jax_probe  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_PROBES = ("b_taa_lanes", "b_row_gather", "b_flat_gather_2d", "b_sublane_gather",
                 "b_scatter_add")
BASELINES = ("b_xla_row_gather_1m", "b_xla_argsort_1m", "b_xla_sort_pairs_1m")
CPU = torch.device("cpu")


@pytest.fixture
def interpret(monkeypatch):
    """The JAX tool's ``pl.pallas_call`` in interpret mode."""
    monkeypatch.setattr(pallas, "pallas_call",
                        functools.partial(pallas.pallas_call, interpret=True))


def _seeded_inputs(name, seed):
    """Random inputs at the probe's shapes, the tables' first and last
    entries among the lookups."""
    rng = np.random.default_rng(seed)

    def table(rows, width):
        return rng.normal(size=(rows, width)).astype(np.float32)

    def lookups(n, hi, shape):
        idx = rng.integers(0, hi, n)
        idx[0], idx[-1] = 0, hi - 1
        return idx.astype(np.int32).reshape(shape)

    if name == "b_taa_lanes":
        return table(8192, 128), lookups(8192, 128, (8192, 1))
    if name == "b_row_gather":
        return table(4096, 64), lookups(8192, 4096, (8192,))
    if name == "b_flat_gather_2d":
        flat = lookups(8192, 2048 * 128, (64, 128))
        return table(2048, 128), flat // 128, flat % 128
    if name == "b_sublane_gather":
        return table(2048, 128), lookups(1024, 2048, (8, 128))
    # distinct flat indices: no duplicates
    idx = rng.permutation(port.SCATTER_N)[:8192]
    idx[0], idx[-1] = 0, port.SCATTER_N - 1
    return idx.astype(np.int32).reshape(64, 128), table(64, 128)


def _jax_and_port(name, inputs):
    jax_run, _ = getattr(jax_probe, name)()
    port_fn, _ = getattr(port, name)(CPU)
    expected = np.asarray(jax_run(*(jnp.asarray(a) for a in inputs)))
    got = port_fn(*(torch.from_numpy(a) for a in inputs))
    return got.numpy(), expected


@pytest.mark.parametrize("name", KERNEL_PROBES)
def test_probe_equals_pallas_kernel_on_seeded_inputs(name, interpret):
    got, expected = _jax_and_port(name, _seeded_inputs(name, KERNEL_PROBES.index(name)))
    assert got.dtype == np.float32 and got.shape == expected.shape
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("name", KERNEL_PROBES)
def test_probe_equals_pallas_kernel_on_the_tools_own_inputs(name, interpret):
    _, jax_args = getattr(jax_probe, name)()
    _, port_args = getattr(port, name)(CPU)
    assert len(jax_args) == len(port_args)
    for j, p in zip(jax_args, port_args):
        assert str(j.dtype) == str(p.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    got, expected = _jax_and_port(name, tuple(np.array(a) for a in jax_args))
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("weights", ["integer", "random"])
def test_scatter_add_accumulates_duplicates_as_the_pallas_kernel(weights, interpret):
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 512, (64, 128)).astype(np.int32)  # ~16 lookups per index
    idx[0, 0], idx[-1, -1] = 0, port.SCATTER_N - 1
    if weights == "integer":
        val = rng.integers(-3, 4, (64, 128)).astype(np.float32)
    else:
        val = rng.uniform(0.0, 1.0, (64, 128)).astype(np.float32)
    got, expected = _jax_and_port("b_scatter_add", (idx, val))
    assert np.bincount(idx.reshape(-1)).max() > 1
    if weights == "integer":
        np.testing.assert_array_equal(got, expected)
    else:
        np.testing.assert_allclose(got, expected, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("name", BASELINES)
def test_baselines_equal_xla_at_a_smaller_size(name, monkeypatch):
    n = 1 << 14
    monkeypatch.setattr(jax_probe, "P", n)
    jax_run, jax_args = getattr(jax_probe, name)()
    port_fn, port_args = getattr(port, name)(CPU, n=n)
    for j, p in zip(jax_args, port_args, strict=True):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    if name != "b_xla_row_gather_1m":  # the keys wrap in int32, as JAX forms them under x64
        np.testing.assert_array_equal(port_args[0][:8].numpy(),
                                      [0, 2481, 866, 3347, 1732, 117, 2598, 983])
    expected, got = jax_run(*jax_args), port_fn(*port_args)
    expected = expected if isinstance(expected, tuple) else (expected,)
    got = got if isinstance(got, tuple) else (got,)
    for e, g in zip(expected, got, strict=True):  # argsort and sort_key_val are stable
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


@pytest.mark.parametrize("module, plain", [
    (probe_gather, "take_along_lanes_reference"),
    (probe_gather, "row_gather_reference"),
    (gather_mod, "gather2d_reference"),
    (probe_gather, "sublane_gather_reference"),
    (probe_gather, "scatter_add_reference"),
])
def test_main_raises_on_a_wrong_kernel_output(module, plain, monkeypatch):
    original = getattr(module, plain)
    monkeypatch.setattr(module, plain, lambda *args: original(*args) + 1.0)
    with pytest.raises(RuntimeError, match="differs from its plain version"):
        port.main(device="cpu")


def test_main_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.main()


def test_module_runs_as_a_script_on_the_cpu():
    # at the tool's sizes (the baselines at 2^20): ~5 s on the CPU
    proc = subprocess.run(
        [sys.executable, "-m", "cmacionize_torch.tools.probe_pallas_gather", "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=120, check=False,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert [line.split(":")[0] for line in lines] == [f"OK   {name}" for name, _ in port.PROBES]
    assert [line.endswith("correct=True") for line in lines] == [True] * 5 + [False] * 3
    assert all(" ms" in line for line in lines)
