"""The port's cohort-traversal mechanics probes against the JAX tool's Pallas
kernels, on the CPU.

``tools/probe_cohort_kernel.py`` prints ``jax.devices()`` and runs its benches
when imported, so the tests load only its imports, ``NCHUNK`` and its
``def``s (by ``ast``).  Its ``pallas_call``s carry no ``interpret`` flag, which
the CPU refuses, so the tests swap in ``pallas_call(..., interpret=True)``;
run_c and run_d read ``NCHUNK`` when they are traced, so a test can lower it.
The JAX side runs with x64 off, as the tool does.  The port's functions on
CPU tensors run their plain versions (``kernels/probe_cohort.py``,
``kernels/probe_deposit.py``); the kernels themselves are held to them on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances:
- run_a (K14a) and run_b (K14b): bit-identical (a count; a gather summed in
  the loop's order from 0);
- run_c (K14c): the array identical; the scalar within 1e-6 of Σ|x·y| (the
  Pallas loop adds 976 chunk sums in order, the plain version takes torch's
  f32 sum: measured ~1e-9 of it);
- run_d (K13h): identical with integer weights, per-cell rel ≤ 1e-5 with
  random f32 weights at 296 steps (see test_torch_probe_deposit.py).
"""

import ast
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from cmacionize_torch.tools import probe_cohort_kernel as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def load_tool(name: str) -> dict:
    """The imports, ``NSTEP``/``NCHUNK`` and ``def``s of ``tools/<name>.py``,
    executed in a fresh namespace (the benches at module level are left out)."""
    path = os.path.join(ROOT, "tools", f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    keep = [node for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef))
            or (isinstance(node, ast.Assign)
                and {getattr(t, "id", None) for t in node.targets} & {"NSTEP", "NCHUNK"})]
    namespace = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), namespace)
    return namespace


COHORT = load_tool("probe_cohort_kernel")


@pytest.fixture
def interpret(monkeypatch):
    """The JAX tool's ``pl.pallas_call`` in interpret mode."""
    monkeypatch.setattr(pallas, "pallas_call",
                        functools.partial(pallas.pallas_call, interpret=True))


def _jax(name, *arrays):
    """The tool's ``name`` on numpy ``arrays`` with x64 off, as numpy (a tuple
    stays one).  It is jitted anew, so that it is traced with the ``NCHUNK``
    of this call."""
    with jax.enable_x64(False):
        fresh = jax.jit(lambda *args: COHORT[name].__wrapped__(*args))
        out = fresh(*(jnp.asarray(a) for a in arrays))
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


def _port(fn, *arrays):
    out = fn(*(torch.from_numpy(np.array(a)) for a in arrays))
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


@pytest.mark.parametrize("case", ["all-skip", "all-run", "seeded"])
def test_run_a(case, interpret):
    if case == "seeded":
        cnt = np.random.default_rng(1).integers(-3, 4, port.GRID).astype(np.int32)
    else:
        (cnt,) = (t.numpy() for t in (port.skip_inputs if case == "all-skip"
                                      else port.run_inputs)(CPU))
        np.testing.assert_array_equal(cnt, np.full(2048, 0 if case == "all-skip" else 1))
    expected = _jax("run_a", cnt)
    got = _port(port.run_a, cnt)
    assert got.dtype == np.float32 and got.shape == (8, 128)
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(got, np.full((8, 128), (cnt > 0).sum(), np.float32))


@pytest.mark.parametrize("case", ["tool", "seeded"])
def test_run_b(case, interpret):
    if case == "tool":
        tab, idx = (t.numpy() for t in port.b_inputs(CPU))
        with jax.enable_x64(False):
            np.testing.assert_array_equal(
                tab, np.asarray(jnp.arange(8 * 128, dtype=jnp.float32).reshape(8, 128)))
            np.testing.assert_array_equal(idx, np.asarray(
                (jnp.arange(8 * 128, dtype=jnp.int32).reshape(8, 128) * 13) % 128))
    else:
        rng = np.random.default_rng(2)
        tab = rng.normal(size=(8, 128)).astype(np.float32)
        # any int32 start: the lane is taken mod 128 (floor) on both sides
        idx = rng.integers(-200, 300, (8, 128)).astype(np.int32)
    expected = _jax("run_b", tab, idx)
    got = _port(port.run_b, tab, idx)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("case", ["tool", "seeded, 4 chunks", "seeded, 976 chunks"])
def test_run_c(case, interpret, monkeypatch):
    if case == "tool":
        (pk,) = (t.numpy() for t in port.c_inputs(CPU))
        np.testing.assert_array_equal(pk, np.ones((976 * 8, 16, 128), np.float32))
    else:
        chunks = int(case.split()[1])
        monkeypatch.setitem(COHORT, "NCHUNK", chunks)
        pk = np.random.default_rng(3).standard_normal((chunks * 8, 16, 128), np.float32)
    (out_j, s_j), (out_p, s_p) = _jax("run_c", pk), _port(port.run_c, pk)
    np.testing.assert_array_equal(out_p, out_j)
    np.testing.assert_array_equal(out_p[:, 2], pk[:, 0] + pk[:, 1])
    assert s_p.shape == s_j.shape == (1, 1) and s_p.dtype == np.float32
    magnitude = float(np.abs(pk[:, 0].astype(np.float64) * pk[:, 1]).sum())
    assert abs(float(s_p[0, 0]) - float(s_j[0, 0])) <= 1e-6 * magnitude
    if case == "tool":
        assert float(s_p[0, 0]) == float(s_j[0, 0]) == 976 * 8 * 128


def _d_inputs(rng, weights):
    lidx = rng.integers(0, 128, (8, 128))
    lidx.reshape(-1)[:2] = (0, 127)
    dep = rng.integers(-3, 4, (8, 128)) if weights == "integer" else rng.uniform(0, 1, (8, 128))
    return dep.astype(np.float32), lidx.astype(np.int32)


@pytest.mark.parametrize("case", ["tool", "seeded", "296 steps, integer", "296 steps, random"])
def test_run_d(case, interpret, monkeypatch):
    if case == "tool":
        dep, lidx = (t.numpy() for t in port.d_inputs(CPU))
        np.testing.assert_array_equal(dep, np.ones((8, 128), np.float32))
    else:
        if case.startswith("296"):  # 8 · 37 steps, not a multiple of 128
            monkeypatch.setitem(COHORT, "NCHUNK", 37)
            monkeypatch.setattr(port, "NCHUNK", 37)
        dep, lidx = _d_inputs(np.random.default_rng(4), "random" if "random" in case
                              else "integer")
    expected = _jax("run_d", dep, lidx)
    got = _port(port.run_d, dep, lidx)
    assert got.dtype == np.float32 and got.shape == (1, 128)
    if "random" in case:
        np.testing.assert_allclose(got, expected, rtol=1e-5, atol=0.0)
    else:
        np.testing.assert_array_equal(got, expected)
    if case.startswith("296"):
        assert np.ptp(expected) > 0


def test_main_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.main()


def test_module_runs_as_a_script_on_the_cpu():
    # one plain call per probe at the tool's sizes (run_c on 64 MB): ~1 s
    proc = subprocess.run(
        [sys.executable, "-m", port.__name__, "--device", "cpu"],
        # one thread: beside the other test processes, torch's thread per core
        # stalls the child past its limit, and these sizes gain nothing from threads
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                           MKL_NUM_THREADS="1"),
        capture_output=True, text=True,
        timeout=120, check=False,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert [line.split(":")[0] for line in lines] == [f"OK   {name}" for name, *_ in port.BODIES]
    assert all(" ms (host clock)" in line for line in lines)
    assert all(line.endswith(f"[{kernel}]") for line, (*_, kernel) in zip(lines, port.BODIES))
