"""The port's deposit and DDA-step probes against the JAX tools' Pallas
kernels, on the CPU.

``tools/probe_deposit.py`` and ``tools/probe_deposit2.py`` run their benches
when imported, so the tests load only their imports, ``NSTEP`` and their
``def``s (by ``ast``).  Their ``pallas_call``s carry no ``interpret`` flag,
which the CPU refuses, so the tests swap in ``pallas_call(...,
interpret=True)``; the bodies read ``NSTEP`` when they are traced, so a test
can lower it.  The JAX
side runs with x64 off, as the tools do.  The port's functions on CPU
tensors run their plain versions (``kernels/probe_deposit.py``); the kernels
themselves are held to them on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances:
- the shifted histogram (D2-D8b, run_d; K13h): identical with integer
  weights (every cell sum is an exact integer below 2^24), at the tools'
  NSTEP with random lane indices too; with random f32 weights per-cell rel
  ≤ 1e-5 at NSTEP = 300.  The plain version sums in f64; the Pallas loops
  add each step's sum to an f32 accumulator, whose round-off grows with the
  steps: at 7808 steps and uniform [0, 1) weights it reaches 8.9e-6 of the
  exact sum (D2-D8) and 1.5e-5-2.2e-5 (D8b, eight additions a step), while
  at 300 steps it stays below 1e-6;
- E (K13e) and D12 (K13f): bit-identical in every lane.  E matches only
  with its three position updates and its radicand rounded once, as XLA on
  the CPU fuses them into FMAs, and with a correctly rounded square root
  (the plain versions take it in f64: torch's CPU f32 ``sqrt`` is off by an
  ulp in ~0.6% of inputs).  D12's ``zeros + dep[0, 0]`` is folded by XLA,
  so its −0.0 stays −0.0;
- W2 (K13w): bit-identical at the tool's inputs (every lane alike).  On
  seeded inputs XLA on the CPU rewrites 1/√x into rsqrt, which it forms
  from the x86 estimate ``vrsqrtps`` and two Newton steps: within an ulp or
  two of the exact 1/√x, machine-dependent, and not the division the body
  writes (which the port and K13w perform).  So seeded lanes agree to rel
  ≤ 1e-5, and ≥ 98% of them bit for bit.

At NSTEP = 7808 = 61·128 every cell of the tools' histogram gets 61·Σdep, so
the histogram is also held at NSTEP = 300 with random lane indices, where the
cells differ.
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

from cmacionize_torch.kernels import probe_deposit as kernels_mod
from cmacionize_torch.tools import probe_cohort_kernel as port_cohort
from cmacionize_torch.tools import probe_deposit as port
from cmacionize_torch.tools import probe_deposit2 as port2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
HISTOGRAM_REL = 1e-5


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


DEPOSIT = load_tool("probe_deposit")
DEPOSIT2 = load_tool("probe_deposit2")

# body: (the JAX tool, its kernel, its out shape, the port's tool, function,
# inputs)
HISTOGRAM_BODIES = {
    "D2": (DEPOSIT, "d2_kernel", (1, 128), port, port.histogram_row, port.sublane_inputs),
    "D3": (DEPOSIT, "d3_kernel", (1, 128), port, port.histogram_row, port.sublane_inputs),
    "D4": (DEPOSIT, "d4_kernel", (1, 128), port, port.histogram_row, port.sublane_inputs),
    "D5": (DEPOSIT, "d5_kernel", (1, 128), port, port.histogram_row, port.march_inputs),
    "D6": (DEPOSIT, "d6_kernel", (1, 128), port, port.histogram_row, port.march_inputs),
    "D7": (DEPOSIT, "d7_kernel", (1, 128), port, port.histogram_row, port.sublane_inputs),
    "D8": (DEPOSIT2, "d8_kernel", (16, 8), port2, port2.histogram_factored, port.march_inputs),
    "D8b": (DEPOSIT2, "d8b_kernel", (16, 8), port2, port2.histogram_factored,
            port.march_inputs),
}


@pytest.fixture
def interpret(monkeypatch):
    """The JAX tools' ``pl.pallas_call`` in interpret mode."""
    monkeypatch.setattr(pallas, "pallas_call",
                        functools.partial(pallas.pallas_call, interpret=True))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax(run, *arrays):
    """``run`` on numpy ``arrays`` with x64 off, as numpy."""
    with jax.enable_x64(False):
        out = run(*(jnp.asarray(a) for a in arrays))
    return np.asarray(out)


def _port(fn, *arrays):
    return fn(*(torch.from_numpy(np.array(a)) for a in arrays)).numpy()


def _histogram_inputs(rng, shape, weights):
    lidx = rng.integers(0, 128, shape)
    lidx.reshape(-1)[:2] = (0, 127)
    if weights == "integer":
        dep = rng.integers(-3, 4, shape)
    else:
        dep = rng.uniform(0.0, 1.0, shape)
    return dep.astype(np.float32), lidx.astype(np.int32)


def _assert_histogram(got, expected, weights):
    assert got.dtype == np.float32 and got.shape == expected.shape
    if weights == "integer":
        np.testing.assert_array_equal(got, expected)
    else:
        np.testing.assert_allclose(got, expected, rtol=HISTOGRAM_REL, atol=0.0)


@pytest.mark.parametrize("body", list(HISTOGRAM_BODIES))
def test_histogram_body_at_the_tools_own_inputs(body, interpret):
    tool, kernel, shape, _, fn, inputs = HISTOGRAM_BODIES[body]
    dep, lidx = (a.numpy() for a in inputs(CPU))
    with jax.enable_x64(False):
        jax_dep = np.asarray(jnp.ones(dep.shape, jnp.float32))
        jax_lidx = np.asarray((jnp.arange(8 * 128, dtype=jnp.int32).reshape(lidx.shape) * 13)
                              % 128)
    np.testing.assert_array_equal(dep, jax_dep)
    np.testing.assert_array_equal(lidx, jax_lidx)
    expected = _jax(tool["make"](tool[kernel], shape), dep, lidx)
    got = _port(fn, dep, lidx)
    _assert_histogram(got, expected, "integer")
    np.testing.assert_array_equal(got, np.full(shape, 61.0 * 1024, np.float32))


@pytest.mark.parametrize("body", list(HISTOGRAM_BODIES))
def test_histogram_body_on_seeded_inputs(body, interpret):
    tool, kernel, shape, _, fn, inputs = HISTOGRAM_BODIES[body]
    layout = tuple(inputs(CPU)[0].shape)
    dep, lidx = _histogram_inputs(np.random.default_rng(list(HISTOGRAM_BODIES).index(body)),
                                  layout, "integer")
    expected = _jax(tool["make"](tool[kernel], shape), dep, lidx)
    _assert_histogram(_port(fn, dep, lidx), expected, "integer")


@pytest.mark.parametrize("weights", ["integer", "random"])
@pytest.mark.parametrize("body", list(HISTOGRAM_BODIES))
def test_histogram_body_at_300_steps(body, weights, interpret, monkeypatch):
    tool, kernel, shape, port_tool, fn, inputs = HISTOGRAM_BODIES[body]
    monkeypatch.setitem(tool, "NSTEP", 300)
    monkeypatch.setattr(port_tool, "NSTEP", 300)
    layout = tuple(inputs(CPU)[0].shape)
    dep, lidx = _histogram_inputs(np.random.default_rng(300), layout, weights)
    expected = _jax(tool["make"](tool[kernel], shape), dep, lidx)
    got = _port(fn, dep, lidx)
    _assert_histogram(got, expected, weights)
    assert np.ptp(expected) > 0  # 300 steps and random lanes: the cells differ


@pytest.mark.parametrize("body", [*HISTOGRAM_BODIES, "run_d"])
def test_every_histogram_body_is_k13h_in_its_layout(body):
    """D2-D8b and run_d are one function, K13h's [128], viewed as [1, 128]
    or [16, 8] (c = 8·hi + lo)."""
    if body == "run_d":
        fn, nstep, shape, dep_lidx = (port_cohort.run_d, 8 * port_cohort.NCHUNK, (1, 128),
                                      port_cohort.d_inputs(CPU))
    else:
        _, _, shape, port_tool, fn, inputs = HISTOGRAM_BODIES[body]
        nstep, dep_lidx = port_tool.NSTEP, inputs(CPU)
    rng = np.random.default_rng(11)
    dep, lidx = (torch.from_numpy(a) for a in _histogram_inputs(rng, tuple(dep_lidx[0].shape),
                                                                 "integer"))
    flat = kernels_mod.shifted_histogram_reference(dep, lidx, nstep)
    got = fn(dep, lidx)
    assert got.shape == shape and nstep == 7808
    assert torch.equal(got.reshape(-1), flat)
    # a one-hot count per (packet, step), in f64, independently of the port
    cells = (lidx.reshape(-1, 1).long() + torch.arange(nstep)) % 128
    counts = torch.zeros(128, dtype=torch.float64).index_add_(
        0, cells.reshape(-1), dep.reshape(-1, 1).double().expand(-1, nstep).reshape(-1))
    assert torch.equal(flat, counts.float())


def test_e_body_at_the_tools_own_inputs(interpret):
    with jax.enable_x64(False):
        a = np.asarray(jnp.linspace(0.1, 0.9, 8 * 128).reshape(8, 128))
    port_a, port_b = port.e_inputs(CPU)
    # the port forms linspace as JAX defines it; XLA on the CPU folds the
    # division into the products and fuses an FMA, so some entries differ
    # in the last bit
    np.testing.assert_array_max_ulp(port_a.numpy(), a, maxulp=1)
    np.testing.assert_array_equal(port_b.numpy(), port_a.numpy() * np.float32(0.5))
    b = a * np.float32(0.5)
    expected = _jax(DEPOSIT["make_e"](), a, b)
    got = _port(port.dda_math_steps, a, b)
    assert got.dtype == np.float32 and got.shape == (8, 128)
    np.testing.assert_array_equal(got, expected)


def test_e_body_on_seeded_inputs(interpret):
    rng = np.random.default_rng(5)
    a = rng.uniform(0.05, 0.95, (8, 128)).astype(np.float32)
    b = rng.uniform(-0.6, 0.6, (8, 128)).astype(np.float32)
    b[0, :4] = 0.0  # the 1e-12 branch of the y distance
    assert ((a * a + b * b) > 1.0).any()  # lanes with dz = 0: the z branch
    expected = _jax(DEPOSIT["make_e"](), a, b)
    np.testing.assert_array_equal(_port(port.dda_math_steps, a, b), expected)


def test_e_differs_without_its_fmas(interpret, monkeypatch):
    """Plain f32 products and sums in the position updates (no FMA) change
    the result: the plain version's ``_fma`` is what makes it bit-identical."""
    a, b = (t.numpy() for t in port.e_inputs(CPU))
    expected = _jax(DEPOSIT["make_e"](), a, b)
    monkeypatch.setattr(kernels_mod, "_fma", lambda x, y, z: x * y + z)
    assert (_port(port.dda_math_steps, a, b) != expected).sum() > 0


@pytest.mark.parametrize("case", ["tool", "seeded"])
def test_w2_body(case, interpret):
    if case == "tool":
        a, b = (t.numpy() for t in port2.w2_inputs(CPU))
        with jax.enable_x64(False):
            dep_m = jnp.ones((8, 128), jnp.float32)
            np.testing.assert_array_equal(a, np.asarray(dep_m * 0.5))
            np.testing.assert_array_equal(b, np.asarray(dep_m * 0.3))
    else:
        rng = np.random.default_rng(6)
        sign = rng.choice([-1.0, 1.0], (2, 8, 128))
        a, b = (sign * rng.uniform(0.05, 0.95, (2, 8, 128))).astype(np.float32)
    expected = _jax(DEPOSIT2["make"](DEPOSIT2["w2_kernel"], (8, 128)), a, b)
    got = _port(port2.dda_incremental_steps, a, b)
    assert got.dtype == np.float32
    if case == "tool":
        np.testing.assert_array_equal(got, expected)
    else:
        np.testing.assert_allclose(got, expected, rtol=1e-5, atol=0.0)
        assert (got == expected).mean() >= 0.98


@pytest.mark.parametrize("first", ["tool", "random", "negative zero"])
def test_d12_body(first, interpret):
    dep, lidx = (t.numpy() for t in port.march_inputs(CPU))
    if first != "tool":
        dep = np.random.default_rng(12).normal(size=(8, 128)).astype(np.float32)
        if first == "negative zero":
            dep[0, 0] = -0.0
    expected = _jax(DEPOSIT2["make"](DEPOSIT2["d12_kernel"], (1, 128)), dep, lidx)
    got = _port(port2.fill_row, dep, lidx)
    assert got.shape == (1, 128)
    np.testing.assert_array_equal(got.view(np.int32), expected.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), np.full((1, 128), dep.view(np.int32)[0, 0]))


@pytest.mark.parametrize("tool", [port, port2])
def test_main_needs_the_card_unless_asked_for_the_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main()


@pytest.mark.parametrize("tool", [port, port2])
def test_module_runs_as_a_script_on_the_cpu(tool):
    # one plain call per body at the tool's sizes: ~3 s on the CPU
    proc = subprocess.run(
        [sys.executable, "-m", tool.__name__, "--device", "cpu"],
        # one thread: beside the other test processes, torch's thread per core
        # stalls the child past its limit, and these sizes gain nothing from threads
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                           MKL_NUM_THREADS="1"),
        capture_output=True, text=True,
        timeout=120, check=False,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert [line.split(":")[0] for line in lines] == [f"OK   {name}" for name, *_ in tool.BODIES]
    assert all(" ms (host clock)" in line for line in lines)
    assert all(line.endswith(f"[{kernel}]") for line, (*_, kernel) in zip(lines, tool.BODIES))
