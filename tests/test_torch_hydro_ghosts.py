"""K3's ghost map on the CPU: the primitives and ghosts that K3 (U) forms
from the conserved state, against ``pad_primitives`` of the port and of the
JAX package.

K3 (``csrc/hydro_step.cu``) forms each padded cell's primitives from the
conserved state of its source cell, which ``ops/hydro.py:ghost_map`` gives
per axis (periodic, reflective and outflow walls; a bit-inverted index where
a reflective wall flips the sign of the normal velocity).  The plain form of
that first step, ``ops/hydro.py:ghost_primitives``, must give the padded
primitives of ``pad_primitives(primitives_from_conserved(u))`` bit for bit,
corners included, for every mix of walls; the step from it then equals
``hydro_step`` and stays within ``test_hydro_step_matches_jax``'s
tolerances of the JAX step.  The K3 wrappers are held to their refusals and
argument tables on a stand-in library (the kernel itself runs in
``test_torch_cuda.py``).
"""

import contextlib
import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch.kernels import LAUNCHES, hydro_step, launch
from cmacionize_torch.ops import hydro
from cmacionize_tpu.ops import hydro as jax_hydro

P, R, O = hydro.BC_PERIODIC, hydro.BC_REFLECTIVE, hydro.BC_OUTFLOW
# the walls of one axis: (lo, hi)
PAIRS = list(itertools.product((P, R, O), repeat=2))
GAMMA = 5.0 / 3.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(t) -> np.ndarray:
    return np.asarray(t, dtype=np.float32).view(np.int32)


def _state(seed: int, shape):
    """A conserved state from f32 primitives made with numpy (signed
    velocities, so that a flipped sign shows)."""
    rng = np.random.default_rng(seed)
    w = [rng.uniform(0.2, 2.0, shape), *rng.uniform(-1.0, 1.0, (3,) + shape),
         rng.uniform(0.2, 2.0, shape)]
    w = hydro.Primitives(*(torch.tensor(np.asarray(f, np.float32)) for f in w))
    return hydro.conserved_from_primitives(w, GAMMA)


def _gathered(w: hydro.Primitives, boundaries) -> list:
    """``w`` gathered by the three axes' ghost maps, the velocity of an axis
    negated where its map is bit-inverted."""
    maps = [hydro.ghost_map(*boundaries[a], w.rho.shape[a]).long() for a in range(3)]
    src = [torch.where(m < 0, ~m, m) for m in maps]
    index = (src[0][:, None, None], src[1][None, :, None], src[2][None, None, :])
    out = [f[index] for f in w]
    for axis, m in enumerate(maps):
        flip = (m < 0).reshape([-1 if a == axis else 1 for a in range(3)])
        out[1 + axis] = torch.where(flip, -out[1 + axis], out[1 + axis])
    return out


@pytest.mark.parametrize("shape", [(8, 8, 8), (5, 7, 9)])
@pytest.mark.parametrize("x_walls", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_ghost_map_gives_pad_primitives_bit_for_bit(shape, x_walls):
    u = _state(sum(shape) + PAIRS.index(x_walls), shape)
    w = hydro.primitives_from_conserved(u, GAMMA)
    jw = jax_hydro.Primitives(*(jnp.asarray(f.numpy()) for f in w))
    for y_walls, z_walls in itertools.product(PAIRS, repeat=2):
        boundaries = (x_walls, y_walls, z_walls)
        port = hydro.pad_primitives(w, boundaries)
        ref = jax_hydro.pad_primitives(jw, boundaries)
        for name, a, b, c, d in zip(port._fields, port, ref, _gathered(w, boundaries),
                                    hydro.ghost_primitives(u, boundaries, GAMMA)):
            where = (boundaries, name)
            assert a.shape == tuple(s + 4 for s in shape), where
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=str(where))
            np.testing.assert_array_equal(_bits(c), _bits(a), err_msg=str(where))
            np.testing.assert_array_equal(_bits(d), _bits(a), err_msg=str(where))


@pytest.mark.parametrize("walls, expected", [
    ((P, P), [3, 4, 0, 1, 2, 3, 4, 0, 1]),
    ((R, R), [~1, ~0, 0, 1, 2, 3, 4, ~4, ~3]),
    ((O, O), [0, 0, 0, 1, 2, 3, 4, 4, 4]),
    ((R, O), [~1, ~0, 0, 1, 2, 3, 4, 4, 4]),
    ((O, P), [0, 0, 0, 1, 2, 3, 4, 0, 1]),
])
def test_ghost_map_of_one_axis(walls, expected):
    table = hydro.ghost_map(*walls, 5)
    assert table.dtype == torch.int32
    assert table.tolist() == expected


def test_ghost_map_refuses_inflow():
    with pytest.raises(ValueError, match="inflow"):
        hydro.ghost_map(hydro.BC_INFLOW, O, 8)


def test_ghost_maps_are_made_once_per_walls_shape_and_device(monkeypatch):
    monkeypatch.setattr(hydro, "_GHOST_MAPS", {})
    walls = ((R, R), (P, P), (O, R))
    table = hydro.ghost_maps(walls, (5, 7, 9), "cpu")
    assert table.tolist() == (hydro.ghost_map(R, R, 5).tolist() + hydro.ghost_map(P, P, 7).tolist()
                              + hydro.ghost_map(O, R, 9).tolist())
    assert hydro.ghost_maps([list(b) for b in walls], (5, 7, 9), "cpu") is table
    assert hydro.ghost_maps(walls, (5, 7, 8), "cpu") is not table


BOUNDARIES = {
    "reflective": ((R, R),) * 3,
    "periodic": ((P, P),) * 3,
    "mixed": ((O, R), (P, P), (R, O)),
}


@pytest.mark.parametrize("gamma, solver, bc, rel", [
    (GAMMA, "HLLC", "reflective", 5e-5),
    (GAMMA, "HLLC", "mixed", 5e-5),
    (GAMMA, "Exact", "periodic", 5e-5),
    (1.0001, "HLLC", "reflective", 5e-5),
    (1.0001, "Exact", "mixed", 2e-3),
])
def test_plain_form_of_the_conserved_path_matches_hydro_step_and_jax(gamma, solver, bc, rel):
    shape = (12, 12, 12)
    u = _state(5, shape)
    u = hydro.conserved_from_primitives(hydro.primitives_from_conserved(u, GAMMA), gamma)
    kwargs = dict(cell_size=(0.1, 0.1, 0.1), gamma=gamma, riemann_solver=solver)
    dt = 2e-3
    plain = hydro.hydro_step_padded_reference(
        u, hydro.ghost_primitives(u, BOUNDARIES[bc], gamma), dt, **kwargs)
    port = hydro.hydro_step(u, dt, boundaries=BOUNDARIES[bc], **kwargs)
    for a, b in zip(plain, port):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    ref = jax_hydro.hydro_step(jax_hydro.HydroState(*(jnp.asarray(f.numpy()) for f in u)), dt,
                               boundaries=BOUNDARIES[bc], **kwargs)
    for i, (a, b) in enumerate(zip(ref, plain)):
        a, b = np.asarray(a, np.float64), b.numpy().astype(np.float64)
        assert np.abs(a - b).max() <= rel * max(np.abs(a).max(), 1e-30), (i, solver, bc)
    assert float((plain.energy - u.energy).abs().max()) > 1e-3


# -- the wrappers on a stand-in library ------------------------------------------------------------


class _Function:
    """A stand-in for a library's launcher: records its calls, returns 0."""

    def __init__(self):
        self.calls, self.argtypes, self.restype = [], None, None

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    """Device -1 current (the CPU's index), raw stream 1000 + index, K3's
    symbols stand-ins, and K3's device check passing CPU tensors that have
    the shapes and dtypes it wants (index -1)."""
    functions = {}

    class Library:
        def __getattr__(self, symbol):
            return functions.setdefault(symbol, _Function())

    monkeypatch.setattr(launch, "load_library", lambda name: Library())
    monkeypatch.setattr(launch, "raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(launch, "current_device", lambda: -1)
    monkeypatch.setattr(launch.torch.cuda, "device", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(hydro_step._LAUNCH, "function", None)

    def check(label, groups, riemann_solver):
        if riemann_solver not in hydro_step._SOLVERS:
            raise ValueError(f"{label}: unknown Riemann solver {riemann_solver!r}")
        for name, tensors, shape, dtype in groups:
            for i, t in enumerate(tensors):
                if t.dtype is not dtype or t.shape != shape:
                    raise ValueError(f"{label}: {name}[{i}] must be of shape {tuple(shape)}")
        return -1

    monkeypatch.setattr(hydro_step, "_check", check)
    return functions


def test_k3_wrappers_refuse_what_the_kernel_does_not_take():
    u = tuple(_state(1, (5, 7, 9)))
    walls = ((R, R),) * 3
    wp = tuple(hydro.pad_primitives(hydro.primitives_from_conserved(hydro.HydroState(*u)),
                                    walls))
    table = hydro.ghost_maps(walls, (5, 7, 9), "cpu")
    kw = dict(cell_size=(0.1,) * 3, gamma=GAMMA)
    with pytest.raises(ValueError, match="needs CUDA tensors, got cpu"):
        hydro_step.hydro_step_conserved_cuda(u, table, 1e-3, **kw)
    with pytest.raises(ValueError, match="needs CUDA tensors, got cpu"):
        hydro_step.hydro_step_cuda(u, wp, 1e-3, **kw)
    with pytest.raises(ValueError, match="Riemann"):
        hydro_step.hydro_step_conserved_cuda(u, table, 1e-3, riemann_solver="HLL", **kw)
    with pytest.raises(ValueError, match="5 fields"):
        hydro_step.hydro_step_conserved_cuda(u[:4], table, 1e-3, **kw)
    with pytest.raises(ValueError, match="5 fields each"):
        hydro_step.hydro_step_cuda(u, wp[:4], 1e-3, **kw)
    with pytest.raises(ValueError, match="3-D"):
        hydro_step.hydro_step_cuda(tuple(f[0] for f in u), wp, 1e-3, **kw)


def test_k3_wrappers_pass_their_argument_tables(stand_in):
    shape = (5, 7, 9)
    u = tuple(_state(2, shape))
    walls = ((R, O), (P, P), (O, R))
    wp = tuple(hydro.pad_primitives(hydro.primitives_from_conserved(hydro.HydroState(*u)),
                                    walls))
    table = hydro.ghost_maps(walls, shape, "cpu")
    kw = dict(cell_size=(0.1, 0.2, 0.4), gamma=1.0001)
    consts = [float(c) for c in hydro_step.kernel_constants(1.0001, 2e-3, kw["cell_size"])]
    before = LAUNCHES["hydro_step"]
    out_u = hydro_step.hydro_step_conserved_cuda(u, table, 2e-3, **kw)
    out_p = hydro_step.hydro_step_cuda(u, wp, 2e-3, riemann_solver="Exact", **kw)
    assert LAUNCHES["hydro_step"] == before + 2
    function = stand_in["cmi_hydro_step"]
    assert function.argtypes == hydro_step._LAUNCH.argtypes
    for call, src, ghosts, out, flags in (
            (function.calls[0], u, table.data_ptr(), out_u, (1, 0)),
            (function.calls[1], wp, 0, out_p, (0, 1))):
        pointers = [f.data_ptr() for f in (*src, *u)]
        assert list(call[:5]) == pointers[:5] and call[5] == ghosts
        assert list(call[6:11]) == pointers[5:]
        assert list(call[11:16]) == [f.data_ptr() for f in out]
        assert list(call[16:22]) == [*shape, *flags, hydro_step.EXACT_NEWTON_ITERATIONS]
        assert list(call[22:40]) == consts and call[40] == 999
        assert len(out) == 5 and all(f.shape == shape and f.is_contiguous() for f in out)
    # the five new fields are the rows of one tensor
    assert out_u[1].data_ptr() - out_u[0].data_ptr() == 4 * 5 * 7 * 9
    with pytest.raises(ValueError, match="ghost_map"):
        hydro_step.hydro_step_conserved_cuda(u, table[:-1], 2e-3, **kw)
    with pytest.raises(ValueError, match="ghost_map"):
        hydro_step.hydro_step_conserved_cuda(u, table.long(), 2e-3, **kw)
    with pytest.raises(ValueError, match="wp"):
        hydro_step.hydro_step_cuda(u, tuple(f[1:-1, 1:-1, 1:-1] for f in wp), 2e-3, **kw)


def test_k3_is_one_kernel_with_no_scratch():
    from cmacionize_torch.kernels import build

    text = (build.CSRC_DIR / "hydro_step.cu").read_text()
    assert re.findall(r"__global__ void __launch_bounds__\(kThreads\) (\w+)\(", text) == [
        "hydro_step_kernel"]
    assert "muscl_" not in text and "float* scratch" not in text
    assert hydro_step._LAUNCH.symbol == "cmi_hydro_step"
