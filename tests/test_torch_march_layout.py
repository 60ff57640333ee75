"""The data layout of the redesigned packet marches K1 and K6, on the CPU.

K6 reads a cell's faces from packed rows (one float4 of normal and offset a
face) and stops at the row's face count.  The kernels run on the card only
(tests/test_torch_cuda.py); here: the packed rows hold the old rows' bits,
padding only trails on the test grids, a march over the packed rows that
stops at the count gives the JAX march's bits, and the wrappers of K1 and K6
refuse CPU tensors and are typed for their sources' launchers.
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cmacionize_torch.kernels import trace_packets, trace_voronoi
from cmacionize_torch.models import voronoi
from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.ops import traversal
from cmacionize_tpu.models import voronoi as jax_voronoi

from test_torch_voronoi import _march_inputs, to_jax_grid

PERIODIC = [(False, False, False), (True, True, True), (True, False, True)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _starbench_like_grid(periodic):
    """A grid of 1000 generators and one Lloyd iteration in the starbench_voronoi
    box (``benchmarks/run_starbench_voronoi.py``'s construction at a fortieth of
    its generators and one of its two Lloyd iterations, which the host
    tessellation makes affordable here)."""
    pc = 3.086e16
    geometry = GridGeometry((-1.256 * pc,) * 3, (2.512 * pc,) * 3, (32, 32, 32), periodic)
    rng = np.random.default_rng(42)
    return voronoi.build_voronoi_grid(geometry, voronoi.uniform_random_generators(1000, rng),
                                      num_lloyd=1)


def _grids():
    grids = [("march grid", p, _march_inputs(p, 11)[1]) for p in PERIODIC]
    return grids + [("starbench-like grid", p, _starbench_like_grid(p))
                    for p in PERIODIC[:2]]


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_packed_faces_hold_the_rows_bits():
    for label, periodic, grid in _grids():
        tables = voronoi.voronoi_tables(grid, "cpu")
        real = tables.neighbors != -2
        C, K = tables.neighbors.shape
        assert tables.faces.shape == (C, K, 4) and tables.faces.dtype == torch.float32
        assert tables.face_count.shape == (C,) and tables.face_count.dtype == torch.int32
        assert tables.faces.is_contiguous() and tables.faces.data_ptr() % 16 == 0
        assert torch.equal(_bits(tables.faces[..., :3][real]), _bits(tables.normals[real]))
        assert torch.equal(_bits(tables.faces[..., 3][real]), _bits(tables.offsets[real]))
        assert not bool(tables.faces[~real].any()), (label, periodic)
        assert torch.equal(tables.face_count, real.sum(1).to(torch.int32)), (label, periodic)


def test_padding_only_trails_on_the_test_grids():
    for label, periodic, grid in _grids():
        real = grid.neighbors != -2
        assert real[:, 0].all(), (label, periodic)
        assert not (real[:, 1:] & ~real[:, :-1]).any(), (label, periodic)
        faces = real.sum(1)
        # the rows are as wide as the widest cell's faces: K6 then reads no padding
        assert faces.max() == grid.max_faces and faces.min() >= 4, (label, periodic)


def test_packed_faces_count_to_the_last_real_face():
    # padding between real faces (never built by build_voronoi_grid) is packed
    # with a zero normal and counted, so that the count still reaches the last
    # real face; an all-padding row counts 0
    neighbors = np.array([[3, -2, -1, -2], [-2, -2, -2, -2], [0, 1, 2, 5]], np.int32)
    normals = np.arange(36, dtype=np.float32).reshape(3, 4, 3) + 1.0
    offsets = np.arange(12, dtype=np.float32).reshape(3, 4) + 0.5
    faces, count = voronoi.packed_faces(neighbors, normals, offsets)
    assert count.tolist() == [3, 0, 4] and count.dtype == np.int32
    assert not faces[0, 1].any() and not faces[0, 3].any() and not faces[1].any()
    np.testing.assert_array_equal(faces[0, 2], [*normals[0, 2], offsets[0, 2]])
    np.testing.assert_array_equal(faces[2, :, :3], normals[2])


def _packed_march(tables, chi_u, pk, tally, *, eps, max_steps):
    """K6's march in plain PyTorch, as the kernel reads its tables: each face's
    normal and offset from the packed rows, the row's faces up to its count
    and no further (a face past the count gets t = +inf, which the first
    least distance never picks, as the kernel's loop never reads it), no
    neighbour test; the neighbour and shift of the exit face only."""
    K = tables.faces.shape[1]
    lanes = torch.arange(K)
    step = 0
    while step < max_steps and bool(pk.active.any()):
        cell = pk.cell.to(torch.int64)
        rows = tables.faces[cell]
        ndotd = voronoi._dot3(rows[..., :3], pk.dirn)
        ndotp = voronoi._dot3(rows[..., :3], pk.pos)
        counted = lanes[None, :] < tables.face_count[cell][:, None]
        t = torch.where((ndotd > 1e-12) & counted,
                        torch.clamp_min(rows[..., 3] - ndotp, 0.0) / torch.clamp_min(ndotd, 1e-12),
                        torch.inf)
        t_exit, k_exit = torch.min(t, dim=1)
        chi_c = torch.clamp_min(chi_u[cell], 1e-30)
        tau_cell = chi_c * t_exit
        absorbed_now = pk.active & (tau_cell >= pk.tau_left)
        l_travel = torch.where(absorbed_now, pk.tau_left / chi_c, t_exit)
        tally.index_add_(0, cell, torch.where(pk.active, l_travel * pk.weight, 0.0))
        nbr = tables.neighbors[cell, k_exit]
        shift = tables.shifts[cell, k_exit]
        crossing = pk.active & ~absorbed_now
        travel = torch.where(crossing, l_travel + eps, l_travel)
        pos = traversal._fma(pk.dirn, travel[:, None], pk.pos)
        pos = torch.where(crossing[:, None], pos + shift, pos)
        upd = pk.active
        pk = pk._replace(
            pos=torch.where(upd[:, None], pos, pk.pos),
            cell=torch.where(crossing & (nbr >= 0), nbr, pk.cell),
            tau_left=torch.where(upd, torch.where(absorbed_now, 0.0, pk.tau_left - tau_cell),
                                 pk.tau_left),
            active=pk.active & ~absorbed_now & ~(crossing & (nbr == -1)),
            absorbed=pk.absorbed | absorbed_now,
        )
        step += 1
    return tally, pk


@pytest.mark.parametrize("periodic", PERIODIC)
def test_march_over_the_packed_rows_equals_jax_bit_for_bit(periodic):
    # the premise of K6's early stop: on these grids, a march that reads the
    # packed rows and stops at the count takes JAX's steps bit for bit, and so
    # does the plain version (the kernels are held to the plain version)
    _, grid, xh, pos, d, tau, weight = _march_inputs(periodic, 31)
    chi = (3e4 * xh * 6.3e-22).astype(np.float32)
    jgrid = to_jax_grid(grid)
    tally_j, out_j = jax_voronoi.trace_packets_voronoi(
        jgrid, jnp.asarray(chi), jax_voronoi.make_voronoi_packets(jgrid, pos, d, tau, weight))
    tables = voronoi.voronoi_tables(grid, "cpu")
    pk = voronoi.make_voronoi_packets(grid, pos, d, tau, weight, device="cpu")
    C = grid.n_cells
    march = dict(eps=voronoi.march_eps(C), max_steps=voronoi.default_max_steps(C))
    chi_u = torch.tensor(chi) * grid.scale
    tally_p, out_p = _packed_march(tables, chi_u, pk, torch.zeros(C), **march)
    tally_r, out_r = voronoi.trace_packets_voronoi_reference(tables, chi_u, pk, torch.zeros(C),
                                                             **march)
    n_abs = int(np.asarray(out_j.absorbed).sum())
    assert 0 < n_abs and (n_abs < len(pos) or any(periodic))
    for name in ("pos", "cell", "tau_left", "active", "absorbed"):
        want = np.asarray(getattr(out_j, name))
        np.testing.assert_array_equal(getattr(out_p, name).numpy(), want, err_msg=name)
        np.testing.assert_array_equal(getattr(out_r, name).numpy(), want, err_msg=name)
    np.testing.assert_array_equal((tally_p * grid.scale).numpy(), np.asarray(tally_j))
    np.testing.assert_array_equal(tally_p.numpy(), tally_r.numpy())


def _cartesian_fields(n=8):
    pk = traversal.make_packets(torch.full((n, 3), 2.5), torch.tensor([[1.0, 0.0, 0.0]] * n),
                                torch.ones(n), torch.ones(n), (4, 4, 4))
    return pk._asdict()


def test_k1_wrapper_refuses_cpu_tensors():
    chi = torch.ones(64)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        trace_packets.trace_packets_cuda(chi, torch.zeros(64), _cartesian_fields(),
                                         shape=(4, 4, 4), periodic=(False,) * 3, max_steps=48)
    meta = {k: v.to("meta") for k, v in _cartesian_fields().items()}
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        trace_packets.trace_packets_cuda(chi.to("meta"), torch.zeros(64, device="meta"), meta,
                                         shape=(4, 4, 4), periodic=(False,) * 3, max_steps=48)


def test_k6_wrapper_refuses_cpu_tensors():
    _, grid, xh, pos, d, tau, weight = _march_inputs((False, False, False), 11, P=16)
    tables = voronoi.voronoi_tables(grid, "cpu")
    pk = voronoi.make_voronoi_packets(grid, pos, d, tau, weight, device="cpu")
    C = grid.n_cells
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        trace_voronoi.trace_voronoi_cuda(tables, torch.ones(C), torch.zeros(C), pk._asdict(),
                                         eps=1e-5, max_steps=10)


def test_k1_and_k6_launchers_are_typed_and_bind_nothing_at_import():
    # the signature test of test_torch_launch.py holds both against their
    # sources; K6 passes eps as a float after its ints
    assert trace_packets._TRACE_PACKETS.function is None
    assert trace_voronoi._TRACE_VORONOI.function is None
    assert trace_packets._TRACE_PACKETS.argtypes == (
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    assert trace_voronoi._TRACE_VORONOI.argtypes == (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
