"""K6s's premises on the CPU: a march of permuted packets, and K6s's wrapper
on a stand-in library.

K6s (``csrc/trace_voronoi_spectral.cu``) reads K6's packed face rows and
sums each run of a warp's deposits into one tally slot ``fbin·C + cell``
before its atomic; an order of the active packets (by bin and then
direction, ``kernels/trace_octree_spectral.py:packet_order``, K5s's) was
measured and not kept (PERF.md, section 6).  None of these may change a
packet's final state: each packet is marched alone, in its own slot.  So
the JAX march of a permuted batch (in ``packet_order``'s order, or at
random) must give the permuted final states bit for bit and the same tally
within f32 round-off, and the plain version, K6s's twin, must agree with
it, on ``test_torch_voronoi.py``'s grids.  The wrapper is held to its
refusals and argument table on a stand-in library (the kernel itself runs
in ``test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_voronoi import _march_inputs, to_jax_grid

from cmacionize_torch.kernels import LAUNCHES, launch
from cmacionize_torch.kernels import trace_octree_spectral as k5s_ops
from cmacionize_torch.kernels import trace_voronoi_spectral as k6s_ops
from cmacionize_torch.models import voronoi
from cmacionize_tpu.models import voronoi as jax_voronoi

N_BINS = 6
STATE = ("pos", "cell", "tau_left", "active", "absorbed")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spectral_inputs(periodic, seed: int, active_share: float):
    """``test_torch_voronoi.py``'s grid and bubble, packets in random bins
    with random cross sections, a share of them active (numpy)."""
    rng, grid, xh, pos, d, tau, weight = _march_inputs(periodic, seed)
    P = len(pos)
    fields = dict(pos=pos, d=d, tau=tau, weight=weight,
                  sig_h=rng.uniform(0.5e-22, 6.3e-22, P).astype(np.float32),
                  sig_he=rng.uniform(0.0, 7e-22, P).astype(np.float32),
                  fbin=rng.integers(0, N_BINS, P).astype(np.int32),
                  active=rng.uniform(size=P) < active_share)
    chi = ((1e8 * xh).astype(np.float32), (1e7 * np.sqrt(xh)).astype(np.float32))
    return grid, chi, fields


def _torch_batch(grid, f, perm):
    pk = voronoi.make_voronoi_packets(grid, f["pos"][perm], f["d"][perm], f["tau"][perm],
                                      f["weight"][perm], device="cpu")
    return voronoi.SpectralVoronoiPacketBatch(
        *pk[:5], torch.tensor(f["sig_h"][perm]), torch.tensor(f["sig_he"][perm]),
        torch.tensor(f["fbin"][perm]), torch.tensor(f["active"][perm]), pk.absorbed)


def _jax_march(grid, chi, f, perm):
    jgrid = to_jax_grid(grid)
    jpk = jax_voronoi.make_voronoi_packets(jgrid, f["pos"][perm], f["d"][perm], f["tau"][perm],
                                           f["weight"][perm])
    jspk = jax_voronoi.SpectralVoronoiPacketBatch(
        *jpk[:5], jnp.asarray(f["sig_h"][perm]), jnp.asarray(f["sig_he"][perm]),
        jnp.asarray(f["fbin"][perm]), jnp.asarray(f["active"][perm]), jpk.absorbed)
    tally, out = jax_voronoi.trace_packets_voronoi_spectral(
        jgrid, jnp.asarray(chi[0]), jnp.asarray(chi[1]), jspk, n_bins=N_BINS)
    return np.asarray(tally), {name: np.asarray(getattr(out, name)) for name in STATE}


def _order(f) -> np.ndarray:
    d = torch.tensor(f["d"].astype(np.float32))
    keys = {"dx": d[:, 0], "dy": d[:, 1], "dz": d[:, 2], "fbin": torch.tensor(f["fbin"]),
            "active": torch.tensor(f["active"])}
    order, n_active = k5s_ops.packet_order(keys, N_BINS)
    assert int(n_active) == int(f["active"].sum())
    return order.numpy()


@pytest.mark.parametrize("periodic", [(False, False, False), (True, True, True)])
@pytest.mark.parametrize("active_share", [1.0, 0.3])
@pytest.mark.parametrize("which", ["packet_order", "random"])
def test_permuted_packets_give_the_permuted_states(periodic, active_share, which):
    grid, chi, f = _spectral_inputs(periodic, 21, active_share)
    n = len(f["active"])
    perm = _order(f) if which == "packet_order" else np.random.default_rng(4).permutation(n)
    tally_j, out_j = _jax_march(grid, chi, f, np.arange(n))
    tally_jp, out_jp = _jax_march(grid, chi, f, perm)
    tally_t, out_t = voronoi.trace_packets_voronoi_spectral(
        grid, torch.tensor(chi[0]), torch.tensor(chi[1]), _torch_batch(grid, f, perm),
        n_bins=N_BINS)
    for name in STATE:
        np.testing.assert_array_equal(out_jp[name], out_j[name][perm], err_msg=name)
        np.testing.assert_array_equal(getattr(out_t, name).numpy(), out_jp[name], err_msg=name)
    assert 0 < out_j["absorbed"].sum() <= f["active"].sum()
    scale = np.abs(tally_j).sum()
    assert np.abs(tally_jp - tally_j).sum() <= 1e-6 * scale
    assert np.abs(tally_t.numpy() - tally_jp).sum() <= 1e-6 * scale


# -- the wrapper on a stand-in library --------------------------------------------------------------


class _Function:
    """A stand-in for a library's launcher: records its calls, returns 0."""

    def __init__(self):
        self.calls, self.argtypes, self.restype = [], None, None

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def _march_arguments():
    grid, chi, f = _spectral_inputs((False, False, False), 23, 0.4)
    n = len(f["active"])
    tables = voronoi.voronoi_tables(grid, "cpu")
    fields = _torch_batch(grid, f, np.arange(n))._asdict()
    tally = torch.zeros(N_BINS * grid.n_cells)
    return grid, tables, torch.tensor(chi[0]), torch.tensor(chi[1]), tally, fields


def test_k6s_wrapper_refuses_what_the_kernel_does_not_take():
    grid, tables, chi_h, chi_he, tally, fields = _march_arguments()
    kw = dict(n_bins=N_BINS, eps=1e-5, max_steps=100)
    with pytest.raises(ValueError, match="needs CUDA tensors, got cpu"):
        k6s_ops.trace_voronoi_spectral_cuda(tables, chi_h, chi_he, tally, fields, **kw)


def test_k6s_wrapper_passes_its_argument_table(monkeypatch):
    """On a stand-in library, device -1 current (a CPU tensor's index), raw
    stream 1000 + index, the shared march check given CPU tensors."""
    grid, tables, chi_h, chi_he, tally, fields = _march_arguments()
    functions = {}

    class Library:
        def __getattr__(self, symbol):
            return functions.setdefault(symbol, _Function())

    monkeypatch.setattr(launch, "load_library", lambda name: Library())
    monkeypatch.setattr(launch, "raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(launch, "current_device", lambda: -1)
    monkeypatch.setattr(k6s_ops._LAUNCH, "function", None)
    C, K = tables.neighbors.shape
    n = fields["cell"].numel()
    monkeypatch.setattr(k6s_ops, "check_march_inputs", lambda *args: (n, C, K))
    before = LAUNCHES["trace_voronoi_spectral"]
    k6s_ops.trace_voronoi_spectral_cuda(tables, chi_h, chi_he, tally, fields, n_bins=N_BINS,
                                        eps=2.5e-6, max_steps=77)
    assert LAUNCHES["trace_voronoi_spectral"] == before + 1
    (call,) = functions["cmi_trace_voronoi_spectral"].calls
    arrays = {**tables._asdict(), **fields, "chi_h": chi_h, "chi_he": chi_he, "tally": tally}
    assert list(call[:17]) == [arrays[f].data_ptr() for f in k6s_ops._POINTER_ORDER]
    assert call[:2] == (tables.faces.data_ptr(), tables.face_count.data_ptr())
    assert list(call[17:21]) == [n, C, K, 77]
    assert call[21] == pytest.approx(2.5e-6) and call[22] == 999
    with pytest.raises(ValueError, match="int32"):
        k6s_ops.trace_voronoi_spectral_cuda(tables, chi_h, chi_he, tally, fields,
                                            n_bins=2**31 // C + 1, eps=2.5e-6, max_steps=77)
