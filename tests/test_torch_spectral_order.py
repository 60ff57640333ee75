"""K2's premise for a packet order on the CPU, and K2's wrapper on a
stand-in library.

An order of the active packets (by bin, or by bin and direction, as
``kernels/trace_octree_spectral.py:packet_order`` gives K5s) and warp-summed
deposits may not change a packet's final state: each packet is marched
alone, in its own slot.  So the JAX march of a permuted batch must give the
permuted final states bit for bit and the same tally within f32 round-off,
and the plain version, K2's twin, must agree with it.  On the card neither
piece paid for K2 (PERF.md, section 6), so K2 marches packet i in place; the
premise stays for the next try.  The wrapper is held to its refusals and
argument table on a stand-in library (the kernel itself runs in
``test_torch_cuda.py``).
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch.kernels import LAUNCHES, launch
from cmacionize_torch.kernels import trace_octree_spectral as k5s_ops
from cmacionize_torch.kernels import trace_packets_spectral as k2_ops
from cmacionize_torch.ops import traversal as ttr
from cmacionize_tpu.ops import traversal as jtr

SHAPE = (16, 16, 16)
NCELL = 16**3
N_BINS = 8
STATE = ("px", "py", "pz", "cx", "cy", "cz", "tau_left", "active", "absorbed")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed: int, n: int, active_share: float):
    """A lexington-like opacity and packets from the centre in random bins
    (numpy, f32), a share of them active, as a re-emission generation hands
    them in."""
    rng = np.random.default_rng(seed)
    chi_h = (rng.uniform(0.0, 2.0, NCELL) * np.where(rng.uniform(size=NCELL) < 0.5, 1e-3, 1)
             ).astype(np.float32)
    chi_he = rng.uniform(0.0, 0.2, NCELL).astype(np.float32)
    cos = rng.uniform(-1, 1, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    s = np.sqrt(1 - cos**2)
    d = np.stack([s * np.cos(phi), s * np.sin(phi), cos], 1).astype(np.float32)
    p = (np.array([8.0, 8.0, 8.0]) + 1e-4 * d).astype(np.float32)
    tau = (-np.log1p(-rng.uniform(size=n))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    fbin = rng.integers(0, N_BINS, n).astype(np.int32)
    sh = rng.uniform(0.2, 1.5, n).astype(np.float32)
    she = rng.uniform(0.0, 1.5, n).astype(np.float32)
    active = rng.uniform(size=n) < active_share
    return chi_h, chi_he, (p, d, tau, w, sh, she, fbin), active


def _jax_march(chi_h, chi_he, fields, active, perm):
    jp = jtr.make_spectral_packets(*(jnp.asarray(f[perm]) for f in fields[:2]),
                                   *(jnp.asarray(f[perm]) for f in fields[2:]), SHAPE)
    jp = jp._replace(active=jnp.asarray(active[perm]))
    tally, out = jtr.trace_packets_spectral(
        jnp.asarray(chi_h), jnp.asarray(chi_he), jp, jnp.zeros(N_BINS * NCELL, jnp.float32),
        shape=SHAPE, n_bins=N_BINS)
    return np.asarray(tally), {f: np.asarray(getattr(out, f)) for f in STATE}


def _plain_march(chi_h, chi_he, fields, active, perm):
    tp = ttr.make_spectral_packets(*(torch.tensor(f[perm]) for f in fields[:2]),
                                   *(torch.tensor(f[perm]) for f in fields[2:]), SHAPE)
    tp = tp._replace(active=torch.tensor(active[perm]))
    tally, out = ttr.trace_packets_spectral(
        torch.tensor(chi_h), torch.tensor(chi_he), tp, torch.zeros(N_BINS * NCELL),
        shape=SHAPE, n_bins=N_BINS)
    return tally.numpy(), {f: getattr(out, f).numpy() for f in STATE}


def _packet_order_of(fields, active) -> np.ndarray:
    p, d, tau, w, sh, she, fbin = fields
    keys = {"dx": torch.tensor(d[:, 0]), "dy": torch.tensor(d[:, 1]),
            "dz": torch.tensor(d[:, 2]), "fbin": torch.tensor(fbin),
            "active": torch.tensor(active)}
    order, n_active = k5s_ops.packet_order(keys, N_BINS)
    assert int(n_active) == int(active.sum())
    return order.numpy()


@pytest.mark.parametrize("active_share", [1.0, 0.3])
@pytest.mark.parametrize("which", ["packet_order", "random"])
def test_permuted_packets_give_the_permuted_states(active_share, which):
    chi_h, chi_he, fields, active = _inputs(3, 6000, active_share)
    n = len(active)
    perm = (_packet_order_of(fields, active) if which == "packet_order"
            else np.random.default_rng(4).permutation(n))
    identity = np.arange(n)
    tally_j, out_j = _jax_march(chi_h, chi_he, fields, active, identity)
    tally_jp, out_jp = _jax_march(chi_h, chi_he, fields, active, perm)
    tally_t, out_t = _plain_march(chi_h, chi_he, fields, active, perm)
    for f in STATE:
        np.testing.assert_array_equal(out_jp[f], out_j[f][perm], err_msg=f)
        np.testing.assert_array_equal(out_t[f], out_jp[f], err_msg=f)
    assert 0 < out_j["absorbed"].sum() < active.sum()
    scale = np.abs(tally_j).sum()
    assert np.abs(tally_jp - tally_j).sum() <= 1e-6 * scale
    assert np.abs(tally_t - tally_jp).sum() <= 1e-6 * scale


# -- the wrapper on a stand-in library --------------------------------------------------------------


class _Function:
    """A stand-in for a library's launcher: records its calls, returns 0."""

    def __init__(self):
        self.calls, self.argtypes, self.restype = [], None, None

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def _batch(n: int, active_share: float = 1.0):
    chi_h, chi_he, fields, active = _inputs(6, n, active_share)
    tp = ttr.make_spectral_packets(*(torch.tensor(f) for f in fields[:2]),
                                   *(torch.tensor(f) for f in fields[2:]), SHAPE)
    return torch.tensor(chi_h), torch.tensor(chi_he), tp._replace(active=torch.tensor(active))


def test_k2_wrapper_refuses_what_the_kernel_does_not_take():
    chi_h, chi_he, tp = _batch(64)
    fields = tp._asdict()
    kw = dict(shape=SHAPE, n_bins=N_BINS, periodic=(False,) * 3, max_steps=96)
    with pytest.raises(ValueError, match="needs CUDA tensors, got cpu"):
        k2_ops.trace_packets_spectral_cuda(chi_h, chi_he, torch.zeros(N_BINS * NCELL), fields,
                                           **kw)


def test_k2_wrapper_passes_its_argument_table(monkeypatch):
    """On a stand-in library, device -1 current (a CPU tensor's index), raw
    stream 1000 + index, the device checks passed."""
    chi_h, chi_he, tp = _batch(1000, 0.4)
    fields = tp._asdict()
    tally = torch.zeros(N_BINS * NCELL)
    kw = dict(shape=SHAPE, n_bins=N_BINS, periodic=(True, False, True), max_steps=96)
    functions = {}

    class Library:
        def __getattr__(self, symbol):
            return functions.setdefault(symbol, _Function())

    monkeypatch.setattr(launch, "load_library", lambda name: Library())
    monkeypatch.setattr(launch, "raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(launch, "current_device", lambda: -1)
    monkeypatch.setattr(k2_ops._LAUNCH, "function", None)
    monkeypatch.setattr(k2_ops, "check_tensors", lambda name, device, arrays, expected: None)
    before = LAUNCHES["trace_packets_spectral"]
    k2_ops.trace_packets_spectral_cuda(chi_h, chi_he, tally, fields, **kw)
    assert LAUNCHES["trace_packets_spectral"] == before + 1
    (call,) = functions["cmi_trace_packets_spectral"].calls
    arrays = {"chi_h": chi_h, "chi_he": chi_he, "tally": tally, **fields}
    assert list(call[:19]) == [arrays[f].data_ptr() for f in k2_ops._POINTER_ORDER]
    assert list(call[19:26]) == [1000, *SHAPE, N_BINS, 0b101, 96]
    assert call[26] == 999
    # no packet: no launch
    empty = {k: v[:0] for k, v in fields.items()}
    k2_ops.trace_packets_spectral_cuda(chi_h, chi_he, tally, empty, **kw)
    assert LAUNCHES["trace_packets_spectral"] == before + 1
    with pytest.raises(ValueError, match="int32"):
        k2_ops.trace_packets_spectral_cuda(chi_h, chi_he, tally, fields,
                                           **dict(kw, n_bins=2**31 // NCELL + 1))
