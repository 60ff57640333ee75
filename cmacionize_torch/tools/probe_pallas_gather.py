"""Probe the dynamic-indexing operations: five gather and scatter kernels and
three one-call baselines.

Port of ``tools/probe_pallas_gather.py``, under the same names.  Each
``b_*`` function takes a device and returns ``(fn, args)`` with the JAX
tool's inputs (the same arithmetic progressions; the sort keys wrapped in
int32 as JAX wraps them under x64).  The five Pallas probes are hand-written kernels:

  1. take_along_axis on lanes    K12t (``kernels.probe_gather.take_along_lanes``)
  2. row gather                  K12r (``row_gather``)
  3. flat gather, 2D indices     K11r (``kernels.gather.gather2d``, the same function)
  4. sublane take_along_axis     K12s (``sublane_gather``)
  5. in-kernel scatter-add       K12a (``scatter_add``)

and the three XLA baselines are their one-call PyTorch counterparts.  Unlike
the JAX tool, nothing is caught: a kernel that fails to build or launch, or
an output that differs from the probe's function in one PyTorch expression,
raises.

Run on the card (or with ``--device cpu`` on the CPU)::

    python -m cmacionize_torch.tools.probe_pallas_gather [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from cmacionize_torch.device import require_cuda
from cmacionize_torch.kernels.gather import gather2d
from cmacionize_torch.kernels.probe_gather import (
    row_gather,
    scatter_add,
    sublane_gather,
    take_along_lanes,
)

P = 1 << 20  # 1M packets
HASH = 2654435761  # the sort keys' multiplier; the product wraps in int32
SCATTER_N = 262144  # b_scatter_add's output, as [SCATTER_N // 128, 128]


def _first(out) -> torch.Tensor:
    return out[0] if isinstance(out, tuple) else out


def timeit(fn, *args, reps=5):
    """Min over ``reps`` calls of the host seconds of ``fn(*args)`` with one
    element of its (first) output read back."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _first(out).reshape(-1)[0].item()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _arange(n, device, dtype=torch.int32):
    return torch.arange(n, dtype=dtype, device=device)


# --- 1. take_along_axis on lanes: blk [T, W], idx [T, 1] -------------------
def b_taa_lanes(device):
    T, W = 8 * 1024, 128
    blk = _arange(T * W, device, torch.float32).reshape(T, W)
    idx = _arange(T, device).reshape(T, 1) % W
    return take_along_lanes, (blk, idx)


# --- 2. row gather: table [4096, 64], idx [T] ------------------------------
def b_row_gather(device):
    T, NB, W = 8 * 1024, 4096, 64
    tab = _arange(NB * W, device, torch.float32).reshape(NB, W)
    idx = (_arange(T, device) * 7) % NB
    return row_gather, (tab, idx)


# --- 3. flat gather from 2D table via per-lane 2D indices ------------------
def flat_gather_2d(tab, hi, lo):
    """``tab[hi, lo]`` through K11r, which takes the [64, 128] index blocks as
    they are."""
    return gather2d(tab, hi, lo)


def b_flat_gather_2d(device):
    T = 8 * 1024
    NS, NL = 2048, 128  # 262144-entry table as [2048, 128]
    tab = _arange(NS * NL, device, torch.float32).reshape(NS, NL)
    flat = (_arange(T, device) * 97) % (NS * NL)
    hi = (flat // NL).reshape(T // 128, 128)
    lo = (flat % NL).reshape(T // 128, 128)
    return flat_gather_2d, (tab, hi, lo)


# --- 4. gather along sublanes: table [2048, 128], idx [8, 128] per-lane row
def b_sublane_gather(device):
    NS, NL = 2048, 128
    tab = _arange(NS * NL, device, torch.float32).reshape(NS, NL)
    idx = (_arange(8 * NL, device).reshape(8, NL) * 13) % NS
    return sublane_gather, (tab, idx)


# --- 5. per-lane scatter-add ------------------------------------------------
def scatter_add_probe(idx, val):
    """``b_scatter_add``'s function: zeros [SCATTER_N // 128, 128], then
    ``val`` added at the flat indices ``idx``."""
    return scatter_add(idx, val, (SCATTER_N // 128, 128))


def b_scatter_add(device):
    T = 8 * 1024
    idx = ((_arange(T, device) * 37) % SCATTER_N).reshape(T // 128, 128)
    val = torch.ones((T // 128, 128), dtype=torch.float32, device=device)
    return scatter_add_probe, (idx, val)


# --- 6. XLA-level baselines on same shapes ----------------------------------
def b_xla_row_gather_1m(device, n=P):
    NB, W = 4096, 64
    tab = _arange(NB * W, device, torch.float32).reshape(NB, W)
    idx = (_arange(n, device) * 7) % NB

    def run(tab, idx):
        return tab[idx]

    return run, (tab, idx)


def sort_keys(n, device):
    """``(arange(n, int32) * 2654435761) % 4096``, the product wrapped in
    int32 as JAX forms it under x64 (with x64 off the JAX tool overflows)."""
    return (_arange(n, device) * HASH) % 4096


def b_xla_argsort_1m(device, n=P):
    def run(k):
        return torch.argsort(k, stable=True)

    return run, (sort_keys(n, device),)


def b_xla_sort_pairs_1m(device, n=P):
    def run(k, v):
        keys, order = torch.sort(k, stable=True)
        return keys, v[order]

    return run, (sort_keys(n, device), _arange(n, device))


def _scatter_add_one_call(idx, val):
    out = torch.zeros(SCATTER_N, dtype=torch.float32, device=val.device)
    out.index_put_((idx.reshape(-1).long(),), val.reshape(-1), accumulate=True)
    return out.reshape(-1, 128)


# each kernel probe's function in one PyTorch expression, which its output
# must equal
EXPECTED = {
    b_taa_lanes: lambda blk, idx: torch.take_along_dim(blk, idx.long(), 1),
    b_row_gather: lambda tab, idx: tab[idx.long()],
    b_flat_gather_2d: lambda tab, hi, lo: tab[hi.long(), lo.long()],
    b_sublane_gather: lambda tab, idx: torch.gather(tab, 0, idx.long()),
    b_scatter_add: _scatter_add_one_call,
}

PROBES = (
    ("1 take_along_axis lanes [8k,128]", b_taa_lanes),
    ("2 row gather tab[idx] [8k rows of 64]", b_row_gather),
    ("3 flat gather 2D idx [8k from 262k]", b_flat_gather_2d),
    ("4 sublane take_along_axis [8x128 from 2048x128]", b_sublane_gather),
    ("5 per-lane scatter-add [8k into 262k]", b_scatter_add),
    ("6 XLA row gather 1M x 64", b_xla_row_gather_1m),
    ("7 XLA argsort 1M int32", b_xla_argsort_1m),
    ("8 XLA sort_key_val 1M", b_xla_sort_pairs_1m),
)


def probe(name, make, device) -> float:
    """Build, run and time one probe on ``device``, print its line and return
    its seconds; a kernel probe's output must equal :data:`EXPECTED`'s."""
    fn, args = make(device)
    out = fn(*args)
    suffix = ""
    if make in EXPECTED:
        if not torch.equal(out, EXPECTED[make](*args)):
            raise RuntimeError(f"probe_pallas_gather: {name} differs from its plain version")
        suffix = "  correct=True"
    t = timeit(fn, *args)
    print(f"OK   {name}: {t*1e3:.3f} ms{suffix}", flush=True)
    return t


def main(device=None) -> dict:
    """Run every probe on ``device`` (the card unless ``device="cpu"``) and
    return {name: seconds}."""
    device = require_cuda() if device is None else torch.device(device)
    return {name: probe(name, make, device) for name, make in PROBES}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, or the card (default)")
    main(parser.parse_args().device)
