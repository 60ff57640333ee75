"""Microbenchmark: the tally deposit (scatter-add) and opacity gather options.

Port of ``tools/microbench_scatter.py:main``, the per-index gather and
scatter cost that motivates the cone-marched traversal.  Each XLA variant of
the JAX tool has its PyTorch counterpart under the same name and print
format:

  1. scatter-add, random indices (``index_add``)
  2. scatter-add, sorted indices
  3. argsort, then a segment sum
  4. segment sum on presorted indices
  5. gather (opacity lookup) and sum, random and sorted indices

and the tool's two Pallas gathers are the hand-written kernels K11
(``kernels.gather.gather``) and K11r (``kernels.gather.gather2d``), each
checked against the plain expression of the JAX tool's ``ref``.  Unlike the
JAX tool, nothing is caught: a kernel that fails to build or launch, or a
``correct=False``, raises.

Run on the card (or with ``--device cpu`` on the CPU)::

    python -m cmacionize_torch.tools.microbench_scatter [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from cmacionize_torch.device import require_cuda
from cmacionize_torch.kernels.gather import gather, gather2d

LANES = 128  # the row width of the 2D table


def timed(fn, *args, sync, n=20, warmup=3):
    """(seconds per call, last output) of ``fn(*args)``, host clock around
    ``n`` calls after ``warmup``, each end synchronized by ``sync``."""
    for _ in range(warmup):
        out = fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    sync()
    return (time.perf_counter() - t0) / n, out


def segment_sum(v, i_sorted, num_segments):
    """Sums of ``v`` over the runs of equal sorted indices, ``[num_segments]``."""
    lengths = torch.bincount(i_sorted, minlength=num_segments)
    return torch.segment_reduce(v, "sum", lengths=lengths)


def main(device=None, n_packets: int = 1 << 20, n_cell: int = 64**3) -> dict:
    """Time every variant at ``n_packets`` indices into ``n_cell`` cells on
    ``device`` (the card unless ``device="cpu"``), print one line each, and
    return {name: seconds per call}."""
    device = require_cuda() if device is None else torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    P = n_packets
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    idx = torch.randint(0, n_cell, (P,), generator=generator, device=device,
                        dtype=torch.int32)
    idx_sorted = torch.sort(idx).values
    val = torch.rand(P, generator=generator, device=device, dtype=torch.float32)
    tally = torch.zeros(n_cell, dtype=torch.float32, device=device)

    def scatter(t, i, v):
        return t.index_add(0, i, v)

    def sort_then_segsum(t, i, v):
        order = torch.argsort(i)
        return t + segment_sum(v[order], i[order], n_cell)

    def segsum_sorted(t, i, v):
        return t + segment_sum(v, i, n_cell)

    def gather_sum(t, i):
        return torch.sum(t[i])

    seconds = {}

    def report(name, dt, suffix=""):
        seconds[name] = dt
        print(f"{name:24s} {dt*1e3:8.3f} ms   {P/dt/1e6:9.1f} M elem/s{suffix}", flush=True)

    for name, fn, args in [
        ("scatter-add random", scatter, (tally, idx, val)),
        ("scatter-add sorted", scatter, (tally, idx_sorted, val)),
        ("argsort+segsum", sort_then_segsum, (tally, idx, val)),
        ("segsum presorted", segsum_sorted, (tally, idx_sorted, val)),
        ("gather random", gather_sum, (tally, idx)),
        ("gather sorted", gather_sum, (tally, idx_sorted)),
    ]:
        dt, _ = timed(fn, *args, sync=sync)
        report(name, dt)

    # K11: per-lane gather from the 1D table
    tbl = tally + 1.0
    dt, out = timed(gather, tbl, idx, sync=sync)
    ok = bool(torch.equal(out, tbl[idx]))
    report("K11 gather 1d", dt, f"  correct={ok}")
    if not ok:
        raise RuntimeError("microbench_scatter: K11 gather 1d differs from tbl[idx]")

    # K11r: the same lookups as (row, lane) pairs into a [n_cell/128, 128] table
    rows_n = n_cell // LANES
    tbl2 = (tally + 1.0).reshape(rows_n, LANES) + torch.arange(
        rows_n * LANES, dtype=torch.float32, device=device).reshape(rows_n, LANES)
    rows = idx // LANES
    lanes = idx % LANES
    dt, out = timed(gather2d, tbl2, rows, lanes, sync=sync)
    ok = bool(torch.equal(out, tbl2.reshape(-1)[idx]))
    report("K11r gather 2d", dt, f"  correct={ok}")
    if not ok:
        raise RuntimeError("microbench_scatter: K11r gather 2d differs from tbl2[rows, lanes]")
    return seconds


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, or the card (default)")
    main(parser.parse_args().device)
