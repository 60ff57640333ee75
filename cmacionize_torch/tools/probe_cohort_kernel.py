"""Probe the kernel mechanics needed by the cohort traversal design.

Port of ``tools/probe_cohort_kernel.py``, under the same names:

A: a grid of 2048 steps with one scalar-prefetched count per step, most of
   them skipped: K14a (``kernels.probe_cohort.count_positive``), one block
   that counts the positive counts, since blocks do not run in order here;
B: 1000 steps of a take_along_axis lane gather on [8, 128]: K14b
   (``lane_gather_loop``);
C: 976 chunks of [8, 16, 128] streamed HBM -> VMEM -> HBM with row 2 of each
   item replaced by row 0 + row 1 and the sum of row 0 · row 1: K14c
   (``stream_rows``), one pass of 16-byte loads and stores;
D: the one-hot deposit at W = 128 over 8 × 976 steps: K13h
   (``kernels.probe_deposit.shifted_histogram``), the kernel of
   ``probe_deposit``'s D2-D7.

The JAX tool reports B per inner step; here each line is the whole call.
Timing and failures as in :mod:`cmacionize_torch.tools.probe_deposit`.

Run on the card (or with ``--device cpu`` on the CPU)::

    python -m cmacionize_torch.tools.probe_cohort_kernel [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from cmacionize_torch.device import require_cuda
from cmacionize_torch.kernels.probe_cohort import count_positive, lane_gather_loop, stream_rows
from cmacionize_torch.kernels.probe_deposit import shifted_histogram
from cmacionize_torch.tools.probe_deposit import HISTOGRAM_KERNEL, lane_indices, run_bodies

NCHUNK = 976
GRID = 2048  # run_a's grid: one count per step
GATHER_STEPS = 1000  # run_b's loop


def run_a(cnt: torch.Tensor) -> torch.Tensor:
    """The number of positive counts in every cell of [8, 128]: K14a."""
    return count_positive(cnt)


def run_b(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``Σ_{i<1000} tab[r, (idx[r, c] + i) mod 128]``: K14b."""
    return lane_gather_loop(tab, idx, GATHER_STEPS)


def run_c(pk: torch.Tensor):
    """``pk`` with row 2 = row 0 + row 1, and the sum of row 0 · row 1 as
    [1, 1]: K14c."""
    return stream_rows(pk)


def run_d(dep: torch.Tensor, lidx: torch.Tensor) -> torch.Tensor:
    """D's histogram over 8 · NCHUNK steps, as [1, 128]: K13h."""
    return shifted_histogram(dep, lidx, 8 * NCHUNK).view(1, 128)


def skip_inputs(device):
    return (torch.zeros(GRID, dtype=torch.int32, device=device),)


def run_inputs(device):
    return (torch.ones(GRID, dtype=torch.int32, device=device),)


def b_inputs(device):
    """``tab = arange(8·128, f32)``, ``idx = (arange(8·128) * 13) % 128``,
    both [8, 128]."""
    tab = torch.arange(8 * 128, dtype=torch.float32, device=device).reshape(8, 128)
    return tab, lane_indices((8, 128), device)


def c_inputs(device):
    """``pk = ones([NCHUNK·8, 16, 128])``, 64 MB."""
    return (torch.ones((NCHUNK * 8, 16, 128), dtype=torch.float32, device=device),)


def d_inputs(device):
    """``dep = ones([8, 128])`` and B's ``idx``."""
    return torch.ones((8, 128), dtype=torch.float32, device=device), lane_indices((8, 128),
                                                                                 device)


BODIES = (
    ("A grid 2048 all-skip", run_a, skip_inputs, "K14a count_positive"),
    ("A grid 2048 all-run", run_a, run_inputs, "K14a count_positive"),
    ("B take_along 8x128 x1000", run_b, b_inputs, "K14b lane_gather_loop"),
    ("C DMA stream 976 x [8,16,128] sync", run_c, c_inputs, "K14c stream_rows"),
    ("D onehot W=128 K=8 x976", run_d, d_inputs, HISTOGRAM_KERNEL),
)


def main(device=None) -> dict:
    """Run every probe on ``device`` (the card unless ``device="cpu"``) and
    return {name: milliseconds}."""
    device = require_cuda() if device is None else torch.device(device)
    return run_bodies(BODIES, device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, or the card (default)")
    main(parser.parse_args().device)
