"""Probe factorized deposit formulations (W = 128 as 16 x 8) in march layout.

Port of ``tools/probe_deposit2.py``, under the same names.  Its bodies D8 and
D8b compute the shifted histogram of ``probe_deposit`` with the 128 cells
factored as hi = c >> 3, lo = c & 7 by one-hot contractions on the TPU's
matrix unit, out [16, 8]: on the card that is K13h's [128] viewed as
[16, 8].  D12 fills [1, 128] with dep[0, 0] (a reshape check on the TPU):
K13f (``kernels.probe_deposit.fill_first``).  W2 runs NSTEP Amanatides-Woo
incremental DDA steps per lane: K13w (``dda_incremental``).  Timing and
failures as in :mod:`cmacionize_torch.tools.probe_deposit`.

Run on the card (or with ``--device cpu`` on the CPU)::

    python -m cmacionize_torch.tools.probe_deposit2 [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from cmacionize_torch.device import require_cuda
from cmacionize_torch.kernels.probe_deposit import dda_incremental, fill_first, shifted_histogram
from cmacionize_torch.tools.probe_deposit import HISTOGRAM_KERNEL, march_inputs, run_bodies

NSTEP = 7808


def histogram_factored(dep: torch.Tensor, lidx: torch.Tensor) -> torch.Tensor:
    """The bodies D8 and D8b: K13h over NSTEP steps, as [16, 8]."""
    return shifted_histogram(dep, lidx, NSTEP).view(16, 8)


def fill_row(dep: torch.Tensor, lidx: torch.Tensor) -> torch.Tensor:
    """The body D12: K13f (``lidx`` is not read)."""
    return fill_first(dep)


def w2_inputs(device):
    """``dep_m * 0.5``, ``dep_m * 0.3``."""
    dep_m, _ = march_inputs(device)
    return dep_m * 0.5, dep_m * 0.3


def dda_incremental_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The W2 body: K13w over NSTEP steps."""
    return dda_incremental(a, b, NSTEP)


BODIES = (
    ("D8 factorized dot_general 2-dim contract", histogram_factored, march_inputs,
     HISTOGRAM_KERNEL),
    ("D8b per-s matmul loop", histogram_factored, march_inputs, HISTOGRAM_KERNEL),
    ("D12 reshape (16,8)->(1,128)", fill_row, march_inputs, "K13f fill_first"),
    ("W2 incremental DDA", dda_incremental_steps, w2_inputs, "K13w dda_incremental"),
)


def main(device=None) -> dict:
    """Run every body on ``device`` (the card unless ``device="cpu"``) and
    return {name: milliseconds}."""
    device = require_cuda() if device is None else torch.device(device)
    return run_bodies(BODIES, device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, or the card (default)")
    main(parser.parse_args().device)
