"""Find the fastest in-kernel deposit (histogram) formulation.

Port of ``tools/probe_deposit.py``, under the same names.  The target is the
deposit of a DDA step: dep[t] accumulated into acc[lidx[t]] for T = 1024
packets over W = 128 cells, NSTEP = 7808 step-tiles per phase, the cell of
step i being (lidx[t] + i) mod 128.  The JAX tool's six Pallas bodies D2-D7
differ only in how the TPU reduces a one-hot block (a multiply or a
``where``, a sum per step or a deferred one, an MXU dot) and in the packets'
layout ([1024, 1] or the march's [8, 128]); they compute one function, which
one hand-written kernel computes on the card: K13h
(``kernels.probe_deposit.shifted_histogram``), whose [128] is shown as
[1, 128].  The E body, NSTEP loop-carried DDA steps per lane with no
deposit, is K13e (``dda_math``).  Each body's line names its kernel.

Each body takes the JAX tool's inputs (the same arithmetic progressions) and
is timed by CUDA events on the card (the mean of 20 calls after a warm-up) or
by the host clock on the CPU (one call of the plain version).  Unlike the
JAX tool, nothing is caught and no host latency is subtracted: a kernel that
fails to build or launch raises.

Run on the card (or with ``--device cpu`` on the CPU)::

    python -m cmacionize_torch.tools.probe_deposit [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from cmacionize_torch.device import require_cuda
from cmacionize_torch.kernels.probe_deposit import dda_math, shifted_histogram

NSTEP = 7808
REPS = 20  # timed calls on the card, after one warm-up


def time_ms(fn, *args) -> float:
    """Milliseconds per call of ``fn(*args)``: on the card the mean of
    :data:`REPS` calls after a warm-up, by CUDA events; on the CPU one call,
    by the host clock."""
    if args[0].device.type == "cpu":
        t0 = time.perf_counter()
        fn(*args)
        return (time.perf_counter() - t0) * 1e3
    fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in f32 as JAX defines it:
    ``start·(1 − step) + stop·step`` with ``step = iota / (num − 1)``, the
    endpoint appended.  XLA may fold and fuse it otherwise (on the CPU it
    gives other last bits in some entries)."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / torch.full(
        (div,), float(div), dtype=torch.float32, device=device)
    start_t = torch.full((div,), start, dtype=torch.float32, device=device)
    stop_t = torch.full((div,), stop, dtype=torch.float32, device=device)
    body = start_t * (1.0 - step) + stop_t * step
    return torch.cat((body, stop_t[:1]))


def lane_indices(shape, device) -> torch.Tensor:
    """``(arange(8·128, int32) * 13) % 128`` in ``shape``, the tools' lane
    indices."""
    return (torch.arange(8 * 128, dtype=torch.int32, device=device) * 13 % 128).reshape(shape)


def sublane_inputs(device):
    """``dep_s``, ``lidx_s``: the packets on sublanes, [1024, 1]."""
    return torch.ones((1024, 1), dtype=torch.float32, device=device), lane_indices((1024, 1),
                                                                                  device)


def march_inputs(device):
    """``dep_m``, ``lidx_m``: the packets in the march's [8, 128] layout."""
    return torch.ones((8, 128), dtype=torch.float32, device=device), lane_indices((8, 128),
                                                                                 device)


def e_inputs(device):
    """``a``, ``a * 0.5`` with ``a = linspace(0.1, 0.9, 1024)`` as [8, 128]."""
    a = linspace(0.1, 0.9, 8 * 128, device).reshape(8, 128)
    return a, a * 0.5


def histogram_row(dep: torch.Tensor, lidx: torch.Tensor) -> torch.Tensor:
    """The bodies D2-D7: K13h over NSTEP steps, as [1, 128]."""
    return shifted_histogram(dep, lidx, NSTEP).view(1, 128)


def dda_math_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The E body: K13e over NSTEP steps."""
    return dda_math(a, b, NSTEP)


HISTOGRAM_KERNEL = "K13h shifted_histogram, one kernel for D2-D8b and run_d"

# (the JAX tool's line, the port's function, its inputs, the kernel's line)
BODIES = (
    ("D2 sublane-packets mult+sum", histogram_row, sublane_inputs, HISTOGRAM_KERNEL),
    ("D3 sublane-packets where+sum", histogram_row, sublane_inputs, HISTOGRAM_KERNEL),
    ("D4 defer reduce", histogram_row, sublane_inputs, HISTOGRAM_KERNEL),
    ("D5 march-layout where", histogram_row, march_inputs, HISTOGRAM_KERNEL),
    ("D6 march->sublane reshape", histogram_row, march_inputs, HISTOGRAM_KERNEL),
    ("D7 MXU reduce", histogram_row, sublane_inputs, HISTOGRAM_KERNEL),
    ("E DDA math x NSTEP", dda_math_steps, e_inputs, "K13e dda_math"),
)


def run_bodies(bodies, device) -> dict:
    """Run and time each body on ``device``, print its line and return
    {name: milliseconds}."""
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    times = {}
    for name, fn, inputs, kernel in bodies:
        times[name] = time_ms(fn, *inputs(device))
        print(f"OK   {name}: {times[name]:.4f} ms ({clock})  [{kernel}]", flush=True)
    return times


def main(device=None) -> dict:
    """Run every body on ``device`` (the card unless ``device="cpu"``) and
    return {name: milliseconds}."""
    device = require_cuda() if device is None else torch.device(device)
    return run_bodies(BODIES, device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, or the card (default)")
    main(parser.parse_args().device)
