"""Where a kernel's call goes: per call back to back, on the device alone,
and on the host step by step.

For K11r (``gather2d``) of :mod:`cmacionize_torch.kernels.gather`, K12s
(``sublane_gather``), K12t (``take_along_lanes``), K12r (``row_gather``) and
K12a (``scatter_add``) of :mod:`cmacionize_torch.kernels.probe_gather`, K13f
(``fill_first``) of :mod:`cmacionize_torch.kernels.probe_deposit` and K14c
(``stream_rows``) of :mod:`cmacionize_torch.kernels.probe_cohort`, and beside
each the one PyTorch call of its function (``tab[hi, lo]``, ``torch.gather``,
``torch.take_along_dim``, ``tab[idx]``, ``zeros`` + ``index_put_``,
``dep.reshape(-1)[:1].expand(1, 128).clone()``, ``pk.clone()``, K14c's bytes
bar its sum), at the tools' shapes (``tools/probe_pallas_gather.py``, K11r's
flat 2D probe among them; ``tools/probe_deposit.py``'s [8, 128] packets;
``tools/probe_cohort_kernel.py``) and at a larger one (2^20 lookups, K11r's
as 1D rows and lanes into [2048, 128]; K14c twice the tool's 7808 items;
K13f, which reads one element, none):

  (a) ms per call of 50 calls back to back between two CUDA events (the
      figure ``chip_smoke.py:time_cuda`` gives: the longer of the host's
      enqueue and the device's work);
  (b) ms per call on the device alone: 50 calls captured into a CUDA graph,
      its replays timed with events;
  (c) host µs per call: ``time.perf_counter_ns`` over many calls with no
      synchronise.  The host's clock is shared with other work, so each
      figure is the least per call over ``ROUNDS`` windows taken in turns
      (every call or step of a measurement in each round), after a warm-up.

The host steps of the two launch paths are timed alone the same way: those of
the ctypes path that the older wrappers use (``kernels/gather.py``:
``_check``, ``torch.empty``, ``_function``, the ``Stream`` object,
``torch.cuda.device``, the pointers, the ctypes call with and without its
launch, the counter) on K12a, which stays on it as the control; those of
:mod:`kernels.launch` (the wrapper's own checks, the output's allocation, the
pointers, the raw stream, the current device, the typed ctypes call with and
(where the launcher takes a count) without its launch, the counter) on K11r,
K12s, K12t, K12r and K13f.  K14c's calls are
bound by the device, so its host steps are not split; :func:`main` splits
its device time by the name of each kernel, memset or copy in a
``torch.profiler`` window (``measure``, which ``chip_smoke.py`` calls, does
not).
Launches made here outside a wrapper do not touch ``kernels.LAUNCHES``.

Run on the card::

    python -m cmacionize_torch.tools.launch_cost
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from cmacionize_torch.device import describe, require_cuda
from cmacionize_torch.kernels import gather, probe_cohort, probe_deposit, probe_gather
from cmacionize_torch.kernels.gather import _check, _function
from cmacionize_torch.kernels.launch import current_device, raw_stream
from cmacionize_torch.tools import probe_cohort_kernel as cohort_tool
from cmacionize_torch.tools import probe_pallas_gather as tool
from cmacionize_torch.tools.probe_deposit import march_inputs

LOOKUPS = 1 << 20  # the larger size of the gathers and K12a
REPEATS = 50  # calls per timed window of (a) and (b)
REPLAYS = 5  # replays of the graph of (b)
ROUNDS = 5  # windows of (c) per call or step, taken in turns; the least counts
WARM_UP = 200  # calls before the windows of (c)
SEED = 1234
HBM_BYTES_PER_S = 3.35e12
# K14c moves 15 of an item's 16 rows in and 16 out: 31/16 of 4 bytes an element
STREAM_ROWS_BYTES_PER_ELEMENT = 4 * 31 / 16
SCATTER_SHAPE = (tool.SCATTER_N // 128, 128)  # K12a's output

# label: (the wrapper, the tool's arguments at its own shapes)
KERNELS = {
    "K11r": (gather.gather2d, lambda device: tool.b_flat_gather_2d(device)[1]),
    "K12s": (probe_gather.sublane_gather, lambda device: tool.b_sublane_gather(device)[1]),
    "K12t": (probe_gather.take_along_lanes, lambda device: tool.b_taa_lanes(device)[1]),
    "K12r": (probe_gather.row_gather, lambda device: tool.b_row_gather(device)[1]),
    "K12a": (tool.scatter_add_probe, lambda device: tool.b_scatter_add(device)[1]),
    "K13f": (probe_deposit.fill_first, lambda device: march_inputs(device)[:1]),
    "K14c": (probe_cohort.stream_rows, cohort_tool.c_inputs),
}
LIBRARY = {"K11r": "tab[hi, lo]", "K12s": "torch.gather", "K12t": "torch.take_along_dim",
           "K12r": "tab[idx]", "K12a": "zeros + index_put_",
           "K13f": "dep.reshape(-1)[:1].expand(1, 128).clone()", "K14c": "pk.clone()"}
# the kernels on kernels/launch.py whose host steps are split: their
# launchers, their wrappers' checks (the device index, then the launcher's
# ints) and output allocations
NEW_PATH = {
    "K11r": (gather._GATHER2D, gather.check_gather2d,
             lambda tab, rows, lanes: torch.empty_like(rows, dtype=torch.float32)),
    "K12s": (probe_gather._SUBLANE_GATHER, probe_gather.check_sublane_gather,
             lambda a, idx: torch.empty_like(idx, dtype=torch.float32)),
    "K12t": (probe_gather._TAKE_ALONG_LANES, probe_gather.check_take_along_lanes,
             lambda a, idx: torch.empty_like(idx, dtype=torch.float32)),
    "K12r": (probe_gather._ROW_GATHER, probe_gather.check_row_gather,
             lambda a, idx: a.new_empty((idx.shape[0], a.shape[1]))),
    "K13f": (probe_deposit._FILL_FIRST, probe_deposit.check_fill_first,
             lambda dep: dep.new_empty(1, probe_deposit.CELLS)),
}
OLD_PATH = "K12a"  # the control on the ctypes path of kernels/gather.py


def seeded_inputs(label: str, n: int, device, rng) -> tuple:
    """Seeded arguments of the larger size: ``n`` lookups into the probe's
    table (K12t: ``n`` rows of 128; K11r 1D rows and lanes), the table's first
    and last entries among them; K12a ``n`` integer weights added at indices
    with duplicates; K13f ``n`` normal values as [n / 128, 128]; K14c ``n``
    items of [16, 128]."""
    def table(rows, width):
        return torch.tensor(rng.standard_normal((rows, width), dtype=np.float32), device=device)

    def lookups(hi, shape):
        idx = rng.integers(0, hi, n)
        idx[0], idx[-1] = 0, hi - 1
        return torch.tensor(idx.astype(np.int32).reshape(shape), device=device)

    if label == "K11r":
        flat = lookups(2048 * 128, (n,))
        return table(2048, 128), flat // 128, flat % 128
    if label == "K12t":
        return table(n, 128), lookups(128, (n, 1))
    if label == "K12r":
        return table(4096, 64), lookups(4096, (n,))
    if label == "K13f":
        return (table(n // 128, 128),)
    if label == "K12a":
        val = rng.integers(-3, 4, (n // 128, 128)).astype(np.float32)
        return lookups(tool.SCATTER_N, (n // 128, 128)), torch.tensor(val, device=device)
    if label == "K14c":
        return (torch.tensor(rng.standard_normal((n, 16, 128), dtype=np.float32), device=device),)
    return table(2048, 128), lookups(2048, (n // 128, 128))


def library_call(label: str, args: tuple):
    """The one PyTorch call of the kernel's function, its int64 index copy
    made here, outside any timed window (K14c: ``pk.clone()``, which moves
    its bytes but does not form row 2 or the sum)."""
    if label == "K14c":
        (pk,) = args
        return pk.clone
    if label == "K13f":
        (dep,) = args
        return lambda: dep.reshape(-1)[:1].expand(1, probe_deposit.CELLS).clone()
    if label == "K11r":
        tab, rows, lanes = args
        return lambda: tab[rows, lanes]
    a, idx = args
    if label == "K12s":
        idx64 = idx.long()
        return lambda: torch.gather(a, 0, idx64)
    if label == "K12t":
        idx64 = idx.long()
        return lambda: torch.take_along_dim(a, idx64, 1)
    if label == "K12a":
        flat, val = a.reshape(-1).long(), idx.reshape(-1)
        return lambda: torch.zeros(tool.SCATTER_N, device=val.device).index_put_(
            (flat,), val, accumulate=True)
    return lambda: a[idx]


def bound_ms(label: str, args: tuple) -> float:
    """The least time an H100 SXM could take for the call (3.35 TB/s, NVIDIA's
    data sheet): its inputs and output once each; of a gather's table, the
    distinct 32-byte sectors that these lookups touch; of K14c's items, the 15
    rows that its output needs (row 2 out is row 0 + row 1) and the 16 it
    writes; of K13f's input, the one element it copies."""
    if label == "K14c":
        return STREAM_ROWS_BYTES_PER_ELEMENT * args[0].numel() / HBM_BYTES_PER_S * 1e3
    if label == "K13f":
        return 4 * (1 + probe_deposit.CELLS) / HBM_BYTES_PER_S * 1e3
    if label == "K11r":  # 8 bytes of indices in and 4 out a lookup
        tab, rows, lanes = args
        sectors = int(torch.unique((rows.long() * tab.shape[1] + lanes).reshape(-1) // 8).numel())
        return (12 * rows.numel() + 32 * sectors) / HBM_BYTES_PER_S * 1e3
    a, idx = args
    if label == "K12a":
        return 4 * (a.numel() + idx.numel() + tool.SCATTER_N) / HBM_BYTES_PER_S * 1e3
    width = a.shape[1]
    if label == "K12s":
        offsets = idx.long() * width + torch.arange(width, device=idx.device)
        moved = 8 * idx.numel()
    elif label == "K12t":
        offsets = torch.arange(idx.shape[0], device=idx.device) * width + idx[:, 0]
        moved = 8 * idx.numel()
    else:
        offsets = idx[:, None].long() * width + torch.arange(width, device=idx.device)
        moved = 4 * idx.numel() * (1 + width)
    sectors = int(torch.unique(offsets.reshape(-1) // 8).numel())
    return (moved + 32 * sectors) / HBM_BYTES_PER_S * 1e3


def per_call_ms(fn, repeats: int = REPEATS) -> float:
    """(a): mean ms per call of ``repeats`` calls back to back (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def graph_ms(fn, repeats: int = REPEATS, replays: int = REPLAYS) -> float:
    """(b): ms per call of ``repeats`` calls captured into one CUDA graph,
    over ``replays`` replays (CUDA events)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture: builds, loads, allocates
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * repeats)
    del graph
    return ms


def device_split(fn, calls: int = 20) -> dict:
    """Device ms per call of each kernel, memset or copy that ``fn`` runs, by
    name without its arguments, over a ``torch.profiler`` window of ``calls``
    calls (the device's own events, as ``chip_smoke.py:profile_window``
    counts them)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {event.key.replace("(anonymous namespace)::", "").split("(")[0].strip():
            event.self_device_time_total / calls / 1e3
            for event in prof.key_averages()
            if event.device_type == torch.autograd.DeviceType.CUDA
            and event.self_device_time_total > 0}


def window_us(fn, calls: int) -> float:
    """Host µs per call of ``fn`` over one window of ``calls`` calls with no
    synchronise (the device's queue drained before and after, outside it)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e-3 / calls


def host_us(fns: dict, calls: int, rounds: int = ROUNDS) -> dict:
    """(c): for each of ``fns``, the least host µs per call over ``rounds``
    windows of ``calls // rounds`` calls, the functions taken in turns in
    each round, after :data:`WARM_UP` calls of each."""
    for fn in fns.values():
        for _ in range(WARM_UP):
            fn()
    best = dict.fromkeys(fns, float("inf"))
    for _ in range(rounds):
        for key, fn in fns.items():
            best[key] = min(best[key], window_us(fn, max(1, calls // rounds)))
    return best


def old_path_steps(args: tuple) -> dict:
    """Each step of K12a's wrapper, the ctypes path of ``kernels/gather.py``,
    as a function of no arguments; the ctypes call once with no work (n = 0
    and nothing to zero: it returns ``cudaGetLastError()`` and launches
    nothing) and once with its zeroing and launch."""
    idx, val = args
    device = val.device
    fn = _function("cmi_scatter_add", 3, 2, probe_gather.NAME)
    out = torch.empty(SCATTER_SHAPE, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    pointers = (idx.data_ptr(), val.data_ptr(), out.data_ptr())
    counts = collections.Counter()

    def checks():  # as scatter_add checks
        _check("scatter_add", (("idx", idx, torch.int32, val.dim()),
                               ("val", val, torch.float32, val.dim())), device)
        probe_gather._fits_int32("scatter_add", idx.numel(), out.numel())

    def context():
        with torch.cuda.device(device):
            pass

    def counter():
        counts["scatter_add"] += 1

    return {
        "checks": checks,
        "torch.empty": lambda: torch.empty(SCATTER_SHAPE, dtype=torch.float32, device=device),
        "_function": lambda: _function("cmi_scatter_add", 3, 2, probe_gather.NAME),
        "Stream object": lambda: torch.cuda.current_stream(device).cuda_stream,
        "torch.cuda.device": context,
        "data_ptr x3": lambda: (idx.data_ptr(), val.data_ptr(), out.data_ptr()),
        "ctypes, no launch": lambda: fn(*pointers, 0, 0, stream),
        "ctypes + launch": lambda: fn(*pointers, idx.numel(), out.numel(), stream),
        "counter": counter,
    }


def new_path_steps(label: str, args: tuple) -> dict:
    """Each step of the :mod:`kernels.launch` wrapper of K11r, K12s, K12t,
    K12r or K13f alone, its checks and allocation being the wrapper's own;
    the typed ctypes call once with no work (a count of 0, where the launcher
    takes one) and once with its launch."""
    launcher, check, alloc = NEW_PATH[label]
    index, *ints = check(*args)
    fn = launcher.bind()
    out = alloc(*args)
    stream = raw_stream(index)
    tensors = (*args, out)
    pointers = tuple(map(torch.Tensor.data_ptr, tensors))
    counts = collections.Counter()

    def counter():
        counts[label] += 1

    steps = {
        "checks": lambda: check(*args),
        "allocation": lambda: alloc(*args),
        f"data_ptr x{len(tensors)}": lambda: tuple(map(torch.Tensor.data_ptr, tensors)),
        "raw stream": lambda: raw_stream(index),
        "current device": current_device,
    }
    if ints:
        steps["ctypes, no launch"] = lambda: fn(*pointers, 0, *ints[1:], stream)
    steps["ctypes + launch"] = lambda: fn(*pointers, *ints, stream)
    steps["counter"] = counter
    return steps


def fmt(values: dict) -> str:
    return ", ".join(f"{k} {v:.4g}" for k, v in values.items())


def measure(label: str, size: str, args: tuple, host_calls: int = 10_000) -> dict:
    """(a), (b) and (c) of the kernel's wrapper and of the library call on
    ``args``, with the split of the wrapper's path (K12a: the old path; K11r,
    K12s, K12t, K12r, K13f: the new one; K14c: none); prints a line of each
    and returns them."""
    wrapper = KERNELS[label][0]
    calls = {"wrapper": lambda: wrapper(*args), LIBRARY[label]: library_call(label, args)}
    host = host_us(calls, host_calls)
    record = {"bound_ms": bound_ms(label, args)}
    print(f"launch_cost {label} {size}: bound {record['bound_ms']:.6f} ms (bytes)", flush=True)
    for which, fn in calls.items():
        record[which] = {"a_ms": per_call_ms(fn), "b_ms": graph_ms(fn), "c_us": host[which]}
        print(f"launch_cost {label} {size} {which}: (a) {record[which]['a_ms']:.4f} ms per call; "
              f"(b) {record[which]['b_ms']:.4f} ms device only (CUDA graph); "
              f"(c) {host[which]:.3f} us host", flush=True)
    if label == "K14c":  # bound by the device: its host steps are not split
        return record
    if label in NEW_PATH:
        which, steps = "new path split", new_path_steps(label, args)
    else:
        which, steps = "old path split", old_path_steps(args)
    in_call = [step for step in steps if step != "ctypes, no launch"]  # the others make the call
    record[which] = host_us(steps, host_calls)
    print(f"launch_cost {label} {size} {which} (us): {fmt(record[which])} (sum of "
          f"{', '.join(in_call)}: {sum(record[which][k] for k in in_call):.3f})", flush=True)
    return record


# the larger size of each kernel (K13f, which reads one element, has none)
LARGER = {"K11r": LOOKUPS, "K12s": LOOKUPS, "K12t": LOOKUPS, "K12r": LOOKUPS, "K12a": LOOKUPS,
          "K13f": None, "K14c": 2 * cohort_tool.NCHUNK * 8}


def main() -> dict:
    """Every measurement above on the card; returns {(label, size): record}."""
    device = require_cuda()
    print(f"launch_cost on {describe(device)}", flush=True)
    rng = np.random.default_rng(SEED)
    records = {}
    for label, (_, make) in KERNELS.items():
        n = LARGER[label]
        for size in ("tool",) if n is None else ("tool", str(n)):
            args = make(device) if size == "tool" else seeded_inputs(label, n, device, rng)
            # K14c's windows stay short enough that its queued launches do
            # not fill the device's queue, which would time the device, not
            # the host
            records[label, size] = measure(
                label, size, args,
                host_calls=10_000 if size == "tool" and label != "K14c" else 1000)
            if label == "K14c":  # its device time by kernel, here only (PERF.md §6)
                for which, fn in {"wrapper": lambda: probe_cohort.stream_rows(*args),
                                  LIBRARY[label]: library_call(label, args)}.items():
                    split = records[label, size][which]["device_split"] = device_split(fn)
                    print(f"launch_cost {label} {size} {which} device split (ms per call, "
                          f"torch.profiler): {fmt(split)}", flush=True)
    return records


if __name__ == "__main__":
    main()
