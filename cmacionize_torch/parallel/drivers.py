"""What the sharded drivers share: their devices, their per-shard
generators and the host view of their exchange counters.

Used by ``ShardedHOnlyIonizationSimulation``
(``models/ionization_simulation.py``) and ``ShardedRHDSimulation``
(``models/rhd_simulation.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from cmacionize_torch.parallel.mesh import cuda_devices

DIAGNOSTIC_COUNTS = ("n_escaped", "buffer_overflow", "truncated_live", "supersteps")


def mesh_devices(device) -> list:
    """The devices a sharded driver spreads its shards over: ``None`` for
    the visible CUDA devices, else the one device given."""
    if device is None:
        return cuda_devices()
    return [torch.device(device)]


def shard_generators(seed: int, devices) -> list:
    """One ``torch.Generator`` per shard, on the shard's device, seeded from
    ``seed`` and the shard's index."""
    generators = []
    for i, device in enumerate(devices):
        state = np.random.SeedSequence([int(seed), i]).generate_state(2, np.uint32)
        generator = torch.Generator(device=device)
        generator.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
        generators.append(generator)
    return generators


def read_diagnostics(diag: dict, totals: dict, log) -> dict:
    """The host view of a sharded call's counters (one read each), added
    into ``totals``; a nonzero overflow or truncation is logged as a
    warning."""
    out = {k: int(diag[k]) for k in DIAGNOSTIC_COUNTS}
    out["packets_traced"] = diag["packets_traced"].cpu().numpy()
    for k in DIAGNOSTIC_COUNTS:
        totals[k] += out[k]
    if out["buffer_overflow"]:
        log.warning(f"exchange buffer overflow: {out['buffer_overflow']} packets")
    if out["truncated_live"]:
        log.warning(f"superstep cap hit with {out['truncated_live']} packets live")
    return out
