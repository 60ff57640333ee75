"""The CUDA device the port runs on.

The port has no CPU fallback for its device path: a run that asks for the
GPU and finds none fails here instead of silently timing the CPU.
"""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The current CUDA device; raises RuntimeError when CUDA is unavailable."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "cmacionize_torch: CUDA is not available (torch "
            f"{torch.__version__}, built for CUDA {torch.version.cuda})"
        )
    return torch.device("cuda", torch.cuda.current_device())


def describe(device: torch.device) -> str:
    """One line naming the card and the software a measurement ran on."""
    return (
        f"{torch.cuda.get_device_name(device)}, {torch.cuda.device_count()} "
        f"device(s), torch {torch.__version__}, CUDA {torch.version.cuda}"
    )
