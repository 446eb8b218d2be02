"""The card this process runs on."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """Return the current CUDA device; raise if there is no card.

    For entry points that must run on the GPU (``chip_smoke.py``): they fail
    rather than fall back to the CPU.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", torch.cuda.current_device())
