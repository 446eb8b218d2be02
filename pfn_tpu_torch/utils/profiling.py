"""Step timers: named wall-clock channels.

Port of the ``ChannelStats`` / ``StepTimers`` part of
``pfn_tpu/utils/profiling.py``, which the train loop uses. A channel timed on
the card is closed by a CUDA synchronize, since PyTorch returns before the
device finishes. The trace and debug helpers of that module are ROADMAP.md
queue 1 item 13.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import torch


@dataclasses.dataclass
class ChannelStats:
    total: float = 0.0
    count: int = 0

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


class StepTimers:
    """Named wall-clock channels (the reference keeps time_to_get_batch,
    forward_time and step_time; channels here are open)."""

    def __init__(self):
        self._stats: dict[str, ChannelStats] = defaultdict(ChannelStats)

    @contextlib.contextmanager
    def channel(self, name: str, device: torch.device | None = None):
        """Time a block; with a CUDA ``device`` the block's device work is
        included by a synchronize before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        s = self._stats[name]
        s.total += seconds
        s.count += 1

    def means(self) -> dict[str, float]:
        return {k: v.mean for k, v in self._stats.items()}

    def reset(self) -> None:
        self._stats.clear()
