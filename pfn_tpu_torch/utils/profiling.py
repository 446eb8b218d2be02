"""Tracing, timing and debug instrumentation.

Port of ``pfn_tpu/utils/profiling.py``:
  * ``StepTimers``: named wall-clock channels (the reference's
    time_to_get_batch / forward_time / step_time). A channel timed on the card
    is closed by a CUDA synchronize, since PyTorch returns before the device
    finishes.
  * ``trace(log_dir)``: a ``torch.profiler`` trace (CPU and, on the card,
    CUDA activity) written as Chrome-trace JSON into ``log_dir``.
  * ``debug_nans`` and ``pfn_debug_checks``: the fail-loudly modes. JAX's
    ``jax_debug_nans`` traps a NaN at the op that made it. PyTorch cannot trap
    a forward op, so ``debug_nans`` is two checks instead: the backward under
    ``torch.autograd.detect_anomaly(check_nan=True)``, and a NaN check of the
    loss where the train loop already reads it (:func:`raise_on_nan`, no extra
    host sync). Both raise ``FloatingPointError``, as JAX does.
  * ``debug_checks_enabled``: the flag of ``pfn_debug_checks``, read when an
    op runs (PyTorch has no jit cache to clear; the JAX flag is read at trace
    time). Under it ``BarDistribution.nll`` poisons out-of-support targets
    with NaN; with it off that path adds no op and no host sync.
  * ``annotate(name)``: a decorator naming a function's ops in profiler
    traces (``torch.profiler.record_function``, and an NVTX range on the
    card).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
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


@contextlib.contextmanager
def trace(log_dir: str = "results/trace"):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where there is a card) and write the trace as Chrome-trace
    JSON, ``log_dir/trace.json`` (view it in Perfetto or chrome://tracing).
    Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# Flags read when the ops run: debug_nans's loss check, and the debug checks
# of pfn_debug_checks (BarDistribution.nll's target-support check).
_DEBUG_NANS = False
_DEBUG_CHECKS = False


def debug_nans_enabled() -> bool:
    return _DEBUG_NANS


def raise_on_nan(value: float, what: str = "loss") -> None:
    """Under :func:`debug_nans`, raise FloatingPointError if ``value`` (a
    number the caller has already read to the host) is NaN."""
    if _DEBUG_NANS and math.isnan(value):
        raise FloatingPointError(f"invalid value (nan) encountered in the {what}")


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN trap, the counterpart of JAX's ``jax_debug_nans``: fail
    loudly instead of training on garbage. PyTorch cannot stop a forward op
    at a NaN, so a NaN raises FloatingPointError where it is first seen: in
    the backward (``detect_anomaly(check_nan=True)``: a backward function
    that returns NaN; its RuntimeError leaves the scope as a
    FloatingPointError), or in the loss that the train loop reads
    (:func:`raise_on_nan`). The anomaly mode slows the backward; it is for
    debugging only."""
    global _DEBUG_NANS
    prev = _DEBUG_NANS
    _DEBUG_NANS = enable
    try:
        with torch.autograd.set_detect_anomaly(enable, check_nan=True):
            yield
    except RuntimeError as e:
        if enable and "nan values" in str(e):
            raise FloatingPointError(str(e)) from e
        raise
    finally:
        _DEBUG_NANS = prev


def debug_checks_enabled() -> bool:
    return _DEBUG_CHECKS


@contextlib.contextmanager
def pfn_debug_checks(enable: bool = True):
    """Scoped strict-checks mode, the counterpart of the reference's inline
    asserts that the fast path leaves out. While it is on:

      * ``BarDistribution.nll`` poisons out-of-support targets with NaN
        instead of clamping them to the end buckets (the reference asserts,
        bar_distribution.py:27-28), so a mis-scaled prior fails loudly;
      * :func:`debug_nans` is on, so that NaN raises FloatingPointError.
    """
    global _DEBUG_CHECKS
    prev = _DEBUG_CHECKS
    _DEBUG_CHECKS = enable
    try:
        with debug_nans(enable):
            yield
    finally:
        _DEBUG_CHECKS = prev


def annotate(name: str):
    """Decorator: run the function inside a ``torch.profiler.record_function``
    range called ``name``, and an NVTX range of that name where there is a
    card."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            nvtx = torch.cuda.is_available()
            if nvtx:
                torch.cuda.nvtx.range_push(name)
            try:
                with torch.profiler.record_function(name):
                    return fn(*args, **kwargs)
            finally:
                if nvtx:
                    torch.cuda.nvtx.range_pop()

        return wrapped

    return deco
