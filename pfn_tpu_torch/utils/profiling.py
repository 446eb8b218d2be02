"""Spans, tracing and debug instrumentation.

Port of ``pfn_tpu/utils/profiling.py``, with its wall-clock channels replaced
by spans inside the program:
  * ``span(name)``: a named stretch of the program, recorded in memory with
    its parent, its host times and, on the card, its device time (below).
  * ``trace(log_dir)``: a ``torch.profiler`` trace (CPU and, on the card,
    CUDA activity) written as Chrome-trace JSON into ``log_dir``, the spans
    in it as named ranges.
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

Spans
-----
Recording is off unless asked for. Then ``span(name)`` reads two flags and
returns one shared do-nothing context manager: no allocation, no CUDA call,
no profiler range. Recording is on

  * inside ``with recording():``, which ``trace(log_dir)`` enters. There each
    span also opens a ``torch.profiler.record_function`` range of its name,
    so the profiler's trace shows it;
  * while any ``torch.profiler`` session is in its active phase (not in its
    wait or warm-up steps), so a profiled stretch records its own spans and
    nothing before it. There a span adds nothing to the profile but its CUDA
    event records.

While recording, each span keeps its name, its parent (the span open around
it), the host clock (``time.perf_counter_ns``) at its start and end and, once
CUDA is initialised, a CUDA timing event at each end, recorded on the current
stream and taken from a pool. The spans stay in memory, at most ``MAX_SPANS``
of them (later ones are dropped, with one warning), until ``clear()``:

    with profiling.recording():
        step(state)
    for s in profiling.recorded():  # waits for the spans' events
        print(s.name, s.parent, (s.end_ns - s.start_ns) / 1e6, s.device_ms)
    profiling.clear()

A span's ``device_ms`` is the device time between its two events: the work
it enqueued on the stream, and any wait for the host in between.
``Span.records`` holds the host time at which each of its two event records
returned, so the spans can be placed on a profile's clock by matching them
to the ends of its ``cudaEventRecord`` calls (``pfnbench/spans.py`` does).
Spans are opened and closed by one thread; the one other writer is the
backward's cut (:func:`split_backward_at`), which runs on the autograd
engine's thread while the opening thread waits in ``backward()``.

The spans the port opens (the per-layer metrics of ``pfnbench/`` read them):

  ``train.update``            ``train/loop._update``: one optimizer update,
                              its microbatches' draws included
  ``prior.sample``            a microbatch's ``prior.sample`` and its sep draw
                              (``train/loop.make_train_step``)
  ``model.forward``           ``PFNTransformer.forward``, ``fused_forward``
                              and ``PerFeatureTransformer.forward``
  ``model.attn_features``     in each layer of ``PerFeatureTransformer``: the
                              attention across a row's feature tokens, its
                              projections and its residual LayerNorm
  ``model.attn_items``        the same for its attention across the rows of
                              a token column (the two flash calls)
  ``model.decoder``           the decoder call inside each forward; its
                              counter ``Span.rows`` holds the rows it decoded
                              and the rows the forward produced (B times T)
  ``train.loss``              ``train/loop._loss_terms``: the criterion's
                              per-position loss and its mask
  ``train.backward``          a microbatch's ``objective.backward()``, cut
                              where the decoder input's gradient is computed
                              into two children:
  ``train.backward.head``     the backward of the loss and the decoder
  ``train.backward.encoder``  the rest: the encoder layers and embeddings
  ``train.optimizer``         ``train/loop._clip_and_step``: the global norm,
                              the clip and Adam
"""

from __future__ import annotations

import contextlib
import math
import os
import time
import warnings

import torch
from torch.autograd import profiler as _torch_profiler

MAX_SPANS = 1 << 16
BACKWARD, BACKWARD_HEAD, BACKWARD_ENCODER = "train.backward", "train.backward.head", "train.backward.encoder"


def _mark() -> tuple:
    """(host ns before, host ns after, event): once CUDA is initialised, an
    event from the pool recorded on the current stream between the two
    clock reads; else one clock read and no event."""
    if not torch.cuda.is_initialized():
        now = time.perf_counter_ns()
        return now, now, None
    pool = _RECORDER.pool
    event = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
    before = time.perf_counter_ns()
    event.record()
    return before, time.perf_counter_ns(), event


class Span:
    """One recorded span, between two marks (:func:`_mark`). ``parent``: the
    index in :func:`recorded` of the span open around it, or None.
    ``device_ms``: set by :func:`recorded` where both marks hold an event.
    ``rows``: a counter the code inside the span may set, (rows decoded,
    rows produced) on ``model.decoder``; None elsewhere."""

    __slots__ = ("name", "parent", "start", "end", "cut", "device_ms", "rows")

    def __init__(self, name: str, parent: int | None, start: tuple, end: tuple | None = None):
        self.name, self.parent, self.start, self.end = name, parent, start, end
        self.cut = None
        self.device_ms = None
        self.rows = None

    @property
    def start_ns(self) -> int:
        return self.start[0]

    @property
    def end_ns(self) -> int | None:
        """Host clock at the end, None while the span is open."""
        return None if self.end is None else self.end[1]

    @property
    def records(self) -> tuple[int, int] | None:
        """Host ns at which the start and end event records returned (an
        event's first record also creates it, before the call); None
        without events."""
        if self.end is None or self.start[2] is None:
            return None
        return self.start[1], self.end[1]

    def __repr__(self) -> str:
        return f"Span({self.name!r}, parent={self.parent}, device_ms={self.device_ms})"


class _Recorder:
    """The process's spans: the buffer, the stack of open spans (each with
    its index in the buffer), the pool of CUDA events and the depth of
    ``recording()`` scopes."""

    def __init__(self):
        self.depth = 0
        self.spans: list[Span] = []
        self.stack: list[tuple[Span, int | None]] = []
        self.pool: list = []
        self.warned = False

    def append(self, span: Span) -> int | None:
        """``span``'s index in the buffer, or None where the buffer is full."""
        if len(self.spans) >= MAX_SPANS:
            if not self.warned:
                self.warned = True
                warnings.warn(f"the span buffer holds {MAX_SPANS} spans: later ones are dropped until clear()",
                              RuntimeWarning, stacklevel=4)
            return None
        self.spans.append(span)
        return len(self.spans) - 1


_RECORDER = _Recorder()


class _Off:
    """What ``span`` returns while recording is off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "named")

    def __init__(self, name: str):
        self.name = name
        self.named = None

    def __enter__(self):
        rec = _RECORDER
        parent = rec.stack[-1][1] if rec.stack else None
        s = Span(self.name, parent, _mark())
        rec.stack.append((s, rec.append(s)))
        if rec.depth:
            self.named = torch.profiler.record_function(self.name)
            self.named.__enter__()
        return s

    def __exit__(self, *exc):
        if self.named is not None:
            self.named.__exit__(*exc)
        rec = _RECORDER
        s, index = rec.stack.pop()
        s.end = _mark()
        if s.cut is not None and index is not None:
            rec.append(Span(BACKWARD_HEAD, index, s.start, s.cut))
            rec.append(Span(BACKWARD_ENCODER, index, s.cut, s.end))
        return False


def recording_on() -> bool:
    """Whether a span opened now is recorded (module docstring)."""
    return bool(_RECORDER.depth or _torch_profiler._is_profiler_enabled)


def span(name: str):
    """A context manager marking a named stretch of the program; recorded
    only while recording is on (module docstring)."""
    if _RECORDER.depth or _torch_profiler._is_profiler_enabled:
        return _On(name)
    return _OFF


@contextlib.contextmanager
def recording():
    """Record spans inside the block, each also a profiler range of its name."""
    _RECORDER.depth += 1
    try:
        yield
    finally:
        _RECORDER.depth -= 1


def _cut_backward(grad):
    stack = _RECORDER.stack
    s = stack[-1][0] if stack else None
    if s is not None and s.name == BACKWARD and s.cut is None:
        s.cut = _mark()


def split_backward_at(tensor: torch.Tensor) -> None:
    """While recording, and where ``tensor`` takes a gradient: when the
    backward reaches ``tensor``, cut the ``train.backward`` span open then
    into ``train.backward.head`` (from its start) and
    ``train.backward.encoder`` (to its end). The hook changes no gradient."""
    if tensor.requires_grad and recording_on():
        tensor.register_hook(_cut_backward)


def recorded() -> list[Span]:
    """The spans recorded since :func:`clear`, in the order they opened
    (a cut's two children after their parent), each closed one with its
    ``device_ms`` where it holds events. Waits for those events."""
    spans = list(_RECORDER.spans)
    for s in spans:
        if s.device_ms is None and s.end is not None and s.start[2] is not None:
            s.end[2].synchronize()
            s.device_ms = s.start[2].elapsed_time(s.end[2])
    return spans


def clear() -> None:
    """Empty the buffer; the events of its closed spans go back to the pool."""
    rec = _RECORDER
    open_spans = {id(s) for s, _ in rec.stack}
    events = {id(m[2]): m[2] for s in rec.spans if id(s) not in open_spans
              for m in (s.start, s.end, s.cut) if m is not None and m[2] is not None}
    rec.pool.extend(events.values())
    rec.spans.clear()
    rec.warned = False


@contextlib.contextmanager
def trace(log_dir: str = "results/trace"):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where there is a card), recording spans (:func:`recording`),
    and write the trace as Chrome-trace JSON, ``log_dir/trace.json`` (view it
    in Perfetto or chrome://tracing). Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with recording(), profile(activities=activities) as prof:
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
