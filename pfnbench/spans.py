"""The program's spans on the profiled stretch's clock, for the per-layer
metrics that read them.

While a ``torch.profiler`` session is active (the traced stretch,
``trace.profile``) the program records its spans
(``pfn_tpu_torch.utils.profiling``): name, parent, host times on
``time.perf_counter_ns``, and the device milliseconds between two CUDA events.
The profile's times are on the profiler's clock instead, relative to its
start. Among the CUDA runtime calls the profile keeps are the program's
``cudaEventRecord`` calls (``cudaEventRecordWithFlags`` in torch 2.11), and
the program knows its own host time at the end of each (``Span.records``). ``fit`` finds the one offset that maps the program's
clock onto the profile's by matching the two, and the fit's residual. With
it, ``idle_by_layer`` charges each device-idle gap of the traced window to the
innermost span open on the host at the gap's middle, and
``launches_per_update`` counts the kernel launches inside ``train.update``.

A program without spans (one older than them) gives None everywhere, as does
a run without CUDA events (the CPU): the metric is then left out.
"""

from __future__ import annotations

import sys

import numpy as np

from pfnbench import trace

UPDATE = "train.update"
LAYERS = ("prior", "model", "optimizer", "outside")
# A program event record and a profiled cudaEventRecord call match within this.
MATCH_US = 20.0
_FITS: dict = {}


def program_spans() -> list | None:
    """The spans the program recorded (in the traced stretch), or None."""
    try:
        from pfn_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    return (recorded() or None) if recorded is not None else None


def device_ms(spans, names) -> float | None:
    """The summed device ms of the spans named in ``names``; None where none
    of them has any."""
    times = [s.device_ms for s in spans if s.name in names and s.device_ms is not None]
    return float(sum(times)) if times else None


def ms_per_update(names) -> float | None:
    """Device ms of the spans ``names`` per ``train.update`` span."""
    spans = program_spans()
    if spans is None:
        return None
    part = device_ms(spans, names)
    updates = sum(1 for s in spans if s.name == UPDATE and s.device_ms is not None)
    return part / updates if part is not None and updates else None


def _nearest(points: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """For each of ``points``, the index of the nearest of the sorted
    ``targets`` (at least two)."""
    i = np.clip(np.searchsorted(targets, points), 1, len(targets) - 1)
    return np.where(np.abs(points - targets[i - 1]) <= np.abs(targets[i] - points), i - 1, i)


def _matched(points: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Which of ``points`` match a target within ``MATCH_US``, each target
    taken at most once, by the nearest point."""
    nearest = _nearest(points, targets)
    gap = np.abs(targets[nearest] - points)
    keep = np.zeros(len(points), dtype=bool)
    taken = set()
    for j in np.argsort(gap, kind="stable"):
        if gap[j] > MATCH_US:
            break
        if nearest[j] not in taken:
            taken.add(nearest[j])
            keep[j] = True
    return keep


def fit(spans, profile: dict) -> dict | None:
    """The offset (us) from the program's clock to the profile's: the one
    that matches most of the program's event records (their ends, in us) to
    the end of a profiled ``cudaEventRecord`` call within ``MATCH_US``, each
    call once, refined to the median of the matched differences. With
    ``residual_us``, the median |difference - offset| over the matched
    records, and its maximum. None where there are no records or fewer than
    two such calls."""
    ours = np.array(sorted({r for s in spans if s.records for r in s.records}), dtype=np.float64) / 1e3
    calls = np.array(sorted(b for name, _, b in profile["host"] if name.startswith("cudaEventRecord")),
                     dtype=np.float64)
    if len(ours) == 0 or len(calls) < 2:
        return None
    best = (-1, 0.0)
    for anchor in sorted({0, len(ours) // 2, len(ours) - 1}):
        for offset in calls - ours[anchor]:
            shifted = ours + offset
            matched = int((np.abs(calls[_nearest(shifted, calls)] - shifted) <= MATCH_US).sum())
            if matched > best[0]:
                best = (matched, offset)
    offset = best[1]
    for _ in range(2):
        keep = _matched(ours + offset, calls)
        offset = float(np.median(calls[_nearest(ours + offset, calls)][keep] - ours[keep]))
    keep = _matched(ours + offset, calls)
    residual = np.abs(calls[_nearest(ours + offset, calls)] - ours - offset)
    return {"offset_us": offset, "residual_us": float(np.median(residual[keep])),
            "max_residual_us": float(residual[keep].max()), "matched": int(keep.sum()), "records": len(ours),
            "calls": len(calls)}


def placed(t: dict):
    """(spans as (name, start_us, end_us, depth) on the profile's clock,
    updates overlapping the window as (start_us, end_us)); None where there
    is nothing to place. The fit is printed once to standard error."""
    prof, spans = t.get("profile"), program_spans()
    if not prof or not prof.get("window") or not prof["kernels"] or spans is None:
        return None
    key = (id(prof), len(spans))
    if key not in _FITS:
        _FITS[key] = fit(spans, prof)
        if _FITS[key] is not None:
            print("spans: clock fit " + " ".join(f"{k} {v!r}" for k, v in _FITS[key].items()), file=sys.stderr)
    f = _FITS[key]
    if f is None:
        return None
    depth = []
    for s in spans:
        depth.append(0 if s.parent is None or s.parent >= len(depth) else depth[s.parent] + 1)
    on_clock = [(s.name, s.start_ns / 1e3 + f["offset_us"], s.end_ns / 1e3 + f["offset_us"], d)
                for s, d in zip(spans, depth) if s.end_ns is not None]
    w0, w1 = prof["window"]
    updates = [(a, b) for name, a, b, _ in on_clock if name == UPDATE and a < w1 and b > w0]
    return (on_clock, updates) if updates else None


def layer_of(name: str | None) -> str:
    """The layer an idle gap is charged to, by the innermost open span."""
    if name == "prior.sample":
        return "prior"
    if name is not None and (name.startswith(("model.", "train.backward")) or name == "train.loss"):
        return "model"
    if name == "train.optimizer":
        return "optimizer"
    return "outside"


def idle_gaps(prof: dict) -> list[tuple[float, float]]:
    """The window's stretches outside the union of the kernels' intervals
    (those ``device_idle_pct`` counts)."""
    w0, w1 = prof["window"]
    edges = [w0] + [x for iv in trace._busy_intervals(prof) for x in iv] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]


def idle_by_layer(t: dict) -> dict | None:
    """Device-idle ms per update charged to each of ``LAYERS``: each gap once,
    to the layer of the innermost span open on the host at its middle, or to
    "outside" where none of the prior's, model's or optimizer's is."""
    where = placed(t)
    if where is None:
        return None
    on_clock, updates = where
    charged = dict.fromkeys(LAYERS, 0.0)
    for a, b in idle_gaps(t["profile"]):
        mid = 0.5 * (a + b)
        around = [(d, s, name) for name, s, e, d in on_clock if s <= mid <= e]
        charged[layer_of(max(around)[2] if around else None)] += b - a
    return {layer: us * 1e-3 / len(updates) for layer, us in charged.items()}


def launches_per_update(t: dict) -> float | None:
    """Kernel-launch runtime calls of the profile that start inside a
    ``train.update`` span, per update."""
    where = placed(t)
    if where is None:
        return None
    _, updates = where
    starts = np.array([a for name, a, _ in t["profile"]["host"] if trace._is_runtime_call(name) and "Launch" in name])
    if len(starts) == 0:
        return None
    return float(sum(((starts >= a) & (starts <= b)).sum() for a, b in updates)) / len(updates)
