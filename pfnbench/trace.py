"""The traced stretch: ``torch.profiler`` over a few steady calls, read into
plain lists that the per-layer metric readers and the breakdown take.

On a card only CUDA activity is recorded: tracing every host operator as
well doubles the host's time of a launch-bound update (the recipe cell read
58 % idle so, against about 9 % without), so the idle share would measure
the profiler. The CUDA runtime calls (launches, copies, syncs) come with the
CUDA activity; the traced window runs from the first launch or copy among
them to the end of the first sync after the last one, the closing sync
(the syncs the profiler makes as its step opens and closes lie beyond the
20 ms pads and are left out), or, where none was recorded, over the
kernels' own span. An idle gap is named
by the runtime call under its middle, else by the last one before it: the
host was working after that call. The recorded step is padded by 20 ms on both sides (kineto drops
kernels whose timestamps fall outside it), and a session that saw no kernel
is tried again, up to three times. Without a card the host's operators are
recorded and the kernel list is empty.
"""

from __future__ import annotations

import time

import torch

PAD_S = 0.02
TRIES = 3
WINDOW = "pfnbench.traced_window"


def _union(intervals):
    """Merged (start, end) intervals of ``intervals``."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _is_runtime_call(name: str) -> bool:
    return name.startswith(("cuda", "cu")) and not name.startswith("cuda_")


def _is_launch_or_copy(name: str) -> bool:
    return _is_runtime_call(name) and any(k in name for k in ("Launch", "Memcpy", "Memset"))


def profile(fn, calls: int) -> dict:
    """Run ``fn()`` ``calls`` times under the profiler. Returns
    {"window": (start_us, end_us), "kernels": [(name, start_us, end_us)],
    "host": [(name, start_us, end_us)], "results": [fn()'s returns]}."""
    from torch.profiler import ProfilerActivity, record_function, schedule

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    for _ in range(TRIES):
        results = []
        with torch.profiler.profile(activities=activities,
                                    schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            if cuda:
                torch.cuda.synchronize()
            prof.step()
            time.sleep(PAD_S)
            with record_function(WINDOW):
                for _ in range(calls):
                    results.append(fn())
                if cuda:
                    torch.cuda.synchronize()
            time.sleep(PAD_S)
            prof.step()
        kernels, host, window = [], [], None
        for e in prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if end > start and not getattr(e, "is_user_annotation", False):
                    kernels.append((e.name, start, end))
            elif e.name == WINDOW:
                window = (start, end)
            elif end >= start and not e.name.startswith("ProfilerStep"):
                host.append((e.name, start, end))
        if kernels or not cuda:
            break
    runtime = [h for h in host if _is_runtime_call(h[0])]
    launches = [h for h in runtime if _is_launch_or_copy(h[0])]
    if window is None and launches:
        last = max(s for _, s, _ in launches)
        closing = [e for n, s, e in runtime if "Synchronize" in n and s >= last]
        window = (min(s for _, s, _ in launches), min(closing) if closing else max(e for _, _, e in runtime))
    if window is None and kernels:
        window = (min(s for _, s, _ in kernels), max(e for _, _, e in kernels))
    if window is not None:
        kernels = [k for k in kernels if k[2] > window[0] and k[1] < window[1]]
    return {"window": window, "kernels": kernels, "host": host, "results": results}


def _busy_intervals(prof: dict):
    """The union of the kernels' intervals, clipped to the window."""
    w0, w1 = prof["window"]
    return _union((max(s, w0), min(e, w1)) for _, s, e in prof["kernels"])


def busy_us(prof: dict) -> float:
    """Device-busy time in the window: the union of the kernels' intervals."""
    return sum(e - s for s, e in _busy_intervals(prof))


def window_us(prof: dict) -> float:
    w0, w1 = prof["window"]
    return w1 - w0


def breakdown(prof: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by the innermost host operation running at the gap's middle."""
    by_name = {}
    for name, s, e in prof["kernels"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    w0, w1 = prof["window"]
    edges = [w0] + [x for iv in _busy_intervals(prof) for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (s + e)
        around = [h for h in prof["host"] if h[1] <= mid <= h[2]]
        before = [h for h in prof["host"] if h[2] <= mid and _is_runtime_call(h[0])]
        if around:
            label = max(around, key=lambda h: h[1])[0]
        elif before:
            label = "host after " + max(before, key=lambda h: h[2])[0]
        else:
            label = "host"
        named.append([label[:120], (e - s) * 1e-6])
    return {"device_ops": [[n[:120], us * 1e-6] for n, us in ops], "idle_gaps": named}
