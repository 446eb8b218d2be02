"""The share of the profiled stretch's wall time in which no operation runs
on the device (the union of the kernels' intervals is the busy time)."""

from pfnbench import trace


def read(t: dict):
    prof = t.get("profile")
    if not prof or not prof["kernels"] or not prof["window"]:
        return None
    return 100.0 * (1.0 - trace.busy_us(prof) / trace.window_us(prof))
