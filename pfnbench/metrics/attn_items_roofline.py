"""The per-feature model's item attention against its roofline: the sum of
``models/tabpfn2.attention_bound_s`` over the passes of the profiled
stretch (``models/tabpfn2.attention_calls``: two flash calls a layer, the
train rows and the folded test rows, forward and backward) over the device
time of the flash kernels (``attn_roofline.KERNELS``), which that model
runs for nothing else. None where the stretch holds no such pass or no
flash kernel ran."""

from pfnbench import spec
from pfnbench.metrics.attn_roofline import kernel_seconds


def read(t: dict):
    prof = t.get("profile")
    calls = [c for c in t.get("attention_calls") or () if c.get("model") == "tabpfn2"]
    if not prof or not calls:
        return None
    seconds = kernel_seconds(prof)
    if seconds <= 0:
        return None
    bound = spec.program_model("tabpfn2").attention_bound_s
    return 100.0 * sum(c["count"] * bound(c) for c in calls) / seconds
