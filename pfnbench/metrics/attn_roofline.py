"""The flash-attention kernels' share of their roofline in the profiled
stretch: the sum of ``flops.attention_bound_s`` over every attention pass
the stretch held, over the device time of the kernels named below."""

import re

from pfnbench import flops

# The port's flash kernels (ops/csrc/pfn_flash_fwd.cu, pfn_flash_bwd.cu): the
# bf16 sm_90a bodies and the float32 ones.
KERNELS = re.compile(r"\b(fwd|dq|dkv)_(sm90|f32)\b")


def kernel_seconds(profile: dict) -> float:
    return sum(e - s for name, s, e in profile["kernels"] if KERNELS.search(name)) * 1e-6


def read(t: dict):
    prof, calls = t.get("profile"), t.get("attention_calls")
    if not prof or not calls:
        return None
    seconds = kernel_seconds(prof)
    if seconds <= 0:
        return None
    bound = sum(c["count"] * flops.attention_bound_s(c["BH"], c["T"], c["D"], c["sep"], c["dtype"], c["backward"])
                for c in calls)
    return 100.0 * bound / seconds
