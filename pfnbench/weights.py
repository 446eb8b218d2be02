"""The model's weights, drawn from the seed on the device.

One normal draw of all the parameters from a ``torch.Generator`` on the
device, cut into the leaves in the order of the model kind's
``parameter_shapes`` (``models/<kind>.py``) and scaled: a matrix by
1/sqrt(fan in), a bias by 0.02, a LayerNorm gain (a name holding ``.norm``)
1 + 0.1 n and its bias 0.1 n. Every leaf is nonzero, the attention's
out-projection and the FFN's second matrix included (the program starts
them at zero), so that the attention and FFN paths reach the output and the
check sees them from the first update. The benchmark hands the same dict to
the program and to the reference.
"""

from __future__ import annotations

import math

import torch


def make(shapes: dict, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``}, the same for the same seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=g, device=device)
    out, offset = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        z = flat[offset:offset + n].view(shape)
        offset += n
        if len(shape) == 2:
            out[name] = z / math.sqrt(shape[1])
        elif ".norm" in name and name.endswith("weight"):
            out[name] = 1.0 + 0.1 * z
        elif ".norm" in name:
            out[name] = 0.1 * z
        else:
            out[name] = 0.02 * z
    return out
