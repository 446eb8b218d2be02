"""The model's weights, drawn from the seed on the device.

One normal draw of all the parameters from a ``torch.Generator`` on the
device, cut into the leaves and scaled: a matrix by 1/sqrt(fan in), a bias
by 0.02, a LayerNorm gain 1 + 0.1 n and its bias 0.1 n. Every leaf is
nonzero, the attention's out-projection and the FFN's second matrix
included (the program starts them at zero), so that the attention and FFN
paths reach the output and the check sees them from the first update.
The benchmark hands the same dict to the program and to the reference.
"""

from __future__ import annotations

import math

import torch


def parameter_shapes(model: dict, num_features: int, n_out: int) -> dict:
    """{torch state_dict name: shape} of the PFN of ``model``'s sizes."""
    D, F, L = model["emsize"], model["nhid"], model["nlayers"]
    shapes = {"encoder.weight": (D, num_features), "encoder.bias": (D,), "y_encoder.weight": (D, 1),
              "y_encoder.bias": (D,)}
    for n in range(L):
        p = f"transformer_encoder.layers.{n}."
        shapes.update({p + "self_attn.in_proj_weight": (3 * D, D), p + "self_attn.in_proj_bias": (3 * D,),
                       p + "self_attn.out_proj.weight": (D, D), p + "self_attn.out_proj.bias": (D,),
                       p + "linear1.weight": (F, D), p + "linear1.bias": (F,),
                       p + "linear2.weight": (D, F), p + "linear2.bias": (D,),
                       p + "norm1.weight": (D,), p + "norm1.bias": (D,),
                       p + "norm2.weight": (D,), p + "norm2.bias": (D,)})
    shapes.update({"decoder.0.weight": (F, D), "decoder.0.bias": (F,), "decoder.2.weight": (n_out, F),
                   "decoder.2.bias": (n_out,)})
    return shapes


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
