"""Decoder heads (B, T, D) -> (B, T, n_out). Port of ``MLPDecoder`` from
``pfn_tpu/models/decoders.py``; the scaled decoders are ROADMAP.md queue 1
item 9."""

from __future__ import annotations

from torch import nn

from pfn_tpu_torch.models.init import lecun_normal_


class MLPDecoder(nn.Sequential):
    """Linear -> GELU -> Linear (reference transformer.py:23). Submodules
    ``0`` and ``2`` carry the reference state_dict names ``decoder.0`` and
    ``decoder.2``. ``approximate=False`` selects the exact erf GELU."""

    def __init__(self, emsize: int, nhid: int, n_out: int, approximate: bool = True):
        super().__init__(
            nn.Linear(emsize, nhid),
            nn.GELU(approximate="tanh" if approximate else "none"),
            nn.Linear(nhid, n_out),
        )
        for layer in (self[0], self[2]):
            lecun_normal_(layer.weight)
            nn.init.zeros_(layer.bias)
