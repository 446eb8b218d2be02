"""Decoder heads (B, T, D) -> (B, T, n_out). Port of
``pfn_tpu/models/decoders.py``: the default Linear -> GELU -> Linear head,
and the scaled heads ``ScaledDecoder`` (a per-token softmax mixture over 10
fixed temperatures, reference decoders.py:6-20) and ``FixedScaledDecoder``
(one learned temperature, decoders.py:22-29).

Factory protocol: the JAX package builds a head as ``factory(nhid, n_out)``
and flax infers the input width; the port calls ``factory(emsize, nhid,
n_out)``. A head works row by row: each output row depends on its own input
row alone, never on the other rows or on how many there are, since
``PFNTransformer.forward(..., rows=)`` decodes only the rows its caller reads.
Parameter names follow the flax tree (``linear``, ``linear1``, ``linear2``;
``fc1``, ``fc2``, ``T``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pfn_tpu_torch.models.init import lecun_normal_

_TEMPERATURES = (1.0, 1.4, 1.7, 2.0, 5.0, 10.0, 20.0, 40.0, 80.0, 160.0)


def _dense(fan_in: int, fan_out: int) -> nn.Linear:
    """nn.Linear with flax Dense's default init (lecun normal, zero bias)."""
    layer = nn.Linear(fan_in, fan_out)
    lecun_normal_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


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


class ScaledDecoder(nn.Module):
    """Logits divided by a per-token softmax mixture of 10 fixed
    temperatures (reference decoders.py:6-20)."""

    def __init__(self, emsize: int, nhid: int, n_out: int):
        super().__init__()
        self.linear = _dense(emsize, nhid)
        self.linear1 = _dense(nhid, n_out)
        self.linear2 = _dense(nhid, len(_TEMPERATURES))
        self.register_buffer("temperatures", torch.tensor(_TEMPERATURES), persistent=False)

    def forward(self, x):
        h = F.gelu(self.linear(x), approximate="tanh")
        temps = torch.softmax(self.linear2(h), dim=-1) @ self.temperatures
        return self.linear1(h) / temps[..., None]


class FixedScaledDecoder(nn.Module):
    """Logits divided by one global learned temperature ``T``, init 1
    (reference decoders.py:22-29, whose 10000-vector summing to 1 is the
    same scalar)."""

    def __init__(self, emsize: int, nhid: int, n_out: int):
        super().__init__()
        self.fc1 = _dense(emsize, nhid)
        self.fc2 = _dense(nhid, n_out)
        self.T = nn.Parameter(torch.ones(()))

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh")) / self.T
