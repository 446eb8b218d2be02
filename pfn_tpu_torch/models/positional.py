"""Positional encodings: (B, T, D) -> (B, T, D). Port of
``pfn_tpu/models/positional.py``.

``NoPositionalEncoding`` is the PFN default: the PFN attention setup is
permutation-equivariant over train points, so positions carry no
information. The others add a table to the tokens.

Factory protocol: the JAX package builds an encoding as ``factory(max_len=)``
and flax infers the width from the input; a torch module needs it up front,
so the port calls ``factory(emsize, max_len=)``. ``forward(x,
deterministic)`` takes the model's flag: True in eval mode or at dropout 0,
as the JAX train loop sets it.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class NoPositionalEncoding(nn.Module):
    """Identity (reference positional_encodings.py:12-18)."""

    def __init__(self, emsize: int | None = None, max_len: int = 0):
        super().__init__()
        self.max_len = max_len

    def forward(self, x, deterministic: bool = True):
        return x


def sinusoidal_table(max_len: int, d_model: int) -> torch.Tensor:
    """The sin/cos table (max_len, d_model) in f32, computed as the JAX
    module computes it (sin in the even columns, cos in the odd ones)."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32) * (-math.log(10000.0) / d_model))
    pe = torch.zeros(max_len, d_model)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class SinusoidalPositionalEncoding(nn.Module):
    """The classic sin/cos table added to the input (reference
    positional_encodings.py:21-34). The table is a non-persistent buffer:
    it has no parameters, as in the JAX module."""

    def __init__(self, emsize: int, max_len: int = 5000):
        super().__init__()
        if emsize % 2:
            raise ValueError(f"the sinusoidal table needs an even emsize, got {emsize}")
        self.max_len = max_len
        self.register_buffer("table", sinusoidal_table(max_len, emsize), persistent=False)

    def forward(self, x, deterministic: bool = True):
        return x + self.table[None, : x.shape[1], :].to(x.dtype)


class LearnedPositionalEncoding(nn.Module):
    """A learned position table, init N(0, d_model^-0.5) (reference
    positional_encodings.py:37-49)."""

    def __init__(self, emsize: int, max_len: int = 5000):
        super().__init__()
        self.max_len = max_len
        self.pos_embedding = nn.Parameter(torch.empty(max_len, emsize))
        nn.init.normal_(self.pos_embedding, std=emsize**-0.5)

    def forward(self, x, deterministic: bool = True):
        return x + self.pos_embedding[None, : x.shape[1], :]


class PairedScrambledPositionalEncodings(LearnedPositionalEncoding):
    """A learned table whose pairs of rows the JAX module permutes at random
    in every non-deterministic forward (reference positional_encodings.py:
    52-62). Needs an even ``max_len``.

    Deterministic (eval mode, or dropout 0 in training, as the JAX train loop
    calls it) it adds its table unscrambled, as the JAX module does. The JAX
    train loop gives the model only a "dropout" stream, so with dropout > 0
    the JAX model raises for the missing "scramble" stream
    (``pfn_tpu/train/loop.py:229-235``); the port keeps that defect and
    raises ``ValueError`` there, naming it (ROADMAP.md queue 3 item 5),
    rather than drawing a permutation the JAX package never draws.
    """

    def __init__(self, emsize: int, max_len: int = 5000):
        if max_len % 2:
            raise ValueError("Please specify an even max_len.")
        super().__init__(emsize, max_len)

    def forward(self, x, deterministic: bool = True):
        if not deterministic:
            raise ValueError(
                "PairedScrambledPositionalEncodings in training with dropout > 0: the JAX package's train "
                "loop passes no 'scramble' RNG stream and raises there (an inherited defect, ROADMAP.md "
                "queue 3 item 5); train it with dropout 0, where it adds its table unscrambled")
        return super().forward(x, deterministic)
