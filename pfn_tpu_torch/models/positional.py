"""Positional encodings. Port of ``NoPositionalEncoding`` from
``pfn_tpu/models/positional.py``; the PFN attention setup is
permutation-equivariant over train points, so positions carry no
information. The learned and sinusoidal encodings are ROADMAP.md queue 1
item 9."""

from __future__ import annotations

from torch import nn


class NoPositionalEncoding(nn.Module):
    """Identity (reference positional_encodings.py:12-18)."""

    def __init__(self, max_len: int = 0):
        super().__init__()
        self.max_len = max_len

    def forward(self, x):
        return x
