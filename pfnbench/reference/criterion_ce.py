"""Cross-entropy: -log softmax(logits)[y], y the class index (a float
label, as the priors give it)."""

from __future__ import annotations

import torch


def nll(logits, y, borders=None):
    return -torch.log_softmax(logits, dim=-1).gather(-1, y.long()[..., None])[..., 0]
