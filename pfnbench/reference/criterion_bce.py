"""Binary cross-entropy of one logit: softplus(l) - l y, written stably."""

from __future__ import annotations

import torch


def nll(logits, y, borders=None):
    logit = logits[..., 0]
    return logit.clamp_min(0) - logit * y + torch.log1p(torch.exp(-logit.abs()))
