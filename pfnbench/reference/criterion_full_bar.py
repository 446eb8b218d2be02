"""The full-support bar distribution's NLL: a histogram over the buckets
between ``borders``, whose two end buckets are half-normal tails reaching
past the inner borders, each with the scale that puts half its mass within
the end bucket's width."""

from __future__ import annotations

import math

import torch

# sqrt(2) erfinv(1/2): the median of a unit half-normal.
_HALFNORMAL_MEDIAN = math.sqrt(2.0) * 0.47693627620446987


def nll(logits, y, borders):
    """-log p(y) (B, T) of logits (B, T, K) and targets (B, T)."""
    borders = borders.to(logits.dtype)
    K = borders.numel() - 1
    widths = borders[1:] - borders[:-1]
    y = y.to(logits.dtype)
    idx = (torch.searchsorted(borders, y.contiguous()) - 1).clamp(0, K - 1)
    idx = torch.where(y == borders[0], torch.zeros_like(idx), idx)
    logp = torch.log_softmax(logits, dim=-1) - torch.log(widths)
    picked = torch.gather(logp, -1, idx[..., None])[..., 0]

    def tail(dist, width):
        scale = width / _HALFNORMAL_MEDIAN
        return 0.5 * math.log(2.0 / math.pi) - torch.log(scale) - 0.5 * (dist / scale) ** 2 + torch.log(width)

    picked = torch.where(idx == 0, picked + tail((borders[1] - y).clamp_min(1e-8), widths[0]), picked)
    picked = torch.where(idx == K - 1, picked + tail((y - borders[-2]).clamp_min(1e-8), widths[-1]), picked)
    return -picked
