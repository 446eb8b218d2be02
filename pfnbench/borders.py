"""Bucket borders, an input the benchmark makes and hands to both sides.

The recipe's rule: ``prior_ys`` target values from datasets of length
``seq_cap`` drawn by the benchmark's own draw of the prior, from a fixed
seed; equal-mass buckets, each border the midpoint of the two sorted values
it falls between, the ends the sample's minimum and maximum.
"""

from __future__ import annotations

import torch

from pfnbench.reference import part


def make(criterion: dict, prior: dict, device) -> torch.Tensor | None:
    """float32 borders (num_buckets + 1,) on ``device``, or None where the
    criterion has none."""
    rule = criterion.get("borders")
    if rule is None:
        return None
    K, n, cap = criterion["num_buckets"], rule["prior_ys"], rule["seq_cap"]
    g = torch.Generator(device=device).manual_seed(rule["seed"])
    datasets = max(1, n // cap)
    ys = part("prior", prior["kind"]).draw(g, datasets, cap, prior)["y"].reshape(-1)
    ys = ys[: ys.numel() - ys.numel() % K]
    per = ys.numel() // K
    s = torch.sort(ys.double()).values
    inner = (s[per - 1::per][:-1] + s[per::per]) / 2
    return torch.cat([s[:1], inner, s[-1:]]).float()
