"""Data transforms shared by priors.

Port of ``pfn_tpu/priors/transforms.py`` (reference priors/utils.py:73-100).
Batch-first layout: the sequence axis is 1. Two differences of the libraries
are taken care of here: ``torch.std`` defaults to the unbiased estimator
(``jnp.std`` has ddof 0), and ``torch.median`` returns the lower of the two
middle values where ``jnp.median`` averages them.
"""

from __future__ import annotations

import torch


def normalize_data(data: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Z-score along the sequence axis: (data - mean) / (std + 1e-6), the
    population std (reference priors/utils.py:73-78)."""
    mean = data.mean(dim=dim, keepdim=True)
    std = data.std(dim=dim, keepdim=True, correction=0) + 1e-6
    return (data - mean) / std


def normalize_by_used_features(x, num_features_used, num_features: int):
    """Rescale when only a subset of features carries signal and the rest is
    zero-padding (reference priors/utils.py:81-82)."""
    return x / (num_features_used / num_features)


def median(data: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """``jnp.median`` along ``dim`` with the dimension kept: the mean of the
    two middle values when the length is even ((lo + hi) * 0.5, as its
    "midpoint" rule computes it), the middle value when it is odd."""
    n = data.shape[dim]
    s = data.sort(dim=dim).values
    lo = s.narrow(dim, (n - 1) // 2, 1)
    hi = s.narrow(dim, n // 2, 1)
    return (lo + hi) * 0.5


def binarize_by_median(y: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Per-dataset median threshold -> {0., 1.} labels, y > median along the
    sequence axis (the JAX package's per-dataset reading of the reference's
    Binarize, priors/utils.py:85-91)."""
    return (y > median(y, dim)).to(torch.float32)


def order_by_y(x: torch.Tensor, y: torch.Tensor, generator: torch.Generator | None = None):
    """Sort each dataset by y in a random direction, then interleave the two
    halves (reference priors/utils.py:94-100). x: (B, T, F), y: (B, T); T
    even."""
    B, T = y.shape
    up = torch.rand((B, 1), generator=generator, device=y.device) < 0.5
    return order_by_y_from_draws(x, y, up)


def order_by_y_from_draws(x: torch.Tensor, y: torch.Tensor, up: torch.Tensor):
    """:func:`order_by_y` given its draw: ``up`` (B, 1) bool, True where the
    dataset is sorted by ascending y. The sort is stable, as ``jnp.argsort``."""
    B, T = y.shape
    sign = torch.where(up, 1.0, -1.0)
    order = torch.argsort(sign * y, dim=1, stable=True)
    order = order.reshape(B, 2, -1).transpose(1, 2).reshape(B, -1)
    return torch.gather(x, 1, order[..., None].expand_as(x)), torch.gather(y, 1, order)
