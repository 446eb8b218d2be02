"""Parameter initialisers matching flax's defaults, so a model built by the
port starts from the same distribution as one built by the JAX package."""

from __future__ import annotations

import math

import torch
from torch import nn

# Standard deviation of a unit normal truncated to [-2, 2] (flax's
# truncated-normal variance scaling divides by it).
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int | None = None) -> torch.Tensor:
    """flax.linen.Dense's default kernel init: truncated normal with
    variance 1 / fan_in. ``weight`` is torch-shaped (out, in), whose fan_in
    is ``in``, unless ``fan_in`` is given."""
    std = math.sqrt(1.0 / (fan_in or weight.shape[1])) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)
