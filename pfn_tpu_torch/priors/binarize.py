"""Binarized-regression wrapper: regression prior -> Bernoulli classification.

Port of ``pfn_tpu/priors/binarize.py`` (reference
priors/binarized_regression.py:4-21): y becomes Bernoulli(sigmoid(y)) labels
in {0., 1.}; prebuilt binarized GP and GP-mix priors mirror
``Binarized_fast_gp{,_mix}_dataloader``.
"""

from __future__ import annotations

import dataclasses

import torch

from pfn_tpu_torch.priors.base import Prior
from pfn_tpu_torch.priors.gp import GPPrior
from pfn_tpu_torch.priors.gp_mix import GPMixPrior


def bernoulli_labels(y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Bernoulli(sigmoid(y)) labels given uniforms ``u`` of y's shape: u <
    sigmoid(y), as ``jax.random.bernoulli`` compares its uniforms."""
    return (u < torch.sigmoid(y)).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class BinarizedPrior:
    """y ~ Bernoulli(sigmoid(y_regression)); targets are {0., 1.}."""

    base: Prior
    num_outputs: int = 2

    @property
    def num_features(self) -> int:
        return self.base.num_features

    def sample(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None, device=None):
        x, y, _ = self.base.sample(batch_size, seq_len, generator=generator, device=device)
        labels = bernoulli_labels(y, torch.rand(y.shape, generator=generator, device=y.device))
        return x, labels, labels


def binarized_gp_prior(**kwargs) -> BinarizedPrior:
    """Parity: Binarized_fast_gp_dataloader (binarized_regression.py:16-18)."""
    return BinarizedPrior(base=GPPrior(**kwargs))


def binarized_gp_mix_prior(**kwargs) -> BinarizedPrior:
    """Parity: Binarized_fast_gp_mix_dataloader (binarized_regression.py:19-21)."""
    return BinarizedPrior(base=GPMixPrior(**kwargs))
