"""Criterions and the weight bridge. The train loop is ROADMAP.md queue 1
item 6 (the training slice)."""

from pfn_tpu_torch.train.checkpoints import seeded_flax_params, state_dict_from_flax_params
from pfn_tpu_torch.train.losses import (
    Criterion,
    bar_criterion,
    bce_criterion,
    ce_criterion,
    full_support_bar_criterion,
    gaussian_nll_criterion,
    mse_criterion,
)

__all__ = [
    "Criterion",
    "bar_criterion",
    "bce_criterion",
    "ce_criterion",
    "full_support_bar_criterion",
    "gaussian_nll_criterion",
    "mse_criterion",
    "seeded_flax_params",
    "state_dict_from_flax_params",
]
