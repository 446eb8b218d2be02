"""Training: criterions, the train loop and its checkpoints, and the weight
bridge from the JAX package."""

from pfn_tpu_torch.train.checkpoints import (
    latest_state_checkpoint,
    prune_state_checkpoints,
    restore_checkpoint,
    save_checkpoint,
    seeded_flax_params,
    state_dict_from_flax_params,
)
from pfn_tpu_torch.train.loop import TrainConfig, TrainResult, TrainState, build_model, train
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
    "TrainConfig",
    "TrainResult",
    "TrainState",
    "bar_criterion",
    "bce_criterion",
    "build_model",
    "ce_criterion",
    "full_support_bar_criterion",
    "gaussian_nll_criterion",
    "latest_state_checkpoint",
    "mse_criterion",
    "prune_state_checkpoints",
    "restore_checkpoint",
    "save_checkpoint",
    "seeded_flax_params",
    "state_dict_from_flax_params",
    "train",
]
