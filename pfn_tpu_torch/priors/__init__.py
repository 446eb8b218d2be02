"""Priors: synthetic-dataset samplers driven by explicit torch Generators.

The protocol (``base.Prior``): ``num_features``, ``num_outputs`` and
``sample(batch_size, seq_len, generator=, device=) -> (x (B, T, F), y (B, T),
target_y (B, T))``, every draw from the generator, on its device.
"""

from pfn_tpu_torch.priors import hyper, transforms
from pfn_tpu_torch.priors.base import (
    Prior,
    PriorDataLoader,
    default_group_size,
    make_dataloader,
    sample_y_for_buckets,
)
from pfn_tpu_torch.priors.binarize import BinarizedPrior, binarized_gp_mix_prior, binarized_gp_prior
from pfn_tpu_torch.priors.gp import GPPrior
from pfn_tpu_torch.priors.gp_mix import GPMixPrior
from pfn_tpu_torch.priors.mixture import BatchMixture
from pfn_tpu_torch.priors.mlp import MLPPrior
from pfn_tpu_torch.priors.module import ModulePrior
from pfn_tpu_torch.priors.omniglot import OmniglotPrior, omniglot_accuracy, translate_image
from pfn_tpu_torch.priors.ridge import RidgePrior
from pfn_tpu_torch.priors.stroke import StrokePrior

__all__ = [
    "BatchMixture",
    "BinarizedPrior",
    "GPMixPrior",
    "GPPrior",
    "MLPPrior",
    "ModulePrior",
    "OmniglotPrior",
    "Prior",
    "PriorDataLoader",
    "RidgePrior",
    "StrokePrior",
    "binarized_gp_mix_prior",
    "binarized_gp_prior",
    "default_group_size",
    "hyper",
    "make_dataloader",
    "omniglot_accuracy",
    "sample_y_for_buckets",
    "transforms",
    "translate_image",
]
