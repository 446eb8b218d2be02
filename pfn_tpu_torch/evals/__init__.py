"""Evaluation harness and exact-posterior oracles."""

from pfn_tpu_torch.evals.harness import (
    eval_positional_logits_per_dataset,
    eval_positional_loss,
    eval_positional_loss_per_dataset,
    pfn_predict,
)
from pfn_tpu_torch.evals.oracles import gp_exact_evaluate, gp_exact_posterior_moments

__all__ = [
    "eval_positional_logits_per_dataset",
    "eval_positional_loss",
    "eval_positional_loss_per_dataset",
    "gp_exact_evaluate",
    "gp_exact_posterior_moments",
    "pfn_predict",
]
