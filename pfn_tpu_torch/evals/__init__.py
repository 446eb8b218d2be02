"""Evaluation harness, exact-posterior oracles and the tabular PFN
evaluation."""

from pfn_tpu_torch.evals.harness import (
    eval_positional_logits_per_dataset,
    eval_positional_loss,
    eval_positional_loss_per_dataset,
    pfn_predict,
)
from pfn_tpu_torch.evals.oracles import gp_exact_evaluate, gp_exact_posterior_moments
from pfn_tpu_torch.evals.tabular import build_windows, evaluate_position_pfn, roc_auc

__all__ = [
    "build_windows",
    "eval_positional_logits_per_dataset",
    "eval_positional_loss",
    "eval_positional_loss_per_dataset",
    "evaluate_position_pfn",
    "gp_exact_evaluate",
    "gp_exact_posterior_moments",
    "pfn_predict",
    "roc_auc",
]
