"""Evaluation harness and validator, exact-posterior oracles (GP and linear
regression), the tabular evaluation with its baselines, the approximate
inference oracles (SVI, HMC, SVGD), the Bayesian-comparison harness and the
GP-mix MAP and hyper-MCMC oracles."""

from pfn_tpu_torch.evals import comparison, gp_mix_oracles, inference, tabular
from pfn_tpu_torch.evals.harness import (
    draw_validation_batch,
    eval_positional_logits_per_dataset,
    eval_positional_loss,
    eval_positional_loss_per_dataset,
    make_mean_mse_validator,
    mean_mse,
    pfn_predict,
)
from pfn_tpu_torch.evals.oracles import (
    bayes_linreg_posterior,
    gp_exact_evaluate,
    gp_exact_posterior_moments,
    ridge_evaluate,
)
from pfn_tpu_torch.evals.tabular import build_windows, evaluate_position_pfn, roc_auc

__all__ = [
    "bayes_linreg_posterior",
    "build_windows",
    "comparison",
    "gp_mix_oracles",
    "draw_validation_batch",
    "eval_positional_logits_per_dataset",
    "eval_positional_loss",
    "eval_positional_loss_per_dataset",
    "evaluate_position_pfn",
    "gp_exact_evaluate",
    "gp_exact_posterior_moments",
    "inference",
    "make_mean_mse_validator",
    "mean_mse",
    "pfn_predict",
    "ridge_evaluate",
    "roc_auc",
    "tabular",
]
