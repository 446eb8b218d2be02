"""Posterior visualisation helpers."""

from pfn_tpu_torch.presentation.heatmap import (
    heatmap_with_box_sizes,
    plot_bar_distribution,
    plot_model_and_orig_curve,
    plot_model_w_eval_pos,
)

__all__ = [
    "heatmap_with_box_sizes",
    "plot_bar_distribution",
    "plot_model_and_orig_curve",
    "plot_model_w_eval_pos",
]
