"""pfn_tpu_torch: the PyTorch/CUDA port of ``pfn_tpu``.

A Prior-Data Fitted Network (PFN) is a transformer meta-trained on datasets
drawn from a prior, so that one forward pass gives the posterior predictive
for a new dataset. This package is the port of the JAX package ``pfn_tpu`` to
PyTorch on an NVIDIA H100; ``pfn_tpu`` stays the reference it is tested
against. The layout mirrors it: ``pfn_tpu/X/y.py`` has its counterpart at
``pfn_tpu_torch/X/y.py``.

This package imports torch and never jax. What is ported so far: the
inference slice (GP prior → PFN forward with the hand-written PFN
flash-attention kernel → bar-distribution posterior summaries → exact-GP
oracle), the training slice (samplers and schedules → masked loss → backward
through the hand-written flash-attention backward kernels → clipped Adam →
checkpoints and resume, in ``train.train``), the fused-layer path, and the
tabular classification slice (the MLP/BNN, GP-mix, binarized and mixture
priors → BCE training → ``PFNClassifier`` → ``evals.tabular``'s PFN
evaluation). See ROADMAP.md for what remains.
"""

__version__ = "0.1.0"

from pfn_tpu_torch import distributions, evals, inference, models, ops, priors, train, utils
from pfn_tpu_torch.inference import PFNClassifier, PFNRegressor

__all__ = [
    "PFNClassifier",
    "PFNRegressor",
    "distributions",
    "evals",
    "inference",
    "models",
    "ops",
    "priors",
    "train",
    "utils",
]
