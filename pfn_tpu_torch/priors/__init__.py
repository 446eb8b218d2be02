"""Priors: synthetic-dataset samplers driven by explicit torch Generators."""

from pfn_tpu_torch.priors.base import sample_y_for_buckets
from pfn_tpu_torch.priors.gp import GPPrior

__all__ = ["GPPrior", "sample_y_for_buckets"]
