"""Bar-distribution output heads."""

from pfn_tpu_torch.distributions.bar import BarDistribution, FullSupportBarDistribution, get_bucket_limits

__all__ = ["BarDistribution", "FullSupportBarDistribution", "get_bucket_limits"]
