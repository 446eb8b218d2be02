"""Attention and GP-sampling ops; the CUDA kernel sources live in ``csrc/``."""

from pfn_tpu_torch.ops.attention import (
    pfn_attention,
    pfn_attention_prefix_merge,
    pfn_attention_reference,
    pfn_mask,
    pfn_prefix_attention_reference,
)
from pfn_tpu_torch.ops.flash_attention import pfn_flash_attention, pfn_flash_prefix_attention
from pfn_tpu_torch.ops.gp_sample import (
    gp_posterior,
    gp_sample_paths,
    gp_sample_paths_grid,
    matern52_kernel,
    psd_safe_cholesky,
    rbf_kernel,
)

__all__ = [
    "gp_posterior",
    "gp_sample_paths",
    "gp_sample_paths_grid",
    "matern52_kernel",
    "pfn_attention",
    "pfn_attention_prefix_merge",
    "pfn_attention_reference",
    "pfn_flash_attention",
    "pfn_flash_prefix_attention",
    "pfn_mask",
    "pfn_prefix_attention_reference",
    "psd_safe_cholesky",
    "rbf_kernel",
]
