"""Evaluation-position (``single_eval_pos``) samplers.

Port of ``pfn_tpu/utils/samplers.py``. A draw is a one-element int32 tensor
on the generator's device, so ``sep`` reaches the model, the loss mask and
the kernels without a host sync.
"""

from __future__ import annotations

import torch


def make_eval_pos_weights(max_len: int, kind: str = "weighted", mixture_floor: float = 0.1,
                          mixture_cap: int = 300, device=None) -> torch.Tensor:
    """Unnormalised float32 weights over positions 0 .. max_len-1.

    ``weighted``: p(i) ∝ 1/(max_len - i), favouring long contexts.
    ``uniform``: equal weights.
    ``mixture``: (1 - mixture_floor) * normalised weighted + mixture_floor *
    uniform over the first min(mixture_cap, max_len) positions, a floor under
    the small contexts that ``weighted`` starves at large max_len.
    """
    pos = torch.arange(max_len, dtype=torch.float32, device=device)
    if kind == "weighted":
        return 1.0 / (max_len - pos)
    if kind == "uniform":
        return torch.ones(max_len, dtype=torch.float32, device=device)
    if kind == "mixture":
        w = 1.0 / (max_len - pos)
        w = w / w.sum()
        cap = min(mixture_cap, max_len)
        u = torch.where(pos < cap, 1.0 / cap, 0.0)
        return (1.0 - mixture_floor) * w + mixture_floor * u
    raise ValueError(f"unknown sampler kind {kind!r}")


def draw_eval_pos(weights: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """One position i ~ weights[i] / sum(weights), as a one-element int32
    tensor on the weights' device."""
    return torch.multinomial(weights, 1, generator=generator).to(torch.int32)


def weighted_single_eval_pos(generator: torch.Generator, max_len: int) -> torch.Tensor:
    """Sample i ~ p(i) ∝ 1/(max_len - i) on the generator's device."""
    return draw_eval_pos(make_eval_pos_weights(max_len, "weighted", device=generator.device), generator)


def uniform_single_eval_pos(generator: torch.Generator, max_len: int) -> torch.Tensor:
    """Sample i uniformly from [0, max_len) on the generator's device."""
    return torch.randint(0, max_len, (1,), generator=generator, device=generator.device, dtype=torch.int32)
