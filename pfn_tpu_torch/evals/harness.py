"""PFN evaluation harness: amortized posterior prediction and sweeps over
context sizes.

Port of ``pfn_tpu/evals/harness.py``. The model is a ``PFNTransformer``
holding its weights (the JAX functions take ``model, params``); each
``lax.map`` over positions is a Python loop, one forward per position. The
functions run without autograd.
"""

from __future__ import annotations

import torch


def _positions(positions, T: int) -> list[int]:
    return list(range(1, T)) if positions is None else [int(t) for t in positions]


def pfn_predict(model, x, y, single_eval_pos):
    """One amortized-inference forward pass.

    x: (B, T, F) with context rows [0, sep) and query rows [sep, T); y: (B, T)
    with query entries ignored (zeroed here). Returns logits (B, T, n_out);
    rows >= sep are the posterior predictions.
    """
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    y_ctx = torch.where(pos < single_eval_pos, y, torch.zeros_like(y))
    return model(x, y_ctx, single_eval_pos)


@torch.no_grad()
def eval_positional_loss_per_dataset(model, criterion, x, y, target_y=None, positions=None):
    """Loss at row t of a forward with single_eval_pos = t, for each t in
    ``positions`` (default 1 .. T-1): a (len(positions), B) tensor."""
    target_y = y if target_y is None else target_y
    rows = []
    for sep in _positions(positions, x.shape[1]):
        losses = criterion.per_position(pfn_predict(model, x, y, sep), target_y)  # (B, T)
        rows.append(losses[:, sep])
    return torch.stack(rows)


@torch.no_grad()
def eval_positional_logits_per_dataset(model, x, y, positions):
    """Head outputs at each context size: (len(positions), B, n_out), the
    logits at row t of a forward with single_eval_pos = t. Feeds analytic
    scoring against a Gaussian oracle
    (FullSupportBarDistribution.gaussian_kl)."""
    return torch.stack([pfn_predict(model, x, y, sep)[:, sep, :] for sep in _positions(positions, x.shape[1])])


def eval_positional_loss(model, criterion, x, y, target_y=None, positions=None):
    """Batch mean and (population) std of the loss at each context size in
    ``positions``: the Fig-3a model curve. Returns two (len(positions),)
    tensors."""
    losses = eval_positional_loss_per_dataset(model, criterion, x, y, target_y, positions)
    return losses.mean(dim=1), losses.std(dim=1, correction=0)
