"""PFN evaluation harness: amortized posterior prediction, sweeps over
context sizes, and the training loop's MSE validator.

Port of ``pfn_tpu/evals/harness.py``. The model is a ``PFNTransformer``
holding its weights (the JAX functions take ``model, params``); each
``lax.map`` over positions is a Python loop, one forward per position. Each
forward decodes only the rows the function reads (``pfn_predict(...,
rows=)``): the scored row, or the eval rows >= sep; the values returned are
those of the whole output. The functions run without autograd.
"""

from __future__ import annotations

import torch


def _positions(positions, T: int) -> list[int]:
    return list(range(1, T)) if positions is None else [int(t) for t in positions]


def pfn_predict(model, x, y, single_eval_pos, rows=None):
    """One amortized-inference forward pass.

    x: (B, T, F) with context rows [0, sep) and query rows [sep, T); y: (B, T)
    with query entries ignored (zeroed here). Returns logits (B, T, n_out);
    rows >= sep are the posterior predictions. ``rows=(start, stop)``: only
    those rows are decoded and returned, (B, stop - start, n_out).
    """
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    y_ctx = torch.where(pos < single_eval_pos, y, torch.zeros_like(y))
    if rows is None:
        return model(x, y_ctx, single_eval_pos)
    return model(x, y_ctx, single_eval_pos, rows=rows)


@torch.no_grad()
def eval_positional_loss_per_dataset(model, criterion, x, y, target_y=None, positions=None):
    """Loss at row t of a forward with single_eval_pos = t, for each t in
    ``positions`` (default 1 .. T-1): a (len(positions), B) tensor."""
    target_y = y if target_y is None else target_y
    scored = []
    for sep in _positions(positions, x.shape[1]):
        losses = criterion.per_position(pfn_predict(model, x, y, sep, rows=(sep, sep + 1)),
                                        target_y[:, sep:sep + 1])  # (B, 1)
        scored.append(losses[:, 0])
    return torch.stack(scored)


@torch.no_grad()
def eval_positional_logits_per_dataset(model, x, y, positions):
    """Head outputs at each context size: (len(positions), B, n_out), the
    logits at row t of a forward with single_eval_pos = t. Feeds analytic
    scoring against a Gaussian oracle
    (FullSupportBarDistribution.gaussian_kl)."""
    return torch.stack([pfn_predict(model, x, y, sep, rows=(sep, sep + 1))[:, 0, :]
                        for sep in _positions(positions, x.shape[1])])


def eval_positional_loss(model, criterion, x, y, target_y=None, positions=None):
    """Batch mean and (population) std of the loss at each context size in
    ``positions``: the Fig-3a model curve. Returns two (len(positions),)
    tensors."""
    losses = eval_positional_loss_per_dataset(model, criterion, x, y, target_y, positions)
    return losses.mean(dim=1), losses.std(dim=1, correction=0)


def _validation_positions(seq_len: int, positions) -> list[int]:
    return list(range(1, seq_len, max(1, seq_len // 10))) if positions is None else [int(t) for t in positions]


def draw_validation_batch(prior, batch_size: int, seq_len: int, seed: int = 0, device=None):
    """The validator's fixed batch, (x, y, target_y), from a
    ``torch.Generator`` on ``device`` seeded with ``seed``: the draw the JAX
    validator makes at ``PRNGKey(seed)``."""
    generator = torch.Generator(device=device or "cpu").manual_seed(seed)
    return prior.sample(batch_size, seq_len, generator=generator, device=device)


@torch.no_grad()
def mean_mse(model, criterion, x, y, target_y, positions=None) -> torch.Tensor:
    """The validator's score on a given batch: for each sep in ``positions``
    (default 1, 1 + T//10, ... < T) the squared error of the posterior mean
    (``criterion.mean``) against target_y over the eval rows >= sep, summed
    over the batch and divided by the number of eval rows, as the JAX
    validator's ``jnp.sum(se * mask) / jnp.sum(mask)`` does with its (1, T)
    mask; then the mean over positions. A 0-dim tensor."""
    T = x.shape[1]
    scores = []
    for sep in _validation_positions(T, positions):
        mean = criterion.mean(pfn_predict(model, x, y, sep, rows=(sep, T)))  # (B, T - sep): the eval rows
        scores.append(((mean - target_y[:, sep:]) ** 2).sum() / max(T - sep, 1))
    return torch.stack(scores).mean()


def make_mean_mse_validator(prior, criterion, batch_size: int = 32, seq_len: int = 50, positions=None,
                            seed: int = 0):
    """A ``validate_fn(model) -> float`` for ``train(validate_fn=...)``.

    Parity: the gp-mix DataLoader.validate hook (reference
    fast_gp_mix.py:139-153): a fixed batch, a sweep over eval positions, and
    the MSE of the posterior-mean prediction (:func:`mean_mse`). The batch is
    drawn once, at the first call, on the model's device
    (:func:`draw_validation_batch`), where the JAX validator draws it again
    at the same key on every call.
    """
    batch = {}

    def validate_fn(model) -> float:
        device = next(model.parameters()).device
        if device not in batch:
            batch[device] = draw_validation_batch(prior, batch_size, seq_len, seed, device)
        return float(mean_mse(model, criterion.to(device), *batch[device], positions))

    return validate_fn
