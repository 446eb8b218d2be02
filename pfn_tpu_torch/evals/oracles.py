"""Exact-posterior oracles: the ground truth the amortized PFN is scored
against.

Port of ``pfn_tpu/evals/oracles.py``:
  * :func:`gp_exact_evaluate` and :func:`gp_exact_posterior_moments`: each
    context size t conditions on the first t points with the context-mask
    trick, batched over datasets; the loop runs over positions, so a
    (P, B, T, T) tensor is never built. ``dtype=torch.float64`` works on
    either device.
  * :func:`ridge_evaluate`: ridge point predictions with an intercept, refit
    at every context size, scored as MSE against the noise-free targets.
  * :func:`bayes_linreg_posterior`: the exact Bayesian linear-regression
    posterior predictive.

The two linear-regression oracles compute in float64 on their inputs'
device; the JAX functions compute in their inputs' dtype (f32).
"""

from __future__ import annotations

import math
import time

import torch

from pfn_tpu_torch.ops.gp_sample import gp_posterior, rbf_kernel

_LOG_2PI = math.log(2.0 * math.pi)
# Entries of the (t, B, T, F) centred design that ridge_evaluate builds at
# once: 128 MB of f64.
_RIDGE_CHUNK_ELEMS = 1 << 24
_DEFAULT_HP = {"noise": 0.1, "outputscale": 0.1, "lengthscale": 0.1}


def _gaussian_nll(y, mean, var):
    return 0.5 * (_LOG_2PI + torch.log(var) + (y - mean) ** 2 / var)


def _moments_at(x, y, t: int, hp: dict, kernel, dtype):
    """Posterior predictive (mean, var) at row t given rows [0, t): (B,), (B,)."""
    T = x.shape[1]
    mask = torch.arange(T, device=x.device) < t
    mean, var = gp_posterior(
        x, y, x[:, t : t + 1], lengthscale=hp["lengthscale"], outputscale=hp["outputscale"],
        noise=hp["noise"], kernel=kernel, context_mask=mask, dtype=dtype,
    )
    return mean[:, 0], var[:, 0]


@torch.no_grad()
def gp_exact_evaluate(x, y, hyperparameters: dict | None = None, use_mse: bool = False, kernel=rbf_kernel,
                      step_size: int = 1, start_pos: int = 0, positions=None, dtype=torch.float32):
    """Exact GP posterior loss at x[t] given (x[:t], y[:t]) for each t.

    x: (B, T, F), y: (B, T). Returns (all_losses (num_t, B), mean_losses,
    elapsed_seconds); mean_losses has a leading 0.0 when start_pos == 0 and
    no explicit ``positions`` are given, like reference fast_gp.py:91.
    """
    hp = hyperparameters or _DEFAULT_HP
    t0 = time.time()
    T = x.shape[1]
    if positions is not None:
        ts = [int(t) for t in positions]
        start_pos = 1  # no leading zero
    else:
        ts = list(range(max(start_pos, 1), T, step_size))
    rows = []
    for t in ts:
        m, v = _moments_at(x, y, t, hp, kernel, dtype)
        yt = y[:, t].to(dtype)
        rows.append((m - yt) ** 2 if use_mse else _gaussian_nll(yt, m, v))
    all_losses = torch.stack(rows)
    mean_losses = all_losses.mean(dim=1)
    if start_pos == 0:
        mean_losses = torch.cat([torch.zeros(1, dtype=mean_losses.dtype, device=mean_losses.device), mean_losses])
    return all_losses, mean_losses, time.time() - t0


@torch.no_grad()
def gp_exact_posterior_moments(x, y, hyperparameters: dict | None = None, positions=None, kernel=rbf_kernel,
                               dtype=torch.float32):
    """Exact GP posterior predictive moments (mean, variance incl. noise) at
    x[t] given (x[:t], y[:t]) for each t in ``positions`` (default 1 .. T-1):
    the oracle side of the analytic KL gap. Returns (means (P, B), vars (P, B))."""
    hp = hyperparameters or _DEFAULT_HP
    ts = range(1, x.shape[1]) if positions is None else [int(t) for t in positions]
    moments = [_moments_at(x, y, t, hp, kernel, dtype) for t in ts]
    return torch.stack([m for m, _ in moments]), torch.stack([v for _, v in moments])


@torch.no_grad()
def ridge_evaluate(x, y, y_non_noisy, alpha: float = 0.0):
    """Ridge-regression point predictions with an intercept (sklearn's
    default, reference priors/ridge.py:28-30), refit at every context size t,
    scored as MSE against the noise-free targets.

    x: (B, T, F), y and y_non_noisy: (B, T). At context size t the fit uses
    rows [0, t), centred on their means, and predicts row t. Returns (losses
    (T,), seconds) with losses[0] = 0, as the reference (ridge.py:24). The
    centred normal equations get 1e-9 on the diagonal, as in the JAX package,
    so t = 1 predicts mean(y). Context sizes are batched in chunks of at most
    ``_RIDGE_CHUNK_ELEMS`` entries of the (t, B, T, F) centred design, in
    float64 on x's device.
    """
    t0 = time.time()
    B, T, F = x.shape
    dtype = torch.float64
    x, y, y_clean = x.to(dtype), y.to(dtype), y_non_noisy.to(dtype)
    eye = torch.eye(F, dtype=dtype, device=x.device)
    rows = torch.arange(T, device=x.device)
    per_chunk = max(1, _RIDGE_CHUNK_ELEMS // (B * T * F))
    losses = [torch.zeros(1, dtype=dtype, device=x.device)]
    for start in range(1, T, per_chunk):
        ts = torch.arange(start, min(start + per_chunk, T), device=x.device)  # (C,)
        mask = (rows[None, :] < ts[:, None]).to(dtype)[:, None, :]  # (C, 1, T)
        n = mask.sum(-1, keepdim=True)  # (C, 1, 1)
        xm = (x[None] * mask[..., None]).sum(2) / n  # (C, B, F)
        ym = (y[None] * mask).sum(2) / n[..., 0]  # (C, B)
        xc = (x[None] - xm[:, :, None, :]) * mask[..., None]  # (C, B, T, F)
        yc = (y[None] - ym[..., None]) * mask  # (C, B, T)
        xct = xc.transpose(-1, -2)
        A = xct @ xc + alpha * eye
        w = torch.linalg.solve(A + 1e-9 * eye, xct @ yc[..., None])[..., 0]  # (C, B, F)
        pred = ((x[:, ts, :].transpose(0, 1) - xm) * w).sum(-1) + ym  # (C, B)
        losses.append(((pred - y_clean[:, ts].T) ** 2).mean(-1))
    return torch.cat(losses), time.time() - t0


@torch.no_grad()
def bayes_linreg_posterior(x_train, y_train, x_query, weight_std: float, noise_std: float, context_mask=None):
    """Exact Bayesian linear regression posterior predictive.

    Prior w ~ N(0, weight_std^2 I), y = x.w + N(0, noise_std^2): the ridge
    prior's generative process (priors/ridge.py:10-16). x_train: (..., N, F),
    y_train: (..., N), x_query: (..., Q, F), leading axes a batch of
    datasets; ``context_mask`` (N,) or (..., N) drops rows from the
    conditioning. Returns (mean, var) of the posterior predictive at x_query,
    (..., Q) each, var including the noise, in float64.
    """
    F = x_train.shape[-1]
    dtype = torch.float64
    s2w, s2n = weight_std**2, noise_std**2
    xt, yt, xq = x_train.to(dtype), y_train.to(dtype), x_query.to(dtype)
    if context_mask is not None:
        m = torch.as_tensor(context_mask, device=xt.device).to(dtype)
        xt = xt * m[..., None]
        yt = yt * m
    A = xt.transpose(-1, -2) @ xt / s2n + torch.eye(F, dtype=dtype, device=xt.device) / s2w
    mu = torch.linalg.solve(A, (xt.transpose(-1, -2) @ yt[..., None]) / s2n)  # (..., F, 1)
    mean = (xq @ mu)[..., 0]
    var = (xq * torch.linalg.solve(A, xq.transpose(-1, -2)).transpose(-1, -2)).sum(-1) + s2n
    return mean, var
