"""Exact-GP oracles: the ground truth the amortized PFN is scored against.

Port of ``gp_exact_evaluate`` and ``gp_exact_posterior_moments`` from
``pfn_tpu/evals/oracles.py``. Each context size t conditions on the first t
points with the context-mask trick, batched over datasets; the loop runs over
positions, so a (P, B, T, T) tensor is never built. ``dtype=torch.float64``
works on either device.
"""

from __future__ import annotations

import math
import time

import torch

from pfn_tpu_torch.ops.gp_sample import gp_posterior, rbf_kernel

_LOG_2PI = math.log(2.0 * math.pi)
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
