"""GP-hyperprior-mixture oracles: the MAP-fit GP and HMC over the GP's
hyperparameters.

Port of ``pfn_tpu/evals/gp_mix_oracles.py`` (reference
priors/fast_gp_mix.py):
  * :func:`gp_map_evaluate` (``get_fitted_model`` / ``evaluate``, :156-169):
    per context size, MAP-fit the GP hyperparameters (type II with the Gamma
    hyperpriors, the job of ``fit_gpytorch_model``) and score the exact
    posterior NLL at the next point;
  * :func:`gp_hyper_mcmc_predictive` (``get_mcmc_model`` / ``evaluate_``,
    :171-268): sample the hyperparameters' posterior and score the mixture
    predictive, the logsumexp of the samples' Gaussian log densities
    (``get_mean_logdensity``, :203-217).

How it maps to PyTorch:
  * Every function is batched over leading axes of independent problems,
    which replaces the JAX package's ``vmap``; the hyperparameters are a
    dict of tensors (noise (...,), lengthscale (..., F), outputscale
    (...,)).
  * The marginal likelihood uses the identity-padding mask of the exact-GP
    oracle (masked rows get a unit Cholesky diagonal: no logdet and no
    quadratic term), so every context size has the same shapes.
  * ``gp_map_fit`` is 150 steps of elementwise Adam with optax's update rule,
    lr m_hat / (sqrt(v_hat) + eps), m_hat and v_hat bias-corrected at step
    count t, eps 1e-8 outside the root. :func:`gp_map_evaluate` stacks the
    context sizes and the datasets on one leading axis of t B fits, so each
    Adam step is one batched Cholesky (the JAX function maps over t and
    vmaps over B).
  * The NUTS role is the port's batched adaptive HMC
    (``evals.inference.hmc``) with an explicit ``torch.Generator``, on the
    log hyperparameters.
  * The hyperparameters, Adam and HMC are f32, as in the JAX functions.
    The GP algebra under them runs in f64 (``_GP_DTYPE``): the marginal
    likelihood's kernel matrix and Cholesky, and the posterior predictive
    of the fitted or sampled hyperparameters. Two deviations, for two f32
    faults of the JAX functions:
      - Some MAP fits reach lengthscales of ~0.004 with outputscales of
        50-150. There the kernel's squared distances, |x|^2 + |x'|^2 -
        2 x.x' in lengthscale units (~4e4 each), cancel in f32, the kernel
        matrix loses positive definiteness and the Cholesky fails, which
        Adam carries to a NaN fit. On an H100, 8 of the 1 584 fits of 16
        GP-mix datasets (T 100, every context size) ended in NaN; JAX's f32
        fit, replayed on the CPU on those 8, ended one in NaN and the other
        seven at lengthscales of 0.0030-0.0052.
      - The f32 predictive variance k(x*, x*) - v'v cancels for a draw of
        tiny noise and large outputscale: one of 16 GP-mix datasets (T 100,
        context 50) scored 2 389 nats in f32 against 2.92 in f64 from the
        same HMC draws, on an H100.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from pfn_tpu_torch.evals.inference import hmc
from pfn_tpu_torch.ops.gp_sample import gp_posterior, matern52_kernel

_LOG_2PI = math.log(2.0 * math.pi)
# optax.adam's defaults.
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
# The dtype of the GP algebra: the marginal likelihood and the predictive.
_GP_DTYPE = torch.float64


def _per_problem(hp: dict) -> tuple:
    """(noise, lengthscale, outputscale) of a batch of problems shaped to
    broadcast against their (..., T, T) kernel matrices: (..., 1, 1),
    (..., 1, F), (..., 1, 1)."""
    noise = torch.as_tensor(hp["noise"], dtype=torch.float32)
    ls = torch.as_tensor(hp["lengthscale"], dtype=torch.float32)
    os_ = torch.as_tensor(hp["outputscale"], dtype=torch.float32)
    if ls.ndim == 0:
        ls = ls.reshape(1)
    return noise[..., None, None], ls[..., None, :], os_[..., None, None]


def gp_marginal_log_likelihood(x, y, noise, lengthscale, outputscale, kernel: Callable = matern52_kernel,
                               context_mask=None, jitter: float = 1e-6) -> torch.Tensor:
    """log N(y; 0, K + noise I) of each dataset; x (..., T, F), y (..., T),
    noise and outputscale (...) or scalars, lengthscale (..., F) or (F,) or
    a scalar. Rows where ``context_mask`` (T,) or (..., T) is False are left
    out by the identity padding: their Cholesky diagonal is 1, so they add
    nothing to the log determinant or the quadratic term. Computed in f64
    (``_GP_DTYPE``, see the module's docstring); a Cholesky that fails
    gives NaN, as ``jax.lax.linalg.cholesky`` does. Returns (...) f32."""
    T = x.shape[-2]
    noise_b, ls_b, os_b = (h.to(_GP_DTYPE) for h in _per_problem(
        {"noise": noise, "lengthscale": lengthscale, "outputscale": outputscale}))
    xf = x.to(_GP_DTYPE)
    K = kernel(xf, xf, ls_b, os_b)
    yv = y.to(_GP_DTYPE)
    eye = torch.eye(T, dtype=_GP_DTYPE, device=x.device)
    if context_mask is not None:
        m = context_mask.to(_GP_DTYPE)
        K = K * m[..., :, None] * m[..., None, :] + torch.diag_embed(1.0 - m)
        A = K + torch.diag_embed(m) * (noise_b + jitter)
        yv = yv * m
        n = m.sum(-1)
    else:
        A = K + (noise_b + jitter) * eye
        n = torch.full((), float(T), dtype=_GP_DTYPE, device=x.device)
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))
    alpha = torch.cholesky_solve(yv[..., None], L)[..., 0]
    quad = (yv * alpha).sum(-1)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return (-0.5 * (quad + logdet + n * _LOG_2PI)).float()


def _gamma_logpdf(x, concentration: float, rate: float):
    """log Gamma(x; concentration, rate), its constants in f32 as the JAX
    package computes them (``gammaln`` of an f32 scalar)."""
    c = torch.tensor(concentration, dtype=torch.float32, device=x.device)
    r = torch.tensor(rate, dtype=torch.float32, device=x.device)
    return c * torch.log(r) - torch.lgamma(c) + (c - 1.0) * torch.log(x) - r * x


def log_hyperprior(hp: dict, prior) -> torch.Tensor:
    """The Gamma hyperpriors' log density of ``hp`` (reference
    fast_gp_mix.py:30-47), summed over the lengthscale's features: (...)."""
    return (_gamma_logpdf(hp["noise"], prior.noise_concentration, prior.noise_rate)
            + _gamma_logpdf(hp["lengthscale"], prior.lengthscale_concentration, prior.lengthscale_rate).sum(-1)
            + _gamma_logpdf(hp["outputscale"], prior.outputscale_concentration, prior.outputscale_rate))


def _unconstrained_log_posterior(x, y, prior, kernel, context_mask):
    """theta -> log p(theta | D) of theta = log(hp), with the exp Jacobian."""

    def lp(theta: dict) -> torch.Tensor:
        hp = {k: v.exp() for k, v in theta.items()}
        jac = theta["noise"] + theta["lengthscale"].sum(-1) + theta["outputscale"]
        mll = gp_marginal_log_likelihood(x, y, hp["noise"], hp["lengthscale"], hp["outputscale"], kernel=kernel,
                                         context_mask=context_mask)
        return mll + log_hyperprior(hp, prior) + jac

    return lp


def _init_theta(batch_shape: tuple, num_features: int, device) -> dict:
    """The JAX package's start: noise 0.05, lengthscale 0.5, outputscale 1,
    as logs, for each problem."""
    def full(shape, value):
        return torch.full(shape, math.log(value), dtype=torch.float32, device=device)

    return {"noise": full(batch_shape, 0.05), "lengthscale": full((*batch_shape, num_features), 0.5),
            "outputscale": full(batch_shape, 1.0)}


def gp_map_fit(x, y, prior, kernel: Callable = matern52_kernel, context_mask=None, steps: int = 150,
               lr: float = 0.05) -> dict:
    """MAP hyperparameters of each dataset (the fit_gpytorch_model role,
    reference fast_gp_mix.py:156-166): ``steps`` Adam steps on the log
    hyperparameters maximising the marginal likelihood plus the hyperprior.
    x (..., T, F), y (..., T); returns {noise (...), lengthscale (..., F),
    outputscale (...)}."""
    lp = _unconstrained_log_posterior(x, y, prior, kernel, context_mask)
    theta = _init_theta(tuple(x.shape[:-2]), x.shape[-1], x.device)
    mu = {k: torch.zeros_like(v) for k, v in theta.items()}
    nu = {k: torch.zeros_like(v) for k, v in theta.items()}
    for t in range(1, steps + 1):
        leaves = {k: v.detach().requires_grad_() for k, v in theta.items()}
        grads = dict(zip(leaves, torch.autograd.grad(-lp(leaves).sum(), list(leaves.values()))))
        for k, g in grads.items():
            mu[k] = _B1 * mu[k] + (1 - _B1) * g
            nu[k] = _B2 * nu[k] + (1 - _B2) * g * g
            m_hat = mu[k] / (1 - _B1 ** t)
            v_hat = nu[k] / (1 - _B2 ** t)
            theta[k] = leaves[k].detach() - lr * m_hat / (torch.sqrt(v_hat) + _EPS)
    return {k: v.exp() for k, v in theta.items()}


def _gaussian_logpdf(y, mean, var):
    return -0.5 * (_LOG_2PI + torch.log(var) + (y - mean) ** 2 / var)


def gp_map_evaluate(x, y, prior, kernel: Callable = matern52_kernel, positions=None, steps: int = 150,
                    lr: float = 0.05):
    """The MAP-fit baseline's NLL swept over context sizes.

    x (B, T, F), y (B, T). For each t in ``positions`` (default 1 .. T-1):
    MAP-fit the hyperparameters on (x[:t], y[:t]), then the NLL of the exact
    posterior at x[t], scored in f64. The len(positions) B fits run as
    one batch. Returns (all_losses (num_t, B), mean_losses (num_t,)), f32.
    Parity: evaluate with get_fitted_model (fast_gp_mix.py:156-169).
    """
    B, T, F = x.shape
    ts = torch.as_tensor(list(range(1, T)) if positions is None else [int(t) for t in positions],
                         device=x.device)
    nt = ts.shape[0]
    mask = torch.arange(T, device=x.device)[None, :] < ts[:, None]  # (nt, T)
    xs = x[None].expand(nt, B, T, F).reshape(nt * B, T, F)
    ys = y[None].expand(nt, B, T).reshape(nt * B, T)
    masks = mask[:, None, :].expand(nt, B, T).reshape(nt * B, T)
    with torch.enable_grad():
        hp = gp_map_fit(xs, ys, prior, kernel=kernel, context_mask=masks, steps=steps, lr=lr)
    noise, ls, os_ = _per_problem(hp)
    dtype = _GP_DTYPE
    with torch.no_grad():
        mean, var = gp_posterior(xs, ys, xs, lengthscale=ls.to(dtype), outputscale=os_.to(dtype),
                                 noise=noise.to(dtype), kernel=kernel, context_mask=masks, dtype=dtype)
        at = ts.repeat_interleave(B)[:, None]  # the row scored by each fit
        m, v, yt = (torch.gather(a, 1, at)[:, 0] for a in (mean, var, ys.to(dtype)))
        all_losses = -_gaussian_logpdf(yt, m, v).float().reshape(nt, B)
    return all_losses, all_losses.mean(dim=1)


def gp_hyper_mcmc_predictive(x_train, y_train, x_query, y_query, prior, generator: torch.Generator,
                             kernel: Callable = matern52_kernel, num_samples: int = 64, num_warmup: int = 128,
                             context_mask=None):
    """The mixture posterior-predictive NLL at the query points of each
    dataset.

    x_train (..., N, F), y_train (..., N), x_query (..., M, F), y_query
    (..., M); the leading axes are independent datasets, sampled together.
    HMC draws theta ~ p(hp | D) (``num_warmup`` adaptation steps, then
    ``num_samples``); the predictive is the mixture logsumexp_s log N(y*;
    mean_s, var_s) - log S (get_mean_logdensity, fast_gp_mix.py:203-217),
    each sample's posterior in f64. Returns (nll (..., M) f32, the
    mean acceptance (...)).
    """
    batch_shape = tuple(x_train.shape[:-2])
    lp = _unconstrained_log_posterior(x_train, y_train, prior, kernel, context_mask)
    with torch.enable_grad():
        samples, accept = hmc(lp, _init_theta(batch_shape, x_train.shape[-1], x_train.device), generator,
                              num_samples=num_samples, num_warmup=num_warmup, batch_shape=batch_shape)
    noise, ls, os_ = _per_problem({k: v.exp() for k, v in samples.items()})  # leading axis: the samples
    S = noise.shape[0]

    def each(t):  # the data beside every sample
        return t[None].expand(S, *t.shape)

    mask = None if context_mask is None else each(context_mask.expand(*batch_shape, x_train.shape[-2]))
    dtype = _GP_DTYPE
    with torch.no_grad():
        mean, var = gp_posterior(each(x_train), each(y_train), each(x_query), lengthscale=ls.to(dtype),
                                 outputscale=os_.to(dtype), noise=noise.to(dtype), kernel=kernel, context_mask=mask,
                                 dtype=dtype)
        logdens = _gaussian_logpdf(each(y_query).to(dtype), mean, var)  # (S, ..., M)
        nll = -(torch.logsumexp(logdens, dim=0) - math.log(S))
    return nll.float(), accept
