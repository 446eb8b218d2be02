"""Bayesian optimisation on top of a trained PFN.

Port of ``pfn_tpu/bayesopt.py``: acquisition functions over the bar head's
posterior (the reference's working EI lives on the bar head,
bar_distribution.py:69-80) and a candidate-selection loop. One forward pass
scores every candidate: the observed points are the context, the candidate
pool the eval positions.

How it maps to PyTorch:
  * The model is a ``PFNTransformer`` holding its weights (the JAX
    optimizer takes ``model, params``).
  * The context is padded to a static length N and the number of
    observations is the runtime ``sep``, never a slice, so every iteration of
    :func:`optimize` has the same shapes; the best-so-far is masked by it as
    the JAX function does.
  * Draws come from an explicit ``torch.Generator``: :func:`thompson_sample`
    takes one, and :func:`optimize` draws its initial points from one in a
    step of its own (:func:`initial_indices`), so that a caller can hand it
    other indices.
  * One host sync per BO iteration is inherent: the argmax over the
    candidates not yet evaluated is taken on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from pfn_tpu_torch.distributions.bar import BarDistribution


# ---- acquisition functions over bar-head logits ---------------------------

def expected_improvement(bar: BarDistribution, logits, best_f, maximize: bool = True):
    """EI under the piecewise-constant posterior (bar_distribution.py:69-80)."""
    return bar.ei(logits, best_f, maximize=maximize)


def probability_of_improvement(bar: BarDistribution, logits, best_f, maximize: bool = True):
    """P(y > best_f) (or < for minimize) under the bar posterior."""
    y = torch.as_tensor(best_f, dtype=torch.float32, device=logits.device).expand(logits.shape[:-1])
    cdf = bar.cdf(logits, y)
    return 1.0 - cdf if maximize else cdf


def upper_confidence_bound(bar: BarDistribution, logits, beta: float = 1.0, maximize: bool = True):
    """mean + beta std (maximize) or -(mean - beta std), the std from the
    buckets' second moment."""
    probs = torch.softmax(logits, dim=-1)
    mean = bar.mean(logits)
    second = (probs * bar.bucket_means ** 2).sum(dim=-1)
    std = torch.sqrt(torch.clamp_min(second - mean ** 2, 0.0))
    return mean + beta * std if maximize else -(mean - beta * std)


def thompson_sample(bar: BarDistribution, logits, generator: torch.Generator | None = None):
    """One posterior draw per candidate: Thompson sampling."""
    return bar.sample(logits, generator)


ACQUISITIONS: dict[str, Callable] = {
    "ei": expected_improvement,
    "pi": probability_of_improvement,
    "ucb": upper_confidence_bound,
}


# ---- the PFN-BO loop -------------------------------------------------------

@dataclasses.dataclass
class PFNOptimizer:
    """Sequential model-based optimisation driven by a trained PFN.

    The PFN is the surrogate: conditioning on the observations is one
    forward pass, with no GP refit. Pad the observations to a fixed length
    and pass ``num_obs`` so every iteration has the same shapes; the padded
    slots are masked by ``single_eval_pos``.
    """

    model: torch.nn.Module  # PFNTransformer
    bar: BarDistribution
    acquisition: str = "ei"
    maximize: bool = True
    beta: float = 1.0  # for ucb

    @torch.no_grad()
    def scores(self, x_obs, y_obs, candidates, num_obs=None):
        """The acquisition value of each candidate.

        x_obs (N, F): observed inputs (N static; pad and pass ``num_obs``, an
        int or a one-element tensor, to mask), y_obs (N,), candidates (M,
        F), all on the model's device. Returns (M,).
        """
        N = x_obs.shape[0]
        n = N if num_obs is None else num_obs
        x = torch.cat([x_obs, candidates], dim=0)[None]  # (1, N + M, F)
        y = torch.cat([y_obs, torch.zeros(candidates.shape[0], dtype=y_obs.dtype, device=y_obs.device)])[None]
        logits = self.model(x, y, n)
        cand_logits = logits[0, N:, :]
        if self.acquisition == "ucb":
            return upper_confidence_bound(self.bar, cand_logits, beta=self.beta, maximize=self.maximize)
        # The masked best-so-far: n may be a device scalar, so never slice by it.
        obs_mask = torch.arange(N, device=y_obs.device) < n
        fill = float("-inf") if self.maximize else float("inf")
        masked = torch.where(obs_mask, y_obs, torch.full_like(y_obs, fill))
        best_f = masked.max() if self.maximize else masked.min()
        return ACQUISITIONS[self.acquisition](self.bar, cand_logits, best_f, maximize=self.maximize)

    def propose(self, x_obs, y_obs, candidates, num_obs=None):
        """Index of the best candidate under the acquisition (a 0-dim
        tensor on the device)."""
        return torch.argmax(self.scores(x_obs, y_obs, candidates, num_obs))


def initial_indices(num_candidates: int, num_init: int, generator: torch.Generator) -> list:
    """The first ``num_init`` entries of a random permutation of the
    candidate pool, drawn from ``generator``: optimize's initial points."""
    perm = torch.argsort(torch.rand(num_candidates, generator=generator, device=generator.device))
    return [int(i) for i in perm[:num_init].tolist()]


def optimize(objective: Callable, optimizer: PFNOptimizer, candidates, num_iterations: int,
             generator: torch.Generator | None = None, num_init: int = 2, init_idx=None):
    """A BO loop over a finite candidate set.

    ``objective(x)`` maps one candidate (F,) to a float. The initial points
    are ``init_idx`` when given, else :func:`initial_indices` from
    ``generator``. Each iteration scores every candidate with the
    observations so far (padded to num_init + num_iterations) and evaluates
    the best not yet evaluated. Returns (x_obs (N, F), y_obs (N,)) of
    everything evaluated, on the candidates' device.
    """
    M, F = candidates.shape
    N = num_init + num_iterations
    if N > M:
        raise ValueError(f"budget num_init+num_iterations={N} exceeds the candidate pool (M={M}): every point "
                         "would be evaluated before the loop ends")
    if init_idx is None:
        init_idx = initial_indices(M, num_init, generator)
    device = candidates.device
    x_obs = torch.zeros((N, F), dtype=candidates.dtype, device=device)
    y_obs = torch.zeros((N,), dtype=torch.float32, device=device)
    evaluated = np.zeros(M, bool)  # a finite pool: never spend the budget twice
    for i, idx in enumerate(init_idx):
        idx = int(idx)
        evaluated[idx] = True
        x_obs[i] = candidates[idx]
        y_obs[i] = float(objective(candidates[idx]))
    for t in range(num_iterations):
        n = num_init + t
        s = optimizer.scores(x_obs, y_obs, candidates, num_obs=n).float().cpu().numpy()
        s[evaluated] = -np.inf
        pick = int(s.argmax())
        evaluated[pick] = True
        x_obs[n] = candidates[pick]
        y_obs[n] = float(objective(candidates[pick]))
    return x_obs, y_obs
