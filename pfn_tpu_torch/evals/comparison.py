"""The PFN-vs-SVI-vs-MCMC comparison harness (Fig-2-style).

Port of ``pfn_tpu/evals/comparison.py`` (reference
mcmc_svi_transformer_on_bayesian.py): the BNN prior and likelihood
(BayesianModel :28-67, a linear-linear 2-layer net with N(0, 1) weights and
no nonlinearity between the layers, x ~ N(0, 1), y ~ Categorical(softmax)),
the fixed-seed eval data (:195-207), eval_svi (:211-246), eval_mcmc
(:249-267), eval_transformer (:270-291), the steps and samples sweeps with
.npy caching (:294-351) and the confidence-interval helpers (:142-192).

How it maps to PyTorch:
  * The SVI and HMC fits run all eval datasets at once, batched along a
    leading axis (``evals.inference``'s ``batch_shape``), on the data's
    device, where the JAX package vmaps them.
  * Draws come from ``torch.Generator`` s: ``generate_toy_data`` takes one,
    and the fits seed theirs with ``seed``. The numbers therefore differ
    from the JAX functions' by the random streams, not by the method.
  * The PFN holds its weights, so ``eval_transformer`` takes ``(X, y,
    model, training_samples_n)``.
  * The sweeps write the JAX package's file names, content hash included,
    so a cache written by one package's sweep reads in the other.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from pfn_tpu_torch.evals.harness import pfn_predict
from pfn_tpu_torch.evals.inference import hmc, svi
from pfn_tpu_torch.priors.module import ModulePrior

# The dims of each weight that are not batch dims.
_EVENT_NDIM = {"w1": 2, "b1": 1, "w2": 2, "b2": 1}


def _as_tensor(a, device=None) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# The BNN model (prior + likelihood)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BayesianNNModel:
    """2-layer linear BNN with standard-normal priors (reference :28-67).
    Weights may carry leading batch dims: w1 (..., F, E), b1 (..., E), w2
    (..., E, C), b2 (..., C), C = ``num_classes`` (the reference's 2)."""

    num_features: int
    embed: int
    nlayers: int = 2  # the reference spec carries this but builds 2 layers
    # Out of repr: the sweep caches' tag hashes repr, as the JAX package's does.
    num_classes: int = dataclasses.field(default=2, repr=False)

    def shapes(self) -> dict:
        C = self.num_classes
        return {"w1": (self.num_features, self.embed), "b1": (self.embed,), "w2": (self.embed, C), "b2": (C,)}

    def sample_params(self, generator: torch.Generator, batch_shape: tuple = ()) -> dict:
        return {k: torch.randn((*batch_shape, *s), generator=generator, device=generator.device)
                for k, s in self.shapes().items()}

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """x (..., T, F) -> (..., T, C); the weights' batch dims broadcast
        against x's. Sequential(fc1, fc2), deliberately no activation
        (reference :46)."""
        h = x @ params["w1"] + params["b1"].unsqueeze(-2)
        return h @ params["w2"] + params["b2"].unsqueeze(-2)

    def _draw_data(self, generator: torch.Generator, params: dict, shape: tuple):
        """x ~ N(0, 1) of ``shape`` (..., T, F) and y ~ Cat(softmax(f(x))),
        one uniform u a row: y is the number of classes c >= 1 whose tail
        p_c + ... + p_{C-1} exceeds u, so with 2 classes u < p_1, as the
        reference draws it."""
        x = torch.randn(shape, generator=generator, device=generator.device)
        p = torch.softmax(self.logits(params, x), dim=-1)
        tails = p.flip(-1).cumsum(-1).flip(-1)[..., 1:]
        u = torch.rand(p.shape[:-1], generator=generator, device=generator.device)
        y = (u.unsqueeze(-1) < tails).sum(-1).to(torch.float32)
        return x, y

    def generate(self, generator: torch.Generator, seq_len: int, n: int):
        """n datasets from the prior, each with its own weights: X (n, T, F),
        y (n, T)."""
        params = self.sample_params(generator, (n,))
        return self._draw_data(generator, params, (n, seq_len, self.num_features))

    def log_joint(self, params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """log p(params) + log p(y | x, params), one value per batch entry of
        the weights."""
        # -0.5 sum(p^2) - n log(2 pi) / 2, in few kernels: the fits call this
        # once per step or leapfrog step, and each launch costs host time.
        sq = sum((p * p).flatten(p.ndim - _EVENT_NDIM[k]).sum(-1) for k, p in params.items())
        n = sum(math.prod(s) for s in self.shapes().values())
        log_prior = -0.5 * sq - 0.5 * n * math.log(2 * math.pi)
        logp = torch.log_softmax(self.logits(params, x), dim=-1)
        ll = logp.gather(-1, y.long().unsqueeze(-1)).squeeze(-1).sum(-1)
        return log_prior + ll

    def as_prior(self, batch_size_per_model: int | None = None) -> ModulePrior:
        """A Prior for PFN training (the reference trains through
        priors.pyro.DataLoader on this model, :86-116): one weight draw per
        group, the data per dataset (``ModulePrior``'s batched contract)."""

        def sample_fn(generator, num_models, group_size, seq_len):
            params = {k: v.unsqueeze(1) for k, v in self.sample_params(generator, (num_models,)).items()}
            return self._draw_data(generator, params, (num_models, group_size, seq_len, self.num_features))

        return ModulePrior(sample_fn=sample_fn, num_features=self.num_features,
                           batch_size_per_model=batch_size_per_model)


def default_model_spec(size: str = "small") -> BayesianNNModel:
    """Parity: get_default_model_spec (:354-370); bptt=300."""
    if size == "big":
        return BayesianNNModel(num_features=8, embed=64)
    if size == "small":
        return BayesianNNModel(num_features=3, embed=5)
    f, e, n = (int(v) for v in size.split("_"))
    return BayesianNNModel(num_features=f, embed=e, nlayers=n)


def generate_toy_data(model: BayesianNNModel, seq_len: int, generator: torch.Generator, n_samples: int = 100):
    """The eval set (reference :195-207) from ``generator`` (seed it for the
    fixed set), on its device. Returns X (B, T, F), y (B, T)."""
    return model.generate(generator, seq_len, n_samples)


# ---------------------------------------------------------------------------
# Metrics (evaluate_preds parity, :130-139)
# ---------------------------------------------------------------------------

def _evaluate_pred_samples(obs_samples, y_test):
    """obs_samples: (S, ..., T_test) sampled hard labels; y_test: (...,
    T_test). The sample mean is the probability; returns (acc, nll) over
    the T_test axis, shape (...)."""
    means = _mean(obs_samples, 0)
    acc = _mean(((means > 0.5) == (y_test > 0.5)).to(torch.float32), -1)
    p = means.clamp(1e-7, 1 - 1e-7)
    nll = _mean(-(y_test * torch.log(p) + (1 - y_test) * torch.log(1 - p)), -1)
    return acc, nll


def _mean(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The mean over ``dim`` as the sum times the reciprocal of the count,
    as XLA computes ``jnp.mean`` (``Tensor.mean`` rounds the quotient
    itself, one ulp away at times)."""
    return t.sum(dim) * (1.0 / t.shape[dim])


# ---------------------------------------------------------------------------
# eval_svi / eval_mcmc / eval_transformer
# ---------------------------------------------------------------------------

def _split(X, y, n: int):
    """(x_train, y_train as int64 labels, x_test, y_test)."""
    X, y = _as_tensor(X), _as_tensor(y, X.device)
    return X[:, :n], y[:, :n].long(), X[:, n:], y[:, n:]


def _score_draws(model: BayesianNNModel, thetas: dict, xte, yte, generator):
    """Hard labels drawn from each posterior draw's predictive on the
    held-out rows, scored by :func:`_evaluate_pred_samples`."""
    p1 = torch.softmax(model.logits(thetas, xte), dim=-1)[..., 1]  # (S, B, T_test)
    obs = (torch.rand(p1.shape, generator=generator, device=p1.device) < p1).to(torch.float32)
    acc, nll = _evaluate_pred_samples(obs, yte)
    return nll.cpu().numpy(), acc.cpu().numpy()


def eval_svi(X, y, model: BayesianNNModel, training_samples_n: int, num_train_steps: int, num_pred_samples: int,
             lr: float = 1e-3, seed: int = 0):
    """SVI posterior of every dataset (all at once), scored on the held-out
    suffix. Parity: reference eval_svi (:211-246), AutoDiagonalNormal +
    Trace_ELBO from zero weights. Returns (nll (B,), acc (B,))."""
    xtr, ytr, xte, yte = _split(X, y, training_samples_n)
    g = torch.Generator(device=xtr.device).manual_seed(seed)
    B = xtr.shape[0]
    init = {k: torch.zeros((B, *s), device=xtr.device) for k, s in model.shapes().items()}
    guide = svi(lambda th: model.log_joint(th, xtr, ytr), init, g, num_steps=num_train_steps, lr=lr,
                batch_shape=(B,))
    with torch.no_grad():
        return _score_draws(model, guide.sample(g, num_pred_samples), xte, yte, g)


def _mcmc_scores(X, y, model: BayesianNNModel, training_samples_n: int, warmup_steps: int, num_pred_samples: int,
                 seed: int = 0):
    """:func:`eval_mcmc`, and HMC's acceptance rate of each dataset."""
    xtr, ytr, xte, yte = _split(X, y, training_samples_n)
    g = torch.Generator(device=xtr.device).manual_seed(seed)
    B = xtr.shape[0]
    init = {k: torch.zeros((B, *s), device=xtr.device) for k, s in model.shapes().items()}
    samples, accept = hmc(lambda th: model.log_joint(th, xtr, ytr), init, g, num_samples=num_pred_samples,
                          num_warmup=warmup_steps, num_leapfrog=15, batch_shape=(B,))
    with torch.no_grad():
        nll, acc = _score_draws(model, samples, xte, yte, g)
    return nll, acc, accept.cpu().numpy()


def eval_mcmc(X, y, model: BayesianNNModel, training_samples_n: int, warmup_steps: int, num_pred_samples: int,
              seed: int = 0):
    """HMC posterior of every dataset (all at once), scored on the held-out
    suffix. Parity: reference eval_mcmc (:249-267), which runs Pyro's NUTS;
    here adaptive HMC (``evals.inference.hmc``). Returns (nll (B,), acc
    (B,))."""
    nll, acc, _ = _mcmc_scores(X, y, model, training_samples_n, warmup_steps, num_pred_samples, seed)
    return nll, acc


@torch.no_grad()
def transformer_probs(X, y, model, training_samples_n: int):
    """The PFN's P(y = 1) at the held-out rows of every dataset in one
    forward, on the model's device: X z-scored by the statistics of its
    first ``training_samples_n`` rows, y zeroed after them. Returns (probs
    (B, T - n), seconds of the forward, the card synchronised before and
    after)."""
    device = next(model.parameters()).device
    X, y = _as_tensor(X, device), _as_tensor(y, device)
    n = training_samples_n
    mean = X[:, :n].mean(1, keepdim=True)
    std = X[:, :n].std(1, keepdim=True, correction=0) + 1e-6
    Xn = (X - mean) / std
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits = pfn_predict(model, Xn, y, n)[..., 0]
    sync()
    return torch.sigmoid(logits[:, n:]), time.perf_counter() - t0


def eval_transformer(X, y, model, training_samples_n: int):
    """Amortized inference: one forward over all eval points of all datasets
    (reference :270-291). Returns (acc (B,), nll (B,), seconds).

    A quirk kept for parity: ModulePrior z-scores x over the whole sequence
    in training, while this eval normalises by the first
    ``training_samples_n`` rows (reference :277-279), as the reference
    does."""
    probs, elapsed = transformer_probs(X, y, model, training_samples_n)
    yte = _as_tensor(y, probs.device)[:, training_samples_n:]
    acc = _mean(((probs > 0.5) == (yte > 0.5)).to(torch.float32), -1)
    p = probs.clamp(1e-7, 1 - 1e-7)
    nll = _mean(-(yte * torch.log(p) + (1 - yte) * torch.log(1 - p)), -1)
    return acc.cpu().numpy(), nll.cpu().numpy(), elapsed


# ---------------------------------------------------------------------------
# Sweep drivers with .npy caching (:294-351)
# ---------------------------------------------------------------------------

def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _sweep_cache_tag(X, y, model, extra) -> str:
    """Content hash over the eval data, the model spec and the sweep's
    parameters, the JAX package's (the reference keys on method and steps
    alone, :296-300, a stale-hit hazard); a BNN of other than 2 classes adds
    its count."""
    import hashlib

    h = hashlib.sha1()
    h.update(np.ascontiguousarray(_numpy(X).astype(np.float32)).tobytes())
    h.update(np.ascontiguousarray(_numpy(y).astype(np.float32)).tobytes())
    h.update(repr(model).encode())
    if model.num_classes != 2:
        h.update(f"num_classes={model.num_classes}".encode())
    h.update(repr(extra).encode())
    return h.hexdigest()[:10]


def _fit(method: str, X, y, model, n: int, steps: int):
    if method == "svi":
        return eval_svi(X, y, model, n, steps, steps)
    if method == "mcmc":
        return eval_mcmc(X, y, model, n, steps, steps)
    raise ValueError(method)


def training_steps_sweep(method: str, X, y, model: BayesianNNModel, path_interfix: str,
                         steps_grid=(2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096),
                         training_samples_n: int = 100, overwrite: bool = False):
    """Quality against compute over inference steps (reference :294-319)."""
    os.makedirs(path_interfix, exist_ok=True)
    tag = _sweep_cache_tag(X, y, model, training_samples_n)
    results = {}
    for s in steps_grid:
        path = f"{path_interfix}/results_{method}_training_steps_{s}_{tag}.npy"
        if os.path.isfile(path) and not overwrite:
            results[s] = tuple(np.load(path, allow_pickle=True))
            continue
        start = time.time()
        nll, acc = _fit(method, X, y, model, training_samples_n, s)
        elapsed = time.time() - start
        np.save(path, np.array((nll, acc, elapsed), dtype=object))
        results[s] = (nll, acc, elapsed)
    return results


def training_samples_sweep(method: str, X, y, model: BayesianNNModel, evaluation_points, path_interfix: str,
                           steps: int | None = None, overwrite: bool = False):
    """Quality against context size (reference :322-351)."""
    os.makedirs(path_interfix, exist_ok=True)
    steps_ = steps or (1024 if method == "svi" else 512)
    tag = _sweep_cache_tag(X, y, model, steps_)
    results = {}
    for n in evaluation_points:
        path = f"{path_interfix}/results_{method}_{steps_}_training_samples_{n}_{tag}.npy"
        if os.path.isfile(path) and not overwrite:
            results[n] = tuple(np.load(path, allow_pickle=True))
            continue
        start = time.time()
        nll, acc = _fit(method, X, y, model, n, steps_)
        elapsed = time.time() - start
        np.save(path, np.array((n, nll, acc, elapsed), dtype=object))
        results[n] = (n, nll, acc, elapsed)
    return results


def default_evaluation_points():
    """Parity: reference :372-373."""
    return list(range(2, 100, 5))


# ---------------------------------------------------------------------------
# Stats / plotting helpers (:142-192)
# ---------------------------------------------------------------------------

def compute_mean_and_conf_interval(values, confidence: float = 0.95):
    import scipy.stats as st

    values = np.asarray(values)
    n = len(values)
    m, se = np.mean(values), st.sem(values)
    h = se * st.t.ppf((1 + confidence) / 2.0, n - 1)
    return m, h


def plot_with_confidence_intervals(ax, x, mean, confidence, **kwargs):
    ax.plot(x, mean, **kwargs)
    kwargs.pop("label", None)
    kwargs.pop("marker", None)
    ax.fill_between(x, np.asarray(mean) - confidence, np.asarray(mean) + confidence, alpha=0.1, **kwargs)
