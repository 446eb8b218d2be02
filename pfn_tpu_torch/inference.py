"""User-facing amortized inference: ``fit`` stores the context, ``predict``
is one batched forward pass; no per-dataset training happens.

Port of ``PFNRegressor`` and ``PFNClassifier`` from ``pfn_tpu/inference.py``:

    reg = PFNRegressor(model, criterion)   # a PFNTransformer and its Criterion
    reg.fit(X_ctx, y_ctx)                  # stores the context
    mean, std = reg.predict(X_query, return_std=True)
    lo, hi = reg.predict_quantiles(X_query, (0.05, 0.95))

    reg = PFNRegressor.from_train_result(train(prior, criterion, cfg))
    reg = PFNRegressor.from_checkpoint(cfg.checkpoint_dir, prior, criterion, cfg)

    clf = PFNClassifier.from_train_result(result).fit(X_ctx, labels)
    p = clf.predict_proba(X_query)         # (n_query, max(n_classes, 2))

The forward runs on the model's device; inputs and outputs are numpy.
``PFNRegressor.sample`` takes a ``torch.Generator`` where the JAX one takes a
key: the two random streams differ anyway.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from pfn_tpu_torch.evals.harness import pfn_predict
from pfn_tpu_torch.priors.transforms import normalize_by_used_features
from pfn_tpu_torch.train.checkpoints import latest_state_checkpoint, restore_checkpoint
from pfn_tpu_torch.train.loop import build_model
from pfn_tpu_torch.train.losses import Criterion


@dataclasses.dataclass
class _PFNEstimator:
    """Context handling shared by the front ends.

    ``normalize_x=True`` z-scores every column by the context's mean and std
    (context and queries). Features beyond the model's ``num_features`` are
    rejected; fewer are zero-padded and rescaled by the used-feature fraction.
    """

    model: Any
    criterion: Criterion
    normalize_x: bool = False
    _ctx_x: np.ndarray | None = None
    _ctx_y: np.ndarray | None = None

    @classmethod
    def from_train_result(cls, result, **kw):
        """Wrap a ``pfn_tpu_torch.train.train(...)`` TrainResult."""
        return cls(result.model, result.criterion, **kw)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, prior, criterion: Criterion, cfg, **kw):
        """Rebuild the model from its TrainConfig and load the weights of the
        newest full-state checkpoint written by train(checkpoint_dir=...)."""
        latest = latest_state_checkpoint(checkpoint_dir)
        if latest is None:
            raise FileNotFoundError(f"no checkpoints under {checkpoint_dir}")
        model = build_model(prior, criterion, cfg)
        model.load_state_dict(restore_checkpoint(latest[0], map_location="cpu")["model"], strict=True)
        return cls(model.eval(), criterion, **kw)

    @property
    def num_features(self) -> int:
        return self.model.config.num_features

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def fit(self, X, y):
        """Store the context set (n_ctx, f), (n_ctx,)."""
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        if X.ndim != 2 or y.shape != (X.shape[0],):
            raise ValueError(f"fit needs X (n, f) and y (n,), got {X.shape} and {y.shape}")
        if X.shape[1] > self.num_features:
            raise ValueError(f"{X.shape[1]} features > model num_features={self.num_features}")
        self._ctx_x, self._ctx_y = X, y
        return self

    def _pack(self, Xq: np.ndarray):
        """Context + queries -> model inputs (1, T, F), (1, T), sep."""
        if self._ctx_x is None:
            raise RuntimeError("call fit(X, y) first")
        n_ctx = self._ctx_x.shape[0]
        if Xq.shape[1] != self._ctx_x.shape[1]:
            raise ValueError(f"query matrix has {Xq.shape[1]} features but fit() saw {self._ctx_x.shape[1]}")
        x = np.concatenate([self._ctx_x, Xq], axis=0)
        if self.normalize_x:
            mu = x[:n_ctx].mean(axis=0, keepdims=True)
            sd = x[:n_ctx].std(axis=0, keepdims=True) + 1e-6
            x = (x - mu) / sd
        f = x.shape[1]
        if f < self.num_features:
            x = normalize_by_used_features(np.pad(x, ((0, 0), (0, self.num_features - f))), f, self.num_features)
        y = np.concatenate([self._ctx_y, np.zeros(len(Xq), np.float32)], axis=0)
        return x[None].astype(np.float32), y[None], n_ctx

    @torch.no_grad()
    def _logits(self, Xq) -> torch.Tensor:
        """One forward; logits for the query rows: (n_query, n_out)."""
        Xq = np.asarray(Xq, np.float32)
        if Xq.ndim != 2:
            raise ValueError("queries must be (n_query, n_features)")
        x, y, sep = self._pack(Xq)
        out = pfn_predict(self.model, torch.from_numpy(x).to(self.device), torch.from_numpy(y).to(self.device), sep)
        return out[0, sep:]


class PFNRegressor(_PFNEstimator):
    """Posterior-predictive regression from a bar-head or Gaussian-head PFN."""

    def _bar(self):
        if self.criterion.kind not in ("bar", "full_bar"):
            raise ValueError(
                f"criterion {self.criterion.kind!r} is not a bar-distribution head; this needs a bar/full_bar model"
            )
        return self.criterion.bar.to(self.device)

    def predict(self, Xq, return_std: bool = False):
        if self.criterion.kind not in ("gaussian", "bar", "full_bar", "mse"):
            raise ValueError(f"criterion {self.criterion.kind!r} is not a regression head")
        logits = self._logits(Xq)
        if self.criterion.kind == "mse":
            if return_std:
                raise ValueError("an MSE head carries no uncertainty")
            return logits[..., 0].cpu().numpy()
        if self.criterion.kind == "gaussian":
            mean = logits[..., 0]
            var = logits[..., 1].abs().clamp_min(1e-6)
        else:
            bar = self._bar()
            mean = bar.mean(logits)
            if return_std:
                # E[y^2] per bucket: mid^2 + width^2 / 12 (uniform within the
                # bucket); the tails count as their base bucket's span.
                p = torch.softmax(logits, dim=-1)
                ey2 = (p * (bar.bucket_means**2 + bar.bucket_widths**2 / 12.0)).sum(dim=-1)
                var = (ey2 - mean**2).clamp_min(0.0)
        if return_std:
            return mean.cpu().numpy(), torch.sqrt(var).cpu().numpy()
        return mean.cpu().numpy()

    def predict_quantiles(self, Xq, qs: Sequence[float]):
        """(len(qs), n_query) posterior quantiles (bar heads only)."""
        bar = self._bar()
        logits = self._logits(Xq)
        return torch.stack([bar.icdf(logits, q) for q in qs]).cpu().numpy()

    def sample(self, Xq, num_samples: int = 1, generator: torch.Generator | None = None):
        """(num_samples, n_query) draws from the posterior predictive."""
        bar = self._bar()
        logits = self._logits(Xq)
        return torch.stack([bar.sample(logits, generator) for _ in range(num_samples)]).cpu().numpy()

    def nll(self, Xq, yq) -> float:
        """Mean posterior-predictive NLL of the true targets at the queries."""
        logits = self._logits(Xq)
        crit = self.criterion.to(self.device)
        yq = torch.as_tensor(np.asarray(yq, np.float32), device=self.device)
        return float(crit.per_position(logits[None], yq[None]).mean())


class PFNClassifier(_PFNEstimator):
    """Zero-shot classification from a BCE- or CE-head PFN (the tabular
    protocol: class codes as float y inputs, a sigmoid or softmax read-out).

    ``fit`` maps the labels to codes 0 .. n-1 in the order of ``classes_``
    (their sorted unique values); a BCE head takes at most 2 classes, a CE
    head at most its ``num_classes``.
    """

    classes_: np.ndarray | None = None

    def fit(self, X, y):
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        n = len(self.classes_)
        if self.criterion.kind == "bce":
            if n > 2:
                raise ValueError(f"a BCE head is binary, got {n} classes")
        elif self.criterion.kind == "ce":
            if n > self.criterion.num_classes:
                raise ValueError(f"{n} classes > the CE head's {self.criterion.num_classes}")
        else:
            raise ValueError(f"a classifier needs a bce or ce criterion, got {self.criterion.kind!r}")
        return super().fit(X, np.searchsorted(self.classes_, y).astype(np.float32))

    def predict_proba(self, Xq) -> np.ndarray:
        """(n_query, max(n_classes, 2)) class probabilities: [1 - p, p] from
        the BCE logit, or the CE head's softmax over the first
        max(n_classes, 2) logits, so that the classes absent from the context
        get no mass."""
        logits = self._logits(Xq)
        k = max(len(self.classes_), 2)
        if self.criterion.kind == "bce":
            p1 = torch.sigmoid(logits[..., 0])
            return torch.stack([1.0 - p1, p1], dim=-1)[:, :k].cpu().numpy()
        return torch.softmax(logits[:, :k], dim=-1).cpu().numpy()

    def predict(self, Xq) -> np.ndarray:
        codes = self.predict_proba(Xq).argmax(axis=-1)
        return self.classes_[np.minimum(codes, len(self.classes_) - 1)]
