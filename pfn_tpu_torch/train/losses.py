"""Criterions: per-position losses mapping (logits, targets) -> (B, T).

Port of ``pfn_tpu/train/losses.py``. A Criterion bundles the loss with the
head-width rule, so model construction and scoring share one object.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pfn_tpu_torch.distributions.bar import BarDistribution, FullSupportBarDistribution

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class Criterion:
    kind: str
    bar: BarDistribution | None = None
    num_classes: int = 1

    def n_out(self, num_outputs: int) -> int:
        """Head width rule (reference train.py:34-39)."""
        if self.kind == "gaussian":
            return num_outputs * 2
        if self.kind in ("bar", "full_bar"):
            if num_outputs != 1:
                raise ValueError("a bar head models one output")
            return self.bar.num_bars
        if self.kind == "ce":
            return self.num_classes
        return num_outputs

    def per_position(self, output: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """output: (B, T, n_out); targets: (B, T) -> losses (B, T)."""
        if self.kind in ("bar", "full_bar"):
            return self.bar.nll(output, targets)
        if self.kind == "gaussian":
            # nn.GaussianNLLLoss(full=True) with var = |second head|, eps-clamped.
            mean = output[..., 0]
            var = output[..., 1].abs().clamp_min(1e-6)
            return 0.5 * (_LOG_2PI + torch.log(var) + (targets - mean) ** 2 / var)
        if self.kind == "mse":
            return (output[..., 0] - targets) ** 2
        if self.kind == "bce":
            logits = output[..., 0]
            return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
        if self.kind == "ce":
            # Float labels are truncated to ints; -100 is ignore_index.
            labels = targets.to(torch.int64)
            logp = torch.log_softmax(output, dim=-1)
            picked = torch.gather(logp, -1, labels.clamp(0, self.num_classes - 1)[..., None])[..., 0]
            return torch.where(labels == -100, torch.zeros_like(picked), -picked)
        raise ValueError(f"unknown criterion kind {self.kind!r}")

    def valid_weight(self, targets: torch.Tensor) -> torch.Tensor:
        """Per-position weight for a masked mean: CE ignores -100 targets,
        every other criterion scores every position."""
        if self.kind == "ce":
            return (targets.to(torch.int64) != -100).to(torch.float32)
        return torch.ones(targets.shape, dtype=torch.float32, device=targets.device)

    def mean(self, logits):
        if self.kind not in ("bar", "full_bar"):
            raise ValueError(f"criterion {self.kind!r} has no bar head")
        return self.bar.mean(logits)

    def to(self, device) -> "Criterion":
        bar = self.bar.to(device) if self.bar is not None else None
        return dataclasses.replace(self, bar=bar)


def bar_criterion(borders) -> Criterion:
    return Criterion(kind="bar", bar=BarDistribution(borders))


def full_support_bar_criterion(borders) -> Criterion:
    return Criterion(kind="full_bar", bar=FullSupportBarDistribution(borders))


def gaussian_nll_criterion() -> Criterion:
    return Criterion(kind="gaussian")


def mse_criterion() -> Criterion:
    return Criterion(kind="mse")


def ce_criterion(num_classes: int) -> Criterion:
    return Criterion(kind="ce", num_classes=num_classes)


def bce_criterion() -> Criterion:
    return Criterion(kind="bce")
