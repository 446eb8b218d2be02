"""Hyper-hyperparameter samplers on the device.

Port of ``pfn_tpu/priors/hyper.py`` (reference priors/utils.py:64-70): each
spec is a frozen dataclass with ``sample(generator, shape, device)``, so the
meta-level randomness of a prior (which MLP depth? which init std?) is drawn
on the device from the caller's ``torch.Generator``, with no host sync.

``torch.distributions.Beta`` and ``Gamma`` (``torch._standard_gamma``) draw
from the global generator and take none, which would break the train loop's
bitwise resume. So gamma draws here are Marsaglia and Tsang's method driven
by the generator: a fixed count of rejection rounds drawn at once, the first
accepted one kept (no host sync; a draw rejected in every round, probability
below 1e-20 at the 16 rounds used, keeps its last candidate). Concentrations
below 1 take the boost Gamma(a) = Gamma(a + 1) U^(1/a), in log space so that
Beta(0.1, 2) keeps its small values; Beta is G1 / (G1 + G2). The truncated
normal is an inverse CDF in float64.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_GAMMA_ROUNDS = 16


def _log_standard_gamma(concentration: float, shape, generator, device) -> torch.Tensor:
    """log of Gamma(concentration, 1) draws of ``shape``, float32."""
    a = float(concentration)
    if a <= 0:
        raise ValueError(f"gamma concentration must be positive, got {a}")
    boost = a < 1.0
    d = (a + 1.0 if boost else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    shape = tuple(shape)
    z = torch.randn((_GAMMA_ROUNDS, *shape), generator=generator, device=device)
    u = torch.rand((_GAMMA_ROUNDS, *shape), generator=generator, device=device)
    v = (1.0 + c * z) ** 3
    log_v = torch.log(v.clamp_min(1e-30))
    accept = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v + d * log_v)
    first = torch.argmax(accept.to(torch.int8), dim=0, keepdim=True)
    first = torch.where(accept.any(dim=0, keepdim=True), first, torch.full_like(first, _GAMMA_ROUNDS - 1))
    log_g = math.log(d) + torch.gather(log_v, 0, first)[0]
    if boost:
        # 1 - U in (0, 1]: its log is finite.
        ub = 1.0 - torch.rand(shape, generator=generator, device=device)
        log_g = log_g + torch.log(ub) / a
    return log_g


def sample_gamma(concentration: float, shape, generator=None, device=None) -> torch.Tensor:
    """Gamma(concentration, scale 1) draws, float32."""
    return torch.exp(_log_standard_gamma(concentration, shape, generator, device))


def sample_beta(a: float, b: float, shape, generator=None, device=None) -> torch.Tensor:
    """Beta(a, b) draws as G1 / (G1 + G2) = sigmoid(log G1 - log G2), float32."""
    log_g1 = _log_standard_gamma(a, shape, generator, device)
    log_g2 = _log_standard_gamma(b, shape, generator, device)
    return torch.sigmoid(log_g1 - log_g2)


class HyperSpec:
    def sample(self, generator: torch.Generator | None = None, shape=(), device=None) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Constant(HyperSpec):
    value: float

    def sample(self, generator=None, shape=(), device=None):
        return torch.full(tuple(shape), self.value, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Uniform(HyperSpec):
    low: float
    high: float

    def sample(self, generator=None, shape=(), device=None):
        u = torch.rand(tuple(shape), generator=generator, device=device)
        return self.low + u * (self.high - self.low)


@dataclasses.dataclass(frozen=True)
class LogUniform(HyperSpec):
    low: float
    high: float

    def sample(self, generator=None, shape=(), device=None):
        u = torch.rand(tuple(shape), generator=generator, device=device)
        return torch.exp(math.log(self.low) + u * (math.log(self.high) - math.log(self.low)))


@dataclasses.dataclass(frozen=True)
class UniformInt(HyperSpec):
    """Integer-valued uniform over [low, high) (priors/utils.py:68), int32."""

    low: int
    high: int

    def sample(self, generator=None, shape=(), device=None):
        return torch.randint(self.low, self.high, tuple(shape), generator=generator, device=device,
                             dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class TruncNorm(HyperSpec):
    """N(mu, sigma) truncated to [0, 1] (priors/utils.py:64)."""

    mu: float
    sigma: float

    def sample(self, generator=None, shape=(), device=None):
        a = (0.0 - self.mu) / self.sigma
        b = (1.0 - self.mu) / self.sigma
        lo, hi = (0.5 * math.erfc(-t / math.sqrt(2.0)) for t in (a, b))  # Phi(a), Phi(b)
        u = torch.rand(tuple(shape), generator=generator, device=device, dtype=torch.float64)
        z = torch.special.ndtri(lo + u * (hi - lo)).clamp(a, b)
        return (self.mu + self.sigma * z).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class Beta(HyperSpec):
    a: float
    b: float

    def sample(self, generator=None, shape=(), device=None):
        return sample_beta(self.a, self.b, shape, generator, device)


@dataclasses.dataclass(frozen=True)
class Gamma(HyperSpec):
    """Gamma(concentration=a, scale=b) like np.random.gamma(a, b)
    (priors/utils.py:66)."""

    a: float
    b: float

    def sample(self, generator=None, shape=(), device=None):
        return self.b * sample_gamma(self.a, shape, generator, device)


@dataclasses.dataclass(frozen=True)
class ScaledBeta(HyperSpec):
    """minimum + round(Beta(a, b) * (scale - minimum + 1) - .5), integer-ish
    (priors/utils.py:70)."""

    a: float
    b: float
    scale: float
    minimum: float = 0.0

    def sample(self, generator=None, shape=(), device=None):
        z = sample_beta(self.a, self.b, shape, generator, device)
        return self.minimum + torch.round(z * (self.scale - self.minimum + 1.0) - 0.5)
