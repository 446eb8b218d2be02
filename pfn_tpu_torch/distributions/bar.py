"""Riemann ("bar") distribution output head.

Port of ``pfn_tpu/distributions/bar.py``: a histogram over ``num_bars``
buckets that is both the training loss (negative log density of a
piecewise-constant density) and the posterior-summary API (mean, mode,
quantiles, cdf, expected improvement, samples). ``FullSupportBarDistribution``
replaces the two end buckets by half-normal tails.

A distribution holds only its float32 ``borders``; methods take logits of
shape (..., num_bars) on the borders' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_HALF_LOG_2_OVER_PI = 0.5 * math.log(2.0 / math.pi)
# Standard half-normal inverse CDF at 0.5: sqrt(2) * erfinv(0.5).
_STD_HALFNORMAL_ICDF_05 = math.sqrt(2.0) * 0.47693627620446987


def _halfnormal_scale(range_max: torch.Tensor) -> torch.Tensor:
    """Scale s such that a HalfNormal(s) puts half its mass below range_max."""
    return range_max / _STD_HALFNORMAL_ICDF_05


def _halfnormal_logpdf(x, scale):
    return _HALF_LOG_2_OVER_PI - torch.log(scale) - 0.5 * (x / scale) ** 2


def _halfnormal_mean(scale):
    return scale * math.sqrt(2.0 / math.pi)


def _pick(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[..., idx[...]] along the last axis."""
    return torch.gather(t, -1, idx[..., None])[..., 0]


class BarDistribution:
    """Histogram distribution over ``num_bars`` buckets with sorted borders
    of length num_bars + 1."""

    def __init__(self, borders):
        borders = torch.as_tensor(borders, dtype=torch.float32)
        if borders.dim() != 1:
            raise ValueError("borders must be 1-D (sorted)")
        self.borders = borders

    def to(self, device) -> "BarDistribution":
        return type(self)(self.borders.to(device))

    @property
    def num_bars(self) -> int:
        return self.borders.shape[0] - 1

    @property
    def bucket_widths(self) -> torch.Tensor:
        return self.borders[1:] - self.borders[:-1]

    @property
    def bucket_means(self) -> torch.Tensor:
        return self.borders[:-1] + self.bucket_widths / 2

    def map_to_bucket_idx(self, y: torch.Tensor) -> torch.Tensor:
        """Index of the bucket holding y: border values land in the lower
        bucket, the two support endpoints in the end buckets."""
        y = torch.as_tensor(y, dtype=self.borders.dtype, device=self.borders.device)
        idx = torch.searchsorted(self.borders, y.contiguous(), right=False) - 1
        idx = torch.where(y == self.borders[0], torch.zeros_like(idx), idx)
        return torch.where(y == self.borders[-1], torch.full_like(idx, self.num_bars - 1), idx)

    def _bucket_log_probs(self, logits):
        return torch.log_softmax(logits, dim=-1) - torch.log(self.bucket_widths)

    def nll(self, logits, y):
        """Negative log density of y; targets outside the support are clamped
        to the end buckets. logits (..., num_bars), y (...) -> (...)."""
        idx = self.map_to_bucket_idx(y).clamp(0, self.num_bars - 1)
        return -_pick(self._bucket_log_probs(logits), idx.expand(logits.shape[:-1]))

    def mean(self, logits):
        return torch.softmax(logits, dim=-1) @ self.bucket_means

    def mode(self, logits):
        return self.bucket_means[logits.argmax(dim=-1)]

    def cdf(self, logits, y):
        """P(Y <= y), piecewise linear within buckets."""
        y = torch.as_tensor(y, dtype=self.borders.dtype, device=self.borders.device)
        p = torch.softmax(logits, dim=-1)
        cum = torch.cumsum(p, dim=-1)
        idx = self.map_to_bucket_idx(y).clamp(0, self.num_bars - 1)
        idx = idx.expand(logits.shape[:-1])
        y = y.expand(logits.shape[:-1])
        p_in = _pick(p, idx)
        cum_before = _pick(cum, idx) - p_in
        frac = ((y - self.borders[idx]) / self.bucket_widths[idx]).clamp(0.0, 1.0)
        out = cum_before + frac * p_in
        out = torch.where(y < self.borders[0], torch.zeros_like(out), out)
        return torch.where(y > self.borders[-1], torch.ones_like(out), out)

    def icdf(self, logits, q):
        """Quantile function: smallest y with CDF(y) >= q, linearly
        interpolated inside the bucket."""
        p = torch.softmax(logits, dim=-1)
        cum = torch.cumsum(p, dim=-1)
        qb = torch.as_tensor(q, dtype=p.dtype, device=p.device).expand(logits.shape[:-1])
        idx = torch.searchsorted(cum.contiguous(), qb.contiguous()[..., None], right=False)[..., 0]
        idx = idx.clamp(0, self.num_bars - 1)
        left_prob = torch.where(idx > 0, _pick(cum, (idx - 1).clamp_min(0)), torch.zeros_like(qb))
        p_idx = _pick(p, idx)
        frac = torch.where(p_idx > 0, (qb - left_prob) / p_idx, torch.zeros_like(qb))
        return self.borders[idx] + self.bucket_widths[idx] * frac.clamp(0.0, 1.0)

    def quantile(self, logits, center_prob: float = 0.682):
        """Central credible interval (lower, upper) with mass center_prob:
        shape (*logits.shape[:-1], 2)."""
        side_prob = (1.0 - center_prob) / 2.0
        return torch.stack([self.icdf(logits, side_prob), self.icdf(logits, 1.0 - side_prob)], dim=-1)

    def ei(self, logits, best_f, maximize: bool = True):
        """Expected improvement over best_f (scalar or broadcastable to
        logits.shape[:-1])."""
        best_f = torch.as_tensor(best_f, dtype=self.borders.dtype, device=self.borders.device)[..., None]
        lo, hi = self.borders[:-1], self.borders[1:]
        if maximize:
            contrib = ((hi + torch.maximum(lo, best_f)) / 2 - best_f).clamp_min(0.0)
        else:
            contrib = -((torch.minimum(hi, best_f) + lo) / 2 - best_f).clamp_max(0.0)
        return (torch.softmax(logits, dim=-1) * contrib).sum(dim=-1)

    def _draw(self, logits, generator):
        """A bucket index per row and a uniform in [0, 1) per row."""
        probs = torch.softmax(logits.float(), dim=-1).reshape(-1, self.num_bars)
        idx = torch.multinomial(probs, 1, generator=generator)[:, 0].reshape(logits.shape[:-1])
        u = torch.rand(idx.shape, generator=generator, device=logits.device)
        return idx, u

    def sample(self, logits, generator: torch.Generator | None = None):
        """Draw y ~ p(y | logits): a categorical bucket, then uniform within it."""
        idx, u = self._draw(logits, generator)
        return self.borders[idx] + u * self.bucket_widths[idx]


class FullSupportBarDistribution(BarDistribution):
    """Bar distribution whose first and last buckets are half-normal tails
    that extend the support to all of R. Each tail's scale puts half its mass
    within the end bucket's width."""

    def _tail_scales(self):
        return _halfnormal_scale(self.bucket_widths[0]), _halfnormal_scale(self.bucket_widths[-1])

    def nll(self, logits, y):
        y = torch.as_tensor(y, dtype=self.borders.dtype, device=self.borders.device)
        idx = self.map_to_bucket_idx(y).clamp(0, self.num_bars - 1)
        picked = _pick(self._bucket_log_probs(logits), idx.expand(logits.shape[:-1]))
        s0, s1 = self._tail_scales()
        corr0 = _halfnormal_logpdf((self.borders[1] - y).clamp_min(1e-8), s0) + torch.log(self.bucket_widths[0])
        corr1 = _halfnormal_logpdf((y - self.borders[-2]).clamp_min(1e-8), s1) + torch.log(self.bucket_widths[-1])
        picked = torch.where(idx == 0, picked + corr0, picked)
        picked = torch.where(idx == self.num_bars - 1, picked + corr1, picked)
        return -picked

    def mean(self, logits):
        s0, s1 = self._tail_scales()
        means = self.bucket_means.clone()
        means[0] = self.borders[1] - _halfnormal_mean(s0)
        means[-1] = self.borders[-2] + _halfnormal_mean(s1)
        return torch.softmax(logits, dim=-1) @ means

    def gaussian_cross_entropy(self, logits, mu, var):
        """Closed-form E_{y ~ N(mu, var)}[self.nll(logits, y)].

        Inner buckets contribute P_k (log w_k - log p_k) with P_k the Gaussian
        bucket mass; each tail contributes P_tail (-log p_tail + log s -
        log sqrt(2/pi)) + E[D^2 1{D>0}] / (2 s^2), D the signed distance past
        the inner border. Computed in the dtype of ``mu`` (pass float64 for
        many buckets: adjacent-CDF differences cancel in f32).
        logits (..., num_bars); mu, var broadcastable to (...). Returns (...).
        """
        mu = torch.as_tensor(mu)
        dtype = torch.promote_types(mu.dtype, torch.as_tensor(var).dtype)
        device = logits.device
        borders = self.borders.to(device=device, dtype=dtype)
        widths = borders[1:] - borders[:-1]
        lp = torch.log_softmax(logits.to(dtype), dim=-1)
        mu = mu.to(device=device, dtype=dtype)
        sd = torch.sqrt(torch.as_tensor(var, device=device, dtype=dtype))
        sqrt2 = math.sqrt(2.0)

        z = (borders - mu[..., None]) / sd[..., None]  # (..., K+1)
        cdf = 0.5 * (1.0 + torch.special.erf(z / sqrt2))
        pk = cdf[..., 1:] - cdf[..., :-1]
        ce = (pk[..., 1:-1] * (torch.log(widths[1:-1]) - lp[..., 1:-1])).sum(dim=-1)

        def tail(m, log_p_tail, scale):
            zz = m / sd
            phi = torch.exp(-0.5 * zz * zz) / math.sqrt(2.0 * math.pi)
            # Phi through erfc, not erf: f32 erf saturates one ULP below +-1,
            # and that phantom tail mass, amplified by 1/scale^2, costs ~1e-2
            # nats when the end buckets are narrow. erfc underflows to 0.
            big_phi = 0.5 * torch.special.erfc(-zz / sqrt2)
            e2 = (m * m + sd * sd) * big_phi + m * sd * phi
            return big_phi * (-log_p_tail + torch.log(scale) - _HALF_LOG_2_OVER_PI) + e2 / (2.0 * scale * scale)

        s0, s1 = self._tail_scales()
        ce = ce + tail(borders[1] - mu, lp[..., 0], s0.to(device=device, dtype=dtype))
        return ce + tail(mu - borders[-2], lp[..., -1], s1.to(device=device, dtype=dtype))

    def gaussian_kl(self, logits, mu, var):
        """KL(N(mu, var) || bar(logits)) in closed form (>= 0)."""
        mu = torch.as_tensor(mu)
        dtype = torch.promote_types(mu.dtype, torch.as_tensor(var).dtype)
        var = torch.as_tensor(var, device=logits.device, dtype=dtype)
        entropy = 0.5 * torch.log(2.0 * math.pi * math.e * var)
        return self.gaussian_cross_entropy(logits, mu, var) - entropy

    def sample(self, logits, generator: torch.Generator | None = None):
        """Posterior draw that honours the half-normal tails: end-bucket draws
        come from the tail distribution, by the half-normal inverse CDF."""
        idx, u = self._draw(logits, generator)
        u = u.clamp_min(1e-7)
        inner = self.borders[idx] + u * self.bucket_widths[idx]
        s0, s1 = self._tail_scales()
        dist = math.sqrt(2.0) * torch.special.erfinv(u)
        out = torch.where(idx == 0, self.borders[1] - s0 * dist, inner)
        return torch.where(idx == self.num_bars - 1, self.borders[-2] + s1 * dist, out)


def get_bucket_limits(num_outputs: int, full_range: tuple | None = None, ys=None, verbose: bool = False):
    """Bucket borders: equal-width over a range, or equal-mass quantile
    buckets from a sample of y values. Host numpy; returns a float32 tensor
    on the CPU. Duplicate borders (repeated y values) are spread a minimal
    epsilon apart so no bucket has zero width.
    """
    if ys is None and full_range is None:
        raise ValueError("get_bucket_limits needs ys or full_range")
    if ys is not None:
        if isinstance(ys, torch.Tensor):
            ys = ys.detach().cpu().numpy()
        ys = np.asarray(ys).flatten()
        if not np.isfinite(ys).all():
            raise ValueError(
                "non-finite values in the y sample used for bucket estimation: check the prior's sampler"
            )
        if len(ys) % num_outputs:
            ys = ys[: -(len(ys) % num_outputs)]
        if verbose:
            print(f"Using {len(ys)} y evals to estimate {num_outputs} buckets.")
        ys_per_bucket = len(ys) // num_outputs
        if full_range is None:
            full_range = (float(ys.min()), float(ys.max()))
        elif not (full_range[0] <= ys.min() and full_range[1] >= ys.max()):
            raise ValueError(f"full_range {full_range} does not cover the y sample")
        ys_sorted = np.sort(ys)
        bucket_limits = (
            ys_sorted[ys_per_bucket - 1 :: ys_per_bucket][:-1] + ys_sorted[ys_per_bucket::ys_per_bucket]
        ) / 2
        bucket_limits = np.concatenate([[full_range[0]], bucket_limits, [full_range[1]]])
        eps = max(1e-6, 1e-7 * (full_range[1] - full_range[0]))
        for i in range(1, len(bucket_limits)):
            if bucket_limits[i] <= bucket_limits[i - 1]:
                bucket_limits[i] = bucket_limits[i - 1] + eps
        full_range = (full_range[0], float(bucket_limits[-1]))
    else:
        class_width = (full_range[1] - full_range[0]) / num_outputs
        bucket_limits = np.concatenate([full_range[0] + np.arange(num_outputs) * class_width, [full_range[1]]])
    if len(bucket_limits) - 1 != num_outputs:
        raise AssertionError(f"{len(bucket_limits) - 1} buckets, expected {num_outputs}")
    return torch.as_tensor(bucket_limits, dtype=torch.float32)
