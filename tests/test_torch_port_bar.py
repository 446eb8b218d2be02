"""Parity of the port's bar-distribution heads and criterions with the JAX
package, on the same numpy logits and targets.

Tolerances: 1e-5 (atol and rtol) for f32 methods, where both sides compute
the same f32 formulas and differ in summation order; 1e-9 for the f64
closed-form Gaussian cross-entropy and KL (run under JAX's x64 mode). Sampling
is compared in distribution, as the random streams differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.distributions import bar as jbar
from pfn_tpu.train import losses as jlosses
from pfn_tpu_torch.distributions import bar as tbar
from pfn_tpu_torch.train import losses as tlosses

K = 24
TOL = 1e-5


def _borders(seed=0):
    ys = np.random.default_rng(seed).standard_normal(4800).astype(np.float32)
    got = tbar.get_bucket_limits(K, ys=ys)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbar.get_bucket_limits(K, ys=ys)))
    return got.numpy()


def _logits_and_y(borders, seed=1, shape=(3, 7)):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal(shape + (K,))).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32) * 1.5
    # Border values, the support's endpoints and points outside it.
    y.flat[:5] = [borders[0], borders[-1], borders[3], borders[0] - 1.0, borders[-1] + 2.0]
    return logits, y


def _dists(borders, full):
    cls_j = jbar.FullSupportBarDistribution if full else jbar.BarDistribution
    cls_t = tbar.FullSupportBarDistribution if full else tbar.BarDistribution
    return cls_j.create(borders), cls_t(borders)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("full", [False, True])
def test_methods_match_jax(full):
    borders = _borders()
    jd, td = _dists(borders, full)
    logits, y = _logits_and_y(borders)
    lj, yj = jnp.asarray(logits), jnp.asarray(y)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(y)
    np.testing.assert_array_equal(td.map_to_bucket_idx(yt).numpy(), np.asarray(jd.map_to_bucket_idx(yj)))
    _close(td.nll(lt, yt), jd.nll(lj, yj))
    _close(td.mean(lt), jd.mean(lj))
    _close(td.mode(lt), jd.mode(lj))
    _close(td.cdf(lt, yt), jd.cdf(lj, yj))
    for q in (0.01, 0.3, 0.5, 0.97):
        _close(td.icdf(lt, q), jd.icdf(lj, q))
    _close(td.quantile(lt), jd.quantile(lj))
    _close(td.quantile(lt, 0.9), jd.quantile(lj, 0.9))
    for maximize in (True, False):
        _close(td.ei(lt, 0.3, maximize=maximize), jd.ei(lj, 0.3, maximize=maximize))
        _close(td.ei(lt, yt, maximize=maximize), jd.ei(lj, yj, maximize=maximize))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_gaussian_cross_entropy_and_kl_match_jax(dtype):
    borders = _borders(seed=2)
    logits, _ = _logits_and_y(borders, seed=3)
    rng = np.random.default_rng(4)
    mu = rng.standard_normal(logits.shape[:-1]) * 1.5
    var = np.exp(rng.uniform(-8, 0.5, size=logits.shape[:-1]))
    np_dtype, t_dtype, tol = (np.float64, torch.float64, 1e-9) if dtype == "f64" else (np.float32, torch.float32, 1e-4)
    with jax.enable_x64(dtype == "f64"):
        jd = jbar.FullSupportBarDistribution.create(borders)
        args = (jnp.asarray(logits, np_dtype), jnp.asarray(mu, np_dtype), jnp.asarray(var, np_dtype))
        want_ce = np.asarray(jd.gaussian_cross_entropy(*args))
        want_kl = np.asarray(jd.gaussian_kl(*args))
    td = tbar.FullSupportBarDistribution(borders)
    targs = (torch.tensor(logits, dtype=t_dtype), torch.tensor(mu, dtype=t_dtype), torch.tensor(var, dtype=t_dtype))
    got_kl = td.gaussian_kl(*targs)
    assert got_kl.dtype == t_dtype
    _close(td.gaussian_cross_entropy(*targs), want_ce, tol)
    _close(got_kl, want_kl, tol)
    assert float(got_kl.min()) >= -1e-6


def test_get_bucket_limits_duplicates_range_and_equal_width():
    # Repeated values (0/1 spikes) give duplicate borders; both packages
    # spread them an epsilon apart.
    ys = np.concatenate([np.zeros(300), np.ones(300), np.linspace(0, 1, 400)]).astype(np.float32)
    got = tbar.get_bucket_limits(20, ys=ys)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbar.get_bucket_limits(20, ys=ys)))
    assert bool((got[1:] > got[:-1]).all()) and got.dtype == torch.float32
    got = tbar.get_bucket_limits(10, full_range=(-2.0, 3.0), ys=ys)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbar.get_bucket_limits(10, full_range=(-2.0, 3.0), ys=ys)))
    got = tbar.get_bucket_limits(7, full_range=(-1.0, 2.5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbar.get_bucket_limits(7, full_range=(-1.0, 2.5))))
    with pytest.raises(ValueError):
        tbar.get_bucket_limits(4, ys=np.array([0.0, np.nan, 1.0, 2.0]))


@pytest.mark.parametrize("full", [False, True])
def test_sample_follows_the_distribution(full):
    """Bucket frequencies of 40k draws match the softmax; draws lie in their
    bucket (inner) or beyond the inner border (tails); a seeded generator
    repeats its draws."""
    borders = _borders(seed=5)
    _, td = _dists(borders, full)
    logits = torch.from_numpy(np.random.default_rng(6).standard_normal(K).astype(np.float32))
    n = 40_000
    draws = td.sample(logits.expand(n, K), torch.Generator().manual_seed(0))
    again = td.sample(logits.expand(n, K), torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(draws.numpy(), again.numpy())
    idx = td.map_to_bucket_idx(draws).clamp(0, K - 1)
    freq = torch.bincount(idx, minlength=K).double() / n
    p = torch.softmax(logits.double(), dim=-1)
    assert float((freq - p).abs().max()) < 4 * float(torch.sqrt(p * (1 - p) / n).max()) + 1e-3
    if full:
        assert bool((draws[idx == 0] <= borders[1]).all()) and bool((draws[idx == K - 1] >= borders[-2]).all())
        assert float(draws.min()) < borders[0] or float(draws.max()) > borders[-1]
    else:
        assert float(draws.min()) >= borders[0] and float(draws.max()) <= borders[-1]


def _criteria(borders):
    return [
        ("bar", jlosses.bar_criterion(borders), tlosses.bar_criterion(borders), K),
        ("full_bar", jlosses.full_support_bar_criterion(borders), tlosses.full_support_bar_criterion(borders), K),
        ("gaussian", jlosses.gaussian_nll_criterion(), tlosses.gaussian_nll_criterion(), 2),
        ("mse", jlosses.mse_criterion(), tlosses.mse_criterion(), 1),
        ("bce", jlosses.bce_criterion(), tlosses.bce_criterion(), 1),
        ("ce", jlosses.ce_criterion(5), tlosses.ce_criterion(5), 5),
    ]


def test_criterions_match_jax():
    borders = _borders(seed=7)
    rng = np.random.default_rng(8)
    for kind, jc, tc, width in _criteria(borders):
        assert tc.kind == kind and tc.n_out(1) == jc.n_out(1) == width
        out = rng.standard_normal((2, 9, width)).astype(np.float32)
        if kind == "ce":
            tgt = rng.integers(0, 5, size=(2, 9)).astype(np.float32)
            tgt[0, :3] = -100.0
        elif kind == "bce":
            tgt = rng.integers(0, 2, size=(2, 9)).astype(np.float32)
        else:
            tgt = rng.standard_normal((2, 9)).astype(np.float32)
        to, tt = torch.from_numpy(out), torch.from_numpy(tgt)
        _close(tc.per_position(to, tt), jc.per_position(jnp.asarray(out), jnp.asarray(tgt)))
        _close(tc.valid_weight(tt), jc.valid_weight(jnp.asarray(tgt)))
        if kind in ("bar", "full_bar"):
            _close(tc.mean(to), jc.mean(jnp.asarray(out)))
        else:
            with pytest.raises(ValueError):
                tc.mean(to)
