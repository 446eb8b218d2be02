"""Parity of the port's data transforms, hyperprior specs and the MLP
prior's categorical discretizer (``pfn_tpu_torch/priors/transforms.py``,
``hyper.py``, ``mlp.py``) with the JAX package.

Tolerances:
  * transforms: 1e-6 (atol and rtol) for the z-score (two f32 reductions in
    another order); the median, the median labels and order_by_y exactly.
  * hyper specs: the port's generator-driven samplers against scipy's
    distributions, 200 000 draws from a fixed seed: the mean within 4
    standard errors, the variance within 5 %, and a Kolmogorov-Smirnov
    p-value above 1e-3; the JAX spec's mean within 6 standard errors of the
    port's (the random streams differ, so only the distributions compare).
  * categorical discretization: the counts exactly equal except where the
    z-scored value lies within 1e-5 of an active threshold; on the data below
    no such cell occurs (asserted: 0 cells near a threshold among the 8160
    categorical cells compared). The JAX draws are replayed from its key
    tree (tests/torch_port_mlp_replay.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from pfn_tpu.priors import hyper as jhyper
from pfn_tpu.priors import transforms as jtr
from pfn_tpu_torch.priors import hyper, transforms
from pfn_tpu.priors.mlp import MLPPrior as JaxMLPPrior
from pfn_tpu_torch.priors.base import default_group_size
from torch_port_mlp_replay import SMALL, T, jax_categorical_draws, port_prior


def _t(a):
    return torch.from_numpy(np.array(a))


def _ties(seed, shape):
    """f32 data with many ties: values on a coarse grid."""
    return np.round(np.random.default_rng(seed).standard_normal(shape) * 2).astype(np.float32) / 2


@pytest.mark.parametrize("T_", [40, 41])
def test_transforms_match_jax_with_ties(T_):
    y = _ties(0, (6, T_))
    x = np.random.default_rng(1).standard_normal((6, T_, 3)).astype(np.float32)
    np.testing.assert_allclose(transforms.normalize_data(_t(x)).numpy(), np.asarray(jtr.normalize_data(x)),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(transforms.median(_t(y)).numpy(), np.asarray(jnp.median(y, axis=1, keepdims=True)))
    got = transforms.binarize_by_median(_t(y)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtr.binarize_by_median(y)))
    # torch.median returns the lower middle value, so at even T its median
    # differs from jnp.median on every dataset of distinct values. The labels
    # y > median would not: y > lo and y > (lo + hi) / 2 select the same rows.
    if T_ % 2 == 0:
        yc = _t(x[..., 0])
        lower = torch.median(yc, dim=1, keepdim=True).values
        assert (lower < transforms.median(yc)).all()
        assert torch.equal((yc > lower).float(), transforms.binarize_by_median(yc))


def test_order_by_y_matches_jax():
    x = np.random.default_rng(2).standard_normal((5, 12, 2)).astype(np.float32)
    y = _ties(3, (5, 12))
    key = jax.random.PRNGKey(4)
    want_x, want_y = jtr.order_by_y(key, x, y)
    up = np.asarray(jax.random.bernoulli(key, shape=(5, 1)))
    got_x, got_y = transforms.order_by_y_from_draws(_t(x), _t(y), _t(up))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    gx, gy = transforms.order_by_y(_t(x), _t(y), torch.Generator().manual_seed(0))
    assert gx.shape == x.shape and np.array_equal(np.sort(gy.numpy(), 1), np.sort(y, 1))


def test_default_group_size_matches_jax():
    from pfn_tpu.priors.base import default_group_size as jax_group_size

    for b in (1, 7, 64, 100, 256):
        for divisor in (8, 10, 16):
            assert default_group_size(b, divisor) == jax_group_size(b, divisor)


# ---------------------------------------------------------------------------
# hyper specs
# ---------------------------------------------------------------------------

SPECS = [
    ("Uniform", (0.2, 1.5), st.uniform(0.2, 1.3)),
    ("LogUniform", (0.01, 1.0), st.loguniform(0.01, 1.0)),
    ("TruncNorm", (0.3, 0.5), st.truncnorm(-0.6, 1.4, loc=0.3, scale=0.5)),
    ("Beta", (0.5, 0.8), st.beta(0.5, 0.8)),
    ("Beta", (0.1, 2.0), st.beta(0.1, 2.0)),
    ("Gamma", (1.1, 20.0), st.gamma(1.1, scale=20.0)),
    ("Gamma", (0.5, 1 / 0.15), st.gamma(0.5, scale=1 / 0.15)),
    ("Gamma", (3.0, 1 / 6.0), st.gamma(3.0, scale=1 / 6.0)),
]


@pytest.mark.parametrize("name,args,dist", SPECS, ids=[f"{n}{a}" for n, a, _ in SPECS])
def test_hyper_spec_moments_against_scipy(name, args, dist):
    n = 200_000
    s = getattr(hyper, name)(*args).sample(torch.Generator().manual_seed(0), (n,)).double().numpy()
    assert s.dtype == np.float64 and np.isfinite(s).all()
    assert abs(s.mean() - dist.mean()) < 4 * np.sqrt(dist.var() / n)
    assert s.var() == pytest.approx(dist.var(), rel=0.05)
    assert st.kstest(s, dist.cdf).pvalue > 1e-3
    # The JAX spec of the same name and arguments draws the same distribution.
    j = np.asarray(getattr(jhyper, name)(*args).sample(jax.random.PRNGKey(0), (n,)), np.float64)
    assert abs(j.mean() - s.mean()) < 6 * np.sqrt(dist.var() / n)


def test_discrete_and_constant_specs():
    g = torch.Generator().manual_seed(1)
    u = hyper.UniformInt(3, 6).sample(g, (30_000,))
    assert u.dtype == torch.int32 and set(u.unique().tolist()) == {3, 4, 5}
    assert np.allclose(np.bincount(u.numpy())[3:] / 30_000, 1 / 3, atol=0.02)
    c = hyper.Constant(0.25).sample(g, (4,))
    assert c.dtype == torch.float32 and c.tolist() == [0.25] * 4
    sb = hyper.ScaledBeta(0.5, 0.8, 10, 1).sample(g, (50_000,)).numpy()
    # minimum + round(Beta * (scale - minimum + 1) - 0.5): integers in [1, 11).
    assert set(np.unique(sb)) <= set(range(1, 11)) and np.all(sb == np.round(sb))
    # round(10 z - 0.5) = k for z in [k / 10, (k + 1) / 10).
    z = st.beta(0.5, 0.8)
    want = [z.cdf(v / 10) - z.cdf((v - 1) / 10) for v in range(1, 11)]
    assert np.allclose([(sb == v).mean() for v in range(1, 11)], want, atol=0.01)


def test_samplers_follow_the_generator():
    """Draws depend on the generator alone (not the global RNG): the train
    loop's bitwise resume needs it."""
    for spec in (hyper.Gamma(0.5, 1.0), hyper.Beta(0.1, 2.0), hyper.TruncNorm(0.5, 0.2)):
        torch.manual_seed(0)
        a = spec.sample(torch.Generator().manual_seed(3), (100,))
        torch.manual_seed(1)
        b = spec.sample(torch.Generator().manual_seed(3), (100,))
        assert torch.equal(a, b)


def test_categorical_counts_exact_away_from_thresholds():
    """The discretizer alone, on the same raw x: searchsorted counts against
    JAX's broadcast compare-and-reduce. Cells whose z lies within 1e-5 of an
    active threshold are excluded; there are none here."""
    jp = JaxMLPPrior(**SMALL, categorical_x=True, num_features_used=jhyper.UniformInt(3, 6))
    prior = port_prior(jp)
    maxc = jp.max_categorical_classes_ordinal
    rng = np.random.default_rng(0)
    checked = near_total = cat_total = 0
    for g in range(6):
        gk = jax.random.PRNGKey(100 + g)
        x = rng.standard_normal((12, T, 5)).astype(np.float32)
        n_used = np.int32(3 + g % 3)
        kc_root = jax.random.split(gk, 12)[11]
        want = np.asarray(jp._discretize_categoricals(kc_root, jnp.asarray(x), jnp.asarray(n_used)))
        d = {k: _t(np.asarray(v)[None]) for k, v in jax_categorical_draws(jp, gk).items()}
        got = prior._discretize_categoricals(d, _t(x)[None], torch.tensor([n_used]))[0].numpy()
        z = np.asarray(jtr.normalize_data(x, axis=1))
        thr = d["thresholds"][0].numpy() - 0.5
        n_cls = np.where(d["ordinal"][0].numpy() < 0.5,
                         1 + np.clip(np.floor(d["classes_ordinal"][0].numpy() * maxc), 0, maxc - 1),
                         1 + np.clip(np.floor(d["classes_nominal"][0].numpy() * 10), 0, 9)).astype(int)
        gap = np.full(z.shape, np.inf)
        for f in range(5):
            gap[..., f] = np.abs(z[..., f, None] - thr[f, :n_cls[f]]).min(-1)
        is_cat = (want != x).any(axis=(0, 1))
        near = (gap < 1e-5) & is_cat
        near_total += int(near.sum())
        cat_total += int(is_cat.sum()) * 12 * T
        ok = ~near
        np.testing.assert_array_equal(got[ok], want[ok])
        checked += int(ok.sum())
    assert near_total == 0 and cat_total == 8160
    assert checked == 6 * 12 * T * 5


def test_searchsorted_count_equals_broadcast_count_on_ties():
    """Crafted ties: z equal to a threshold is not counted (the compare is
    strict), equal thresholds count once each, inactive ones (+inf) never."""
    thr = torch.tensor([[-0.5, 0.0, 0.0, 0.25, 0.4, 0.1]])  # one feature, maxc 6
    n_cls = torch.tensor([4])
    active = torch.arange(6) < n_cls[:, None]
    z = torch.tensor([[-0.6, -0.5, -0.1, 0.0, 1e-8, 0.25, 0.3, 0.4, 0.5]])
    broadcast = ((z[..., None] > thr[:, None, :]) & active[:, None, :]).sum(-1)
    sorted_thr = torch.where(active, thr, torch.inf).sort(-1).values
    got = torch.searchsorted(sorted_thr, z, side="left")
    assert got.tolist() == broadcast.tolist() == [[0, 0, 1, 1, 3, 3, 4, 4, 4]]
