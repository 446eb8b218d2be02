"""Parity of the port's Matern kernel, per-dataset GP sampling, GP-mix prior,
binarized priors and batch mixture with the JAX package.

The JAX samplers draw inside ``jax.random``; the tests replay their key trees
(``pfn_tpu/ops/gp_sample.py:gp_sample_paths``,
``pfn_tpu/priors/gp_mix.py:GPMixPrior.sample``,
``pfn_tpu/priors/binarize.py``) and feed those draws to the port's
draws-to-(x, y) functions.

Tolerances:
  * ``matern52_kernel``: 1e-5 (atol and rtol), the same f32 arithmetic.
  * GP sample paths and GPMixPrior: 1e-4 (atol and rtol), as
    tests/test_torch_port_gp.py: the two packages' f32 Cholesky factors differ
    in rounding. Which datasets the first rejection round replaces is
    compared exactly.
  * Bernoulli labels from the same y and uniforms: exactly.
  * ``_allocate`` and BatchMixture's split, padding and order: exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.ops import gp_sample as jgp
from pfn_tpu.priors.binarize import BinarizedPrior as JaxBinarizedPrior
from pfn_tpu.priors.gp_mix import GPMixPrior as JaxGPMixPrior
from pfn_tpu.priors.mixture import BatchMixture as JaxBatchMixture
from pfn_tpu.priors.mixture import _allocate as jax_allocate
from pfn_tpu_torch.ops import gp_sample as tgp
from pfn_tpu_torch.priors import BatchMixture, BinarizedPrior, GPMixPrior, MLPPrior, hyper
from pfn_tpu_torch.priors import binarized_gp_mix_prior, binarized_gp_prior
from pfn_tpu_torch.priors.binarize import bernoulli_labels
from pfn_tpu_torch.priors.mixture import _allocate


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def _normals(key, B, T):
    """The normals jax gp_sample_paths draws: one (T,) per dataset key."""
    return np.stack([np.asarray(jax.random.normal(k, (T,))) for k in jax.random.split(key, B)])


def test_matern52_kernel_matches_jax():
    rng = np.random.default_rng(0)
    x1 = rng.uniform(size=(3, 20, 4)).astype(np.float32)
    x2 = rng.uniform(size=(3, 15, 4)).astype(np.float32)
    ls = rng.uniform(0.2, 1.0, size=(4,)).astype(np.float32)
    want = np.asarray(jgp.matern52_kernel(x1, x2, ls, 1.7))
    _close(tgp.matern52_kernel(_t(x1), _t(x2), _t(ls), 1.7), want, 1e-5)
    # d = 0 on the diagonal: K = outputscale exactly, no NaN from the sqrt.
    diag = torch.diagonal(tgp.matern52_kernel(_t(x1), _t(x1), 0.5, 2.0), dim1=-2, dim2=-1)
    assert torch.allclose(diag, torch.full_like(diag, 2.0), atol=1e-6)


@pytest.mark.parametrize("kernel", ["rbf", "matern52"])
def test_per_dataset_hypers_match_jax(kernel):
    """(B,) outputscale and noise, (B, F) ARD lengthscale; then a shared (F,)
    lengthscale with per-dataset scalars."""
    B, T, F = 4, 30, 3
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(B, T, F)).astype(np.float32)
    ls = rng.uniform(0.3, 1.2, size=(B, F)).astype(np.float32)
    os_ = rng.uniform(0.5, 2.0, size=(B,)).astype(np.float32)
    nz = rng.uniform(1e-3, 1e-1, size=(B,)).astype(np.float32)
    jk, tk = getattr(jgp, f"{kernel}_kernel"), getattr(tgp, f"{kernel}_kernel")
    key = jax.random.PRNGKey(2)
    z = _normals(key, B, T)
    for lengthscale in (ls, ls[0]):
        want = jgp.gp_sample_paths(key, jnp.asarray(x), lengthscale, os_, nz, kernel=jk)
        got = tgp.gp_sample_paths_from_normals(_t(x), _t(z), _t(lengthscale), _t(os_), _t(nz), kernel=tk)
        _close(got, want, 1e-4)
    with pytest.raises(ValueError, match="ambiguous"):
        tgp.gp_sample_paths_from_normals(_t(x[:3]), _t(z[:3]), _t(ls[:3, 0]), 1.0, 0.1)


def _jax_gp_mix_draws(prior, key, B, T):
    """Replay of pfn_tpu's GPMixPrior.sample draws, in the port's layout."""
    k_h, k_x, k_y, k_retry = jax.random.split(key, 4)
    NG = B // prior._group_size(B)
    k_n, k_l, k_o = jax.random.split(k_h, 3)
    d = {"noise": jax.random.gamma(k_n, prior.noise_concentration, (NG,)),
         "lengthscale": jax.random.gamma(k_l, prior.lengthscale_concentration, (NG, prior.num_features)),
         "outputscale": jax.random.gamma(k_o, prior.outputscale_concentration, (NG,))}
    keys = [(k_x, k_y)]
    rkey = k_retry
    for _ in range(prior.max_retries if prior.fix_to_range is not None else 0):
        rkey, kx, ky = jax.random.split(rkey, 3)
        keys.append((kx, ky))
    d["x"] = np.stack([np.asarray(jax.random.uniform(kx, (B, T, prior.num_features))) for kx, _ in keys])
    d["z"] = np.stack([_normals(ky, B, T) for _, ky in keys])
    return {k: _t(v) for k, v in d.items()}


GP_MIX_CASES = {
    "plain": dict(num_features=2),
    "fix_to_range": dict(num_features=2, fix_to_range=(-10.0, 10.0), max_retries=4),
    "sigmoid_range": dict(num_features=1, sigmoid=True, fix_to_range=(0.001, 0.999), max_retries=3),
    "minmax": dict(num_features=3, y_minmax_norm=True),
}


@pytest.mark.parametrize("case", list(GP_MIX_CASES))
def test_gp_mix_prior_matches_jax_on_replayed_draws(case):
    B, T = 8, 25
    kw = dict(GP_MIX_CASES[case], batch_size_per_gp_sample=2)
    jp, prior = JaxGPMixPrior(**kw), GPMixPrior(**kw)
    key = jax.random.PRNGKey(3)
    want_x, want_y, _ = jp.sample(key, B, T)
    d = _jax_gp_mix_draws(jp, key, B, T)
    x, y = prior.from_draws(d)
    np.testing.assert_array_equal(x.numpy(), np.asarray(want_x))
    _close(y, want_y, 1e-4)
    for h_t, h_j in zip(prior.hypers(d, B), jp.sample_hypers(jax.random.split(key, 4)[0], B)):
        _close(h_t, h_j, 1e-5)
    if prior.fix_to_range is not None:
        lo, hi = prior.fix_to_range
        first = prior._draw_y(d["x"][0], d["z"][0], prior.hypers(d, B))
        replaced = ~((first >= lo) & (first < hi)).all(dim=1)
        assert 0 < int(replaced.sum()) < B  # some datasets were drawn again
        # The JAX package's first draw, for the same decision.
        k_h, k_x, k_y, _ = jax.random.split(key, 4)
        noise, ls, os_ = jp.sample_hypers(k_h, B)
        y0 = jgp.gp_sample_paths(k_y, jp._sample_x(k_x, B, T), ls, os_, noise, kernel=jgp.matern52_kernel)
        y0 = jax.nn.sigmoid(y0) if jp.sigmoid else y0
        np.testing.assert_array_equal(replaced.numpy(), np.asarray(~((y0 >= lo) & (y0 < hi)).all(axis=1)))
        assert bool(((y >= lo) & (y < hi)).all())
    a = prior.sample(B, T, generator=torch.Generator().manual_seed(0))
    b = prior.sample(B, T, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(u, v) for u, v in zip(a, b)) and bool(torch.isfinite(a[1]).all())


def test_binarized_prior_matches_jax():
    B, T = 8, 20
    kw = dict(num_features=2, batch_size_per_gp_sample=4)
    jp = JaxBinarizedPrior(base=JaxGPMixPrior(**kw))
    key = jax.random.PRNGKey(4)
    want_x, want_labels, want_t = jp.sample(key, B, T)
    k_base, k_bern = jax.random.split(key)
    _, y, _ = jp.base.sample(k_base, B, T)
    u = np.asarray(jax.random.uniform(k_bern, (B, T)))
    got = bernoulli_labels(_t(y), _t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_labels))
    np.testing.assert_array_equal(np.asarray(want_t), np.asarray(want_labels))
    # The port's wrapper around a base prior: x from the base, labels in {0, 1}.
    prior = BinarizedPrior(base=GPMixPrior(**kw))
    assert prior.num_features == 2 and prior.num_outputs == 2 == jp.num_outputs
    x, labels, target = prior.sample(B, T, generator=torch.Generator().manual_seed(1))
    x_base, _, _ = prior.base.sample(B, T, generator=torch.Generator().manual_seed(1))
    assert torch.equal(x, x_base) and torch.equal(labels, target)
    assert set(labels.unique().tolist()) == {0.0, 1.0}
    assert isinstance(binarized_gp_mix_prior(num_features=3).base, GPMixPrior)
    x, labels, _ = binarized_gp_prior(num_features=1, grid=64).sample(4, 30, generator=torch.Generator())
    assert x.shape == (4, 30, 1) and set(labels.unique().tolist()) <= {0.0, 1.0}


@pytest.mark.parametrize("batch_size", [1, 2, 3, 7, 10, 64, 100, 256])
def test_allocate_matches_jax_exactly(batch_size):
    for weights in ((0.8, 0.2), (1, 1, 1), (0.5, 0.0, 0.5), (3, 1e-3), (0.1, 0.2, 0.3, 0.4), (5,)):
        assert _allocate(batch_size, weights) == jax_allocate(batch_size, weights)
    with pytest.raises(ValueError, match="positive sum"):
        _allocate(4, (0.0, 0.0))


class _JaxStub:
    """A deterministic JAX prior: x = c + row index, F columns."""

    def __init__(self, c, num_features, num_outputs=1):
        self.c, self.num_features, self.num_outputs = c, num_features, num_outputs

    def sample(self, key, n, T):
        x = self.c + jnp.arange(n, dtype=jnp.float32)[:, None, None] + jnp.zeros((n, T, self.num_features))
        return x, x[..., 0] * 2, x[..., 0] * 3


class _Stub:
    """The port's counterpart of _JaxStub."""

    def __init__(self, c, num_features, num_outputs=1):
        self.c, self.num_features, self.num_outputs = c, num_features, num_outputs

    def sample(self, n, T, generator=None, device=None):
        x = self.c + torch.arange(n, dtype=torch.float32)[:, None, None] + torch.zeros((n, T, self.num_features))
        return x, x[..., 0] * 2, x[..., 0] * 3


def test_batch_mixture_matches_jax_and_checks():
    args = ((10.0, 3), (20.0, 5), (30.0, 2)), (0.5, 0.3, 0.2)
    want = JaxBatchMixture(tuple(_JaxStub(*a) for a in args[0]), args[1]).sample(jax.random.PRNGKey(0), 10, 4)
    mix = BatchMixture(tuple(_Stub(*a) for a in args[0]), args[1])
    got = mix.sample(10, 4, generator=torch.Generator())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert mix.num_features == 5 and mix.num_outputs == 1
    with pytest.raises(ValueError, match="num_outputs"):
        BatchMixture((_Stub(0.0, 1, 1), _Stub(0.0, 1, 2)), (1, 1))
    with pytest.raises(ValueError, match="align"):
        BatchMixture((_Stub(0.0, 1),), (1, 1))


def test_mlp_gp_mixture_of_tabular_eval():
    """experiments/tabular_eval.py --prior mlp_gp_mixture, at F 12: 80 % MLP
    datasets, 20 % binarized GP-mix datasets of 8 features zero-padded."""
    mlp = MLPPrior(num_features=12, is_binary_classification=True, categorical_x=True,
                   num_features_used=hyper.UniformInt(1, 13))
    gp = BinarizedPrior(base=GPMixPrior(num_features=8), num_outputs=1)
    mix = BatchMixture((mlp, gp), (0.8, 0.2))
    x, y, t = mix.sample(20, 30, generator=torch.Generator().manual_seed(0))
    assert x.shape == (20, 30, 12) and y.shape == (20, 30) and torch.equal(y, t)
    assert bool((x[16:, :, 8:] == 0).all()) and bool(torch.isfinite(x).all())
    assert set(y.unique().tolist()) == {0.0, 1.0}
