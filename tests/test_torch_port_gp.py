"""Parity of the port's GP samplers, GP posterior and exact-GP oracle with the
JAX package.

The JAX samplers draw their normals inside; the tests draw the same normals
with jax.random from the same keys, pass them to the port's
draws-to-(x, y) functions, and compare with the JAX samplers' outputs.

Tolerances (atol and rtol):
  * 1e-5 for the grid samplers: the same f32 FFT or matmul on both sides.
  * 1e-4 for the continuous sampler and the f32 posterior: the two packages'
    f32 Cholesky factors of kernel matrices with condition numbers up to
    ~1e4 differ in rounding.
  * 1e-8 for the f64 posterior and oracle against a numpy f64 solve.
  * Against the JAX package in x64 mode, f64 results agree only to ~3e-5:
    the reference's ``_sq_dists`` (pfn_tpu/ops/gp_sample.py:31-37) asks for
    ``preferred_element_type=float32``, so its "f64" kernel matrix carries an
    f32-rounded cross term. The port computes it in f64; these comparisons
    use 1e-3, and the numpy solve holds the port to f64 accuracy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.evals import oracles as joracles
from pfn_tpu.ops import gp_sample as jgp
from pfn_tpu.priors.gp import GPPrior as JaxGPPrior
from pfn_tpu_torch.evals import oracles as toracles
from pfn_tpu_torch.ops import gp_sample as tgp
from pfn_tpu_torch.priors import GPPrior, sample_y_for_buckets

HP = dict(noise=1e-4, outputscale=1.0, lengthscale=0.6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def test_continuous_sampler_same_normals_same_y():
    """GPPrior.sample (continuous x): x from the JAX draw, z the JAX normals."""
    B, T, F = 3, 60, 2
    prior = JaxGPPrior(num_features=F, noise=1e-3, outputscale=1.0, lengthscale=0.5)
    key = jax.random.PRNGKey(0)
    x, y, _ = prior.sample(key, B, T)
    k_x, k_y = jax.random.split(key)
    np.testing.assert_array_equal(np.asarray(x), np.asarray(jax.random.uniform(k_x, (B, T, F))))
    z = np.stack([np.asarray(jax.random.normal(k, (T,))) for k in jax.random.split(k_y, B)])
    got = tgp.gp_sample_paths_from_normals(_t(x), _t(z), 0.5, 1.0, 1e-3)
    _close(got, y, 1e-4)


@pytest.mark.parametrize("method", ["fft", "chol"])
def test_grid_sampler_same_normals_same_y(method):
    B, T, G = 3, 50, 64
    key = jax.random.PRNGKey(1)
    want_x, want_y = jgp.gp_sample_paths_grid(key, B, T, G, 0.6, 1.0, 1e-4, method=method)
    k_idx, k_f, k_n = jax.random.split(key, 3)
    idx = np.asarray(jax.random.randint(k_idx, (B, T), 0, G)).astype(np.int64)
    if method == "fft":
        ka, kb = jax.random.split(k_f)
        M = tgp._circulant_size(G)
        latent = tuple(_t(jax.random.normal(k, ((B + 1) // 2, M))) for k in (ka, kb))
    else:
        latent = _t(jax.random.normal(k_f, (B, G)))
    eps = _t(jax.random.normal(k_n, (B, T)))
    x, y = tgp.gp_sample_paths_grid_from_normals(_t(idx), latent, eps, G, 0.6, 1.0, 1e-4, method=method)
    np.testing.assert_array_equal(x.numpy(), np.asarray(want_x))
    _close(y, want_y, 1e-5)


def test_grid_constants_equal_exactly():
    """The host-f64 circulant spectrum and grid Cholesky factor, cast to f32,
    are bit-identical in both packages."""
    for G in (64, 100):
        g_j, lam_j, M_j = jgp._circulant_sqrt_eigs(G, 0.6, 1.0)
        g_t, lam_t, M_t = tgp._circulant_sqrt_eigs(G, 0.6, 1.0)
        assert M_t == M_j
        np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
        np.testing.assert_array_equal(lam_t.numpy(), np.asarray(lam_j))
    g_j, L_j = jgp._grid_factor(64, 0.6, 1.0)
    g_t, L_t = tgp._grid_factor(64, 0.6, 1.0)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    np.testing.assert_array_equal(L_t.numpy(), np.asarray(L_j))


def _spectrum_matrix(lam, seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((len(lam), len(lam))))
    return (q @ np.diag(lam) @ q.T).astype(np.float32)


def test_psd_safe_cholesky_ladder_judged_by_info():
    """One PD matrix, one that factors only at jitter 1e-4 (smallest
    eigenvalue -3e-5) and one beyond the ladder (-10). torch's cholesky_ex
    returns a FINITE partial factor on failure, so the port judges success
    by ``info``; both packages then agree, NaN factor included."""
    lam = np.linspace(0.1, 2.0, 20)
    A = np.stack([
        _spectrum_matrix(lam, 0),
        _spectrum_matrix(np.concatenate([[-3e-5], lam[1:]]), 1),
        _spectrum_matrix(np.concatenate([[-10.0], lam[1:]]), 2),
    ])
    L_partial, info = torch.linalg.cholesky_ex(_t(A[1]) + 1e-6 * torch.eye(20))
    assert int(info) > 0 and bool(torch.isfinite(L_partial).all())

    got = tgp.psd_safe_cholesky(_t(A))
    want = np.asarray(jgp.psd_safe_cholesky(jnp.asarray(A)))
    _close(got[:2], want[:2], 1e-4)
    lower = np.tril_indices(20)
    assert np.isnan(got[2].numpy()[lower]).all() and np.isnan(want[2][lower]).all()
    recon = got[1] @ got[1].T
    _close(recon, A[1] + 1e-4 * np.eye(20, dtype=np.float32), 1e-4)


def _np_posterior(xt, yt, xq, lengthscale, outputscale, noise, jitter=1e-6):
    """Exact GP posterior (mean, var incl. noise) by a numpy f64 solve."""
    xt, yt, xq = (np.asarray(a, np.float64) for a in (xt, yt, xq))

    def k(a, b):
        return outputscale * np.exp(-0.5 * ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1) / lengthscale**2)

    A = k(xt, xt) + (noise + jitter) * np.eye(len(xt))
    ks = k(xt, xq)
    mean = ks.T @ np.linalg.solve(A, yt)
    var = outputscale - np.einsum("nm,nm->m", ks, np.linalg.solve(A, ks))
    return mean, np.maximum(var, 0.0) + noise


def _posterior_inputs(seed, N=30, M=10):
    rng = np.random.default_rng(seed)
    xt = rng.uniform(size=(N, 1)).astype(np.float32)
    yt = np.sin(6 * xt[:, 0]).astype(np.float32) + 0.1 * rng.standard_normal(N).astype(np.float32)
    xq = rng.uniform(size=(M, 1)).astype(np.float32)
    mask = np.arange(N) < 17
    return xt, yt, xq, mask


@pytest.mark.parametrize("masked", [False, True])
def test_gp_posterior_matches_jax(masked):
    xt, yt, xq, mask = _posterior_inputs(3)
    kw = dict(lengthscale=0.3, outputscale=1.0, noise=1e-2)
    cm_j = jnp.asarray(mask) if masked else None
    cm_t = _t(mask) if masked else None
    want = jgp.gp_posterior(jnp.asarray(xt), jnp.asarray(yt), jnp.asarray(xq), context_mask=cm_j, **kw)
    got = tgp.gp_posterior(_t(xt), _t(yt), _t(xq), context_mask=cm_t, **kw)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)
    with jax.enable_x64(True):
        want = jgp.gp_posterior(jnp.asarray(xt, jnp.float64), jnp.asarray(yt, jnp.float64),
                                jnp.asarray(xq, jnp.float64), context_mask=cm_j, dtype=jnp.float64, **kw)
        want = [np.asarray(w) for w in want]
    got = tgp.gp_posterior(_t(xt), _t(yt), _t(xq), context_mask=cm_t, dtype=torch.float64, **kw)
    sub = mask if masked else slice(None)
    for g, w, exact in zip(got, want, _np_posterior(xt[sub], yt[sub], xq, **kw)):
        assert g.dtype == torch.float64
        _close(g, exact, 1e-8)
        _close(g, w, 1e-3)


def _oracle_data():
    x, y, _ = JaxGPPrior(num_features=1, **HP).sample(jax.random.PRNGKey(4), 2, 40)
    return np.asarray(x), np.asarray(y)


def test_exact_posterior_moments_f64_match_jax():
    x, y = _oracle_data()
    positions = [1, 5, 20, 39]
    with jax.enable_x64(True):
        want = joracles.gp_exact_posterior_moments(jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64), HP,
                                                   positions=jnp.asarray(positions), dtype=jnp.float64)
        want = [np.asarray(w) for w in want]
    got = toracles.gp_exact_posterior_moments(_t(x), _t(y), HP, positions=positions, dtype=torch.float64)
    exact = np.array([[_np_posterior(x[b, :t], y[b, :t], x[b, t : t + 1], HP["lengthscale"], HP["outputscale"],
                                     HP["noise"]) for b in range(2)] for t in positions])[..., 0]  # (P, B, 2)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (len(positions), 2) and g.dtype == torch.float64
        _close(g, exact[..., i], 1e-8)
        _close(g, w, 1e-3)


def test_exact_evaluate_matches_jax():
    x, y = _oracle_data()
    hp = dict(HP, noise=1e-2)
    losses_j, mean_j, _ = joracles.gp_exact_evaluate(jnp.asarray(x), jnp.asarray(y), hp, step_size=7)
    losses_t, mean_t, _ = toracles.gp_exact_evaluate(_t(x), _t(y), hp, step_size=7)
    _close(losses_t, losses_j, 1e-4)
    _close(mean_t, mean_j, 1e-4)
    assert float(mean_t[0]) == 0.0
    losses_j, mean_j, _ = joracles.gp_exact_evaluate(jnp.asarray(x), jnp.asarray(y), hp, use_mse=True,
                                                     positions=[3, 30])
    losses_t, mean_t, _ = toracles.gp_exact_evaluate(_t(x), _t(y), hp, use_mse=True, positions=[3, 30])
    _close(losses_t, losses_j, 1e-4)
    assert mean_t.shape == (2,)


def test_prior_draws_from_a_generator():
    """Seeded generators repeat; both sampler routes give finite (x, y) of
    the right shapes; the bucket sample has the requested size."""
    for prior in (GPPrior(num_features=1, grid=256, **HP), GPPrior(num_features=2, noise=1e-3)):
        a = prior.sample(4, 30, generator=torch.Generator().manual_seed(0))
        b = prior.sample(4, 30, generator=torch.Generator().manual_seed(0))
        assert a[0].shape == (4, 30, prior.num_features) and a[1].shape == (4, 30)
        assert bool(torch.isfinite(a[1]).all())
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u.numpy(), v.numpy())
    ys = sample_y_for_buckets(GPPrior(num_features=1, grid=256, **HP), 1000, 100, seed=7, max_seq_len=50)
    assert ys.shape == (1000,)
    np.testing.assert_array_equal(
        ys.numpy(), sample_y_for_buckets(GPPrior(num_features=1, grid=256, **HP), 1000, 100, seed=7,
                                         max_seq_len=50).numpy())
