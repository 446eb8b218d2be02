"""Parity of the port's linear-regression oracles (``ridge_evaluate``,
``bayes_linreg_posterior``) with the JAX package and with numpy float64.

Inputs are numpy draws from a seed. Tolerances (relative unless stated):
  * 1e-8 against a numpy f64 solve, one (t, dataset) at a time: the port
    computes in f64 by default. Where the centred design has rank < F
    (ridge with alpha = 0 at t <= F), the 1e-9 diagonal of the JAX package
    regularises a singular system and rounding at 1e-16 of the sums enters
    divided by 1e-9: those context sizes are held at 1e-6.
  * 5e-4 against the JAX functions, which compute in f32: the centred sums
    cancel over up to 40 rows in f32 (measured up to 9e-5).
  * At alpha = 0 and t <= F the JAX f32 solve returns NaN (the 1e-9 is lost
    against the f32 rounding of a singular matrix); the port's f64 default
    stays finite there. At t = F + 1 the centred design has just rank F and
    the f32 solve loses digits with its condition number (0.5 % measured).
    Those context sizes are compared with numpy only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.evals import oracles as joracles
from pfn_tpu_torch.evals import bayes_linreg_posterior, oracles, ridge_evaluate

B, T = 6, 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: its small CPU ops take as long
    alone, and they do not thrash against the OpenMP threads of the tests
    that other workers run at the same time (several minutes lost there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ridge_data(F, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    y_clean = (x @ rng.standard_normal(F)).astype(np.float32)
    y = (y_clean + 0.1 * rng.standard_normal((B, T))).astype(np.float32)
    return x, y, y_clean


def _ridge_numpy(x, y, y_clean, alpha):
    """sklearn-style ridge with an intercept, one f64 solve per (t, dataset)."""
    x, y, y_clean = (a.astype(np.float64) for a in (x, y, y_clean))
    F = x.shape[-1]
    losses = [0.0]
    for t in range(1, x.shape[1]):
        se = []
        for b in range(x.shape[0]):
            xm, ym = x[b, :t].mean(0), y[b, :t].mean()
            xc, yc = x[b, :t] - xm, y[b, :t] - ym
            w = np.linalg.solve(xc.T @ xc + (alpha + 1e-9) * np.eye(F), xc.T @ yc)
            se.append(((x[b, t] - xm) @ w + ym - y_clean[b, t]) ** 2)
        losses.append(np.mean(se))
    return np.asarray(losses)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("F,alpha", [(1, 0.0), (3, 0.0), (3, 0.5)])
def test_ridge_evaluate_matches_numpy_f64(F, alpha, monkeypatch):
    x, y, y_clean = _ridge_data(F, seed=F)
    monkeypatch.setattr(oracles, "_RIDGE_CHUNK_ELEMS", 7 * B * T * F)  # 6 chunks of 7 context sizes
    losses, seconds = ridge_evaluate(*_torch(x, y, y_clean), alpha=alpha)
    want = _ridge_numpy(x, y, y_clean, alpha)
    assert losses.dtype == torch.float64 and losses.shape == (T,) and seconds >= 0.0
    assert float(losses[0]) == 0.0 and bool(torch.isfinite(losses).all())
    rank_deficient = F + 1 if alpha == 0.0 and F > 1 else 1
    np.testing.assert_allclose(losses.numpy()[rank_deficient:], want[rank_deficient:], rtol=1e-8, atol=0)
    np.testing.assert_allclose(losses.numpy()[:rank_deficient], want[:rank_deficient], rtol=1e-6, atol=0)


@pytest.mark.parametrize("F,alpha", [(1, 0.0), (3, 0.0), (3, 0.5)])
def test_ridge_evaluate_matches_jax(F, alpha):
    x, y, y_clean = _ridge_data(F, seed=10 + F)
    want, _ = joracles.ridge_evaluate(jnp.asarray(x), jnp.asarray(y), jnp.asarray(y_clean), alpha=alpha)
    want = np.asarray(want)
    got, _ = ridge_evaluate(*_torch(x, y, y_clean), alpha=alpha)
    start = F + 2 if alpha == 0.0 and F > 1 else 0
    if start:
        assert np.isnan(want[2:start - 1]).any() and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy()[start:], want[start:], rtol=5e-4, atol=1e-7)


def test_ridge_evaluate_chunks_do_not_change_the_result(monkeypatch):
    x, y, y_clean = _ridge_data(2, seed=5)
    one, _ = ridge_evaluate(*_torch(x, y, y_clean), alpha=0.1)
    monkeypatch.setattr(oracles, "_RIDGE_CHUNK_ELEMS", 1)  # one context size a chunk
    many, _ = ridge_evaluate(*_torch(x, y, y_clean), alpha=0.1)
    np.testing.assert_allclose(many.numpy(), one.numpy(), rtol=1e-12, atol=0)


def _bayes_numpy(xt, yt, xq, weight_std, noise_std, mask):
    xt, yt, xq = (a.astype(np.float64) for a in (xt, yt, xq))
    xt, yt = xt[mask], yt[mask]
    A = xt.T @ xt / noise_std**2 + np.eye(xt.shape[1]) / weight_std**2
    Sigma = np.linalg.inv(A)
    mu = Sigma @ xt.T @ yt / noise_std**2
    return xq @ mu, np.einsum("qf,fg,qg->q", xq, Sigma, xq) + noise_std**2


def _bayes_data(seed, N=30, Q=7, F=4):
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal((N, F)).astype(np.float32)
    w = rng.standard_normal(F) * 1.5
    yt = (xt @ w + 0.3 * rng.standard_normal(N)).astype(np.float32)
    return xt, yt, rng.standard_normal((Q, F)).astype(np.float32)


@pytest.mark.parametrize("n_ctx", [0, 1, 17, 30])
def test_bayes_linreg_posterior_matches_numpy_and_jax(n_ctx):
    xt, yt, xq = _bayes_data(seed=n_ctx)
    mask = np.arange(xt.shape[0]) < n_ctx
    want_mean, want_var = _bayes_numpy(xt, yt, xq, 1.5, 0.3, mask)
    mean, var = bayes_linreg_posterior(*_torch(xt, yt, xq), 1.5, 0.3, torch.from_numpy(mask))
    assert mean.dtype == var.dtype == torch.float64 and mean.shape == var.shape == (xq.shape[0],)
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(var.numpy(), want_var, rtol=1e-8, atol=0)

    jm, jv = joracles.bayes_linreg_posterior(jnp.asarray(xt), jnp.asarray(yt), jnp.asarray(xq), 1.5, 0.3,
                                             jnp.asarray(mask))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(jv), rtol=5e-4, atol=0)
    # Without a mask the whole training set conditions.
    if n_ctx == xt.shape[0]:
        full = bayes_linreg_posterior(*_torch(xt, yt, xq), 1.5, 0.3)
        np.testing.assert_allclose(full[0].numpy(), mean.numpy(), rtol=1e-12, atol=0)


def test_bayes_linreg_posterior_batches_datasets():
    """Leading axes are a batch of datasets: each equals its own call, with
    a per-dataset context mask."""
    data = [_bayes_data(seed=20 + i) for i in range(3)]
    xt, yt, xq = (np.stack(a) for a in zip(*data))
    masks = np.arange(xt.shape[1])[None, :] < np.array([[5], [12], [30]])
    mean, var = bayes_linreg_posterior(*_torch(xt, yt, xq), 0.7, 0.2, torch.from_numpy(masks))
    assert mean.shape == var.shape == (3, xq.shape[1])
    for i in range(3):
        want = _bayes_numpy(xt[i], yt[i], xq[i], 0.7, 0.2, masks[i])
        np.testing.assert_allclose(mean[i].numpy(), want[0], rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(var[i].numpy(), want[1], rtol=1e-8, atol=0)
