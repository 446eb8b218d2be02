"""The GP-mix oracles of the port (``pfn_tpu_torch.evals.gp_mix_oracles``)
against the JAX package's, on the CPU.

  * The marginal likelihood: masked equal to the submatrix's, 1e-5
    relative, and against JAX's (plain and masked, batched over datasets),
    1e-5 relative.
  * The Gamma hyperprior against JAX's (``torch.lgamma`` against
    ``gammaln``), 1e-6.
  * ``gp_map_fit`` and ``gp_map_evaluate`` (150 Adam steps, lr 0.05, the
    port's elementwise Adam against optax's) on the same data: the swept
    NLLs within 1e-4 relative, the fitted hyperparameters within 1e-3. The
    f32 Cholesky factors of LAPACK and XLA differ: at JAX's test dataset's
    fit (noise 0.02, lengthscale 0.3) the log posterior differs by 2e-5
    relative and its gradient by up to 6e-5, and 150 Adam steps carry that
    into the hyperparameters (2.0e-4 relative on the outputscale, measured).
    The port scores the posterior predictive in f64, a deviation named in
    the module (the JAX functions score in f32, whose predictive variance
    cancels for a draw of tiny noise); here it holds to JAX's f32 scores.
  * The port's marginal likelihood runs in f64, a deviation named in the
    module: at the tiny lengthscales some MAP fits reach (0.003-0.004, with
    outputscale 124) it holds a numpy f64 likelihood on exact pairwise
    differences to ``F64_MLL_TOL`` 1e-6 relative, where the JAX function's
    f32 squared distances cancel and leave it more than 1e-4 off.
  * ``gp_hyper_mcmc_predictive``: tests/test_torch_port_gp_mix_mcmc.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.evals import gp_mix_oracles as J
from pfn_tpu.ops.gp_sample import gp_sample_paths as jax_gp_sample_paths
from pfn_tpu.ops.gp_sample import matern52_kernel as jax_matern52
from pfn_tpu.priors.gp_mix import GPMixPrior as JaxGPMixPrior
from pfn_tpu_torch.evals import gp_mix_oracles as P
from pfn_tpu_torch.priors import GPMixPrior

MLL_TOL, HYPERPRIOR_TOL, MAP_NLL_TOL, MAP_HP_TOL = 1e-5, 1e-6, 1e-4, 1e-3
F64_MLL_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small CPU ops, beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset():
    """JAX's test dataset: one GP draw with known hyperparameters."""
    k_x, k_y = jax.random.split(jax.random.PRNGKey(0))
    x = jax.random.uniform(k_x, (1, 40, 1))
    y = jax_gp_sample_paths(k_y, x, lengthscale=0.3, outputscale=1.0, noise=0.01, kernel=jax_matern52)
    return np.asarray(x[0]), np.asarray(y[0])


@pytest.fixture(scope="module")
def batch():
    """Three datasets of 20 points with 2 features."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(3, 20, 2)).astype(np.float32)
    y = (np.sin(6 * x[..., 0]) * np.cos(3 * x[..., 1]) + 0.1 * rng.normal(size=(3, 20))).astype(np.float32)
    return x, y


def _t(a):
    return torch.from_numpy(np.array(a))


def test_mll_masked_equals_submatrix_and_jax(dataset, batch):
    x, y = dataset
    t = 17
    mask = np.arange(x.shape[0]) < t
    full = P.gp_marginal_log_likelihood(_t(x[:t]), _t(y[:t]), 0.05, torch.tensor([0.4]), 1.2)
    masked = P.gp_marginal_log_likelihood(_t(x), _t(y), 0.05, torch.tensor([0.4]), 1.2, context_mask=_t(mask))
    np.testing.assert_allclose(float(masked), float(full), rtol=MLL_TOL)
    want = J.gp_marginal_log_likelihood(jnp.asarray(x), jnp.asarray(y), 0.05, jnp.asarray([0.4]), 1.2,
                                        context_mask=jnp.asarray(mask))
    np.testing.assert_allclose(float(masked), float(want), rtol=MLL_TOL)

    # Batched over datasets, each its own hyperparameters, plain and masked.
    bx, by = batch
    noise, os_ = np.array([0.01, 0.1, 0.5]), np.array([1.0, 2.0, 0.5])
    ls = np.array([[0.3, 0.7], [1.0, 0.2], [0.5, 0.5]])
    bmask = np.arange(20)[None, :] < np.array([[5], [12], [20]])
    for m in (None, bmask):
        got = P.gp_marginal_log_likelihood(_t(bx), _t(by), _t(noise).float(), _t(ls).float(), _t(os_).float(),
                                           context_mask=None if m is None else _t(m))
        want = [J.gp_marginal_log_likelihood(jnp.asarray(bx[i]), jnp.asarray(by[i]), float(noise[i]),
                                             jnp.asarray(ls[i], jnp.float32), float(os_[i]),
                                             context_mask=None if m is None else jnp.asarray(m[i]))
                for i in range(3)]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MLL_TOL)


def _numpy_matern52_mll(x, y, ls, os_, noise, jitter=1e-6):
    """log N(y; 0, K + (noise + jitter) I) in f64 on exact pairwise
    differences of one feature."""
    r = np.abs(x[:, None, 0] - x[None, :, 0]) / ls
    K = os_ * (1 + np.sqrt(5) * r + 5 / 3 * r * r) * np.exp(-np.sqrt(5) * r)
    A = K + (noise + jitter) * np.eye(len(x))
    logdet = 2 * np.log(np.diag(np.linalg.cholesky(A))).sum()
    return -0.5 * (y @ np.linalg.solve(A, y) + logdet + len(x) * np.log(2 * np.pi))


@pytest.mark.parametrize("lengthscale", [0.004, 0.003])
def test_mll_at_tiny_lengthscale_is_f64_accurate(lengthscale):
    rng = np.random.RandomState(0)
    x, y = rng.rand(97, 1).astype(np.float32), rng.randn(97).astype(np.float32)
    os_, noise = 124.0, 0.4
    want = _numpy_matern52_mll(x.astype(np.float64), y.astype(np.float64), lengthscale, os_, noise)
    got = float(P.gp_marginal_log_likelihood(_t(x), _t(y), noise, torch.tensor([lengthscale]), os_))
    np.testing.assert_allclose(got, want, rtol=F64_MLL_TOL)
    jax_f32 = float(J.gp_marginal_log_likelihood(jnp.asarray(x), jnp.asarray(y), noise, jnp.asarray([lengthscale]),
                                                 os_))
    assert abs(jax_f32 - want) > 1e-4 * abs(want)  # the cancellation the f64 algebra removes


def test_hyperprior_matches_jax():
    jp, tp = JaxGPMixPrior(num_features=2), GPMixPrior(num_features=2)
    for noise, ls, os_ in ((0.02, [0.5, 0.3], 1.0), (50.0, [50.0, 0.01], 50.0), (1e-3, [2.0, 4.0], 0.1)):
        want = J.log_hyperprior({"noise": jnp.asarray(noise), "lengthscale": jnp.asarray(ls),
                                 "outputscale": jnp.asarray(os_)}, jp)
        got = P.log_hyperprior({"noise": torch.tensor(noise), "lengthscale": torch.tensor(ls),
                                "outputscale": torch.tensor(os_)}, tp)
        np.testing.assert_allclose(float(got), float(want), rtol=HYPERPRIOR_TOL, atol=HYPERPRIOR_TOL)
    mid = P.log_hyperprior({"noise": torch.tensor(0.02), "lengthscale": torch.tensor([0.5, 0.5]),
                            "outputscale": torch.tensor(1.0)}, tp)
    far = P.log_hyperprior({"noise": torch.tensor(50.0), "lengthscale": torch.tensor([50.0, 50.0]),
                            "outputscale": torch.tensor(50.0)}, tp)
    assert float(mid) > float(far)


def test_map_fit_matches_jax(dataset, batch):
    x, y = dataset
    jp, tp = JaxGPMixPrior(num_features=1), GPMixPrior(num_features=1)
    mask = np.arange(40) < 25
    want = jax.jit(lambda: J.gp_map_fit(jnp.asarray(x), jnp.asarray(y), jp, context_mask=jnp.asarray(mask)))()
    got = P.gp_map_fit(_t(x)[None], _t(y)[None], tp, context_mask=_t(mask))
    for k in ("noise", "lengthscale", "outputscale"):
        np.testing.assert_allclose(got[k][0].numpy(), np.asarray(want[k]), rtol=MAP_HP_TOL)
    # Generated with lengthscale 0.3, outputscale 1, noise 0.01: in range (JAX's test).
    hp = P.gp_map_fit(_t(x)[None], _t(y)[None], tp, steps=250)
    assert 0.1 < float(hp["lengthscale"][0, 0]) < 1.0 and float(hp["noise"][0]) < 0.2
    assert 0.2 < float(hp["outputscale"][0]) < 5.0


def test_map_evaluate_matches_jax(batch):
    x, y = batch
    jp, tp = JaxGPMixPrior(num_features=2), GPMixPrior(num_features=2)
    positions = [2, 7, 15, 19]
    want_all, want_mean = J.gp_map_evaluate(jnp.asarray(x), jnp.asarray(y), jp, positions=jnp.asarray(positions))
    got_all, got_mean = P.gp_map_evaluate(_t(x), _t(y), tp, positions=positions)
    assert got_all.shape == (4, 3) and got_mean.shape == (4,) and got_all.dtype == torch.float32
    np.testing.assert_allclose(got_all.numpy(), np.asarray(want_all), rtol=MAP_NLL_TOL, atol=MAP_NLL_TOL)
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(want_mean), rtol=MAP_NLL_TOL, atol=MAP_NLL_TOL)
