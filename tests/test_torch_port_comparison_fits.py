"""The port's batched SVI and HMC fits of the Bayesian comparison
(``pfn_tpu_torch.evals.comparison.eval_svi`` / ``eval_mcmc``) against the
JAX package's, on the CPU.

On the JAX package's toy data (16 datasets of 100 rows, 60 in context; SVI
300 steps and 200 draws, HMC 200 + 200): the mean accuracy within 0.05 of
the JAX functions'. The random streams differ (Philox against threefry), so
only the quality is compared. Measured over seeds 0-2: |port - JAX| of the
mean accuracy 0.022, 0.005, 0.002 for SVI and 0.005, 0.011, 0.003 for HMC.
"""

import numpy as np
import pytest
import torch

from pfn_tpu.evals import comparison as jcmp
from pfn_tpu_torch.evals import comparison

SPEC = comparison.default_model_spec("small")
JSPEC = jcmp.default_model_spec("small")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def toy():
    X, y = jcmp.generate_toy_data(JSPEC, 100, n_samples=16, seed=0)
    return np.array(X), np.array(y)


def test_eval_svi_quality_matches_jax(toy):
    X, y = toy
    want_nll, want_acc = jcmp.eval_svi(X, y, JSPEC, 60, 300, 200)
    nll, acc = comparison.eval_svi(X, y, SPEC, 60, 300, 200)
    assert nll.shape == acc.shape == (16,) and np.isfinite(nll).all()
    assert abs(acc.mean() - want_acc.mean()) < 0.05
    assert acc.mean() > 0.55 and nll.mean() < 0.69


def test_eval_mcmc_quality_matches_jax(toy):
    X, y = toy
    want_nll, want_acc = jcmp.eval_mcmc(X, y, JSPEC, 60, 200, 200)
    nll, acc, accept = comparison._mcmc_scores(X, y, SPEC, 60, 200, 200)
    assert nll.shape == acc.shape == accept.shape == (16,) and np.isfinite(nll).all()
    assert abs(acc.mean() - want_acc.mean()) < 0.05
    assert ((accept > 0.3) & (accept <= 1.0)).all()
    assert np.array_equal(comparison.eval_mcmc(X[:2], y[:2], SPEC, 60, 4, 4)[1].shape, (2,))
