"""The GP-mix hyper-MCMC oracle of the port
(``pfn_tpu_torch.evals.gp_mix_oracles.gp_hyper_mcmc_predictive``) against
the JAX package's, on the CPU.

Statistical, since the random streams differ and the port's HMC keeps the
log density of the point it stands on (a deviation that evals/inference.py
names). On JAX's test dataset (40 points, 30 in context, 32 draws after 64
of warm-up), the port's mean query NLL over 4 chains lies within 0.15 nats
of one JAX chain. Measured at 48 draws after 96 over seeds 0-2: JAX -0.547,
-0.492, -0.506; the port -0.499, -0.496, -0.439 alone and -0.526, -0.458,
-0.531, -0.443 as 4 batched chains. Both beat fixed bad hyperparameters
(JAX's test_hyper_mcmc_predictive_beats_bad_hypers) and accept between 5 %
and 100 % of the trajectories. The port scores each draw's predictive in
f64 (a deviation named in the module); the JAX function in f32.
"""

import math

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
from pfn_tpu_torch.ops.gp_sample import gp_posterior
from pfn_tpu_torch.priors import GPMixPrior

MCMC_NLL_TOL = 0.15


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


def _t(a):
    return torch.from_numpy(np.array(a))


def test_hyper_mcmc_predictive_beats_bad_hypers_and_matches_jax(dataset):
    x, y = dataset
    t = 30
    mask = np.arange(40) < t
    jnll, jaccept = J.gp_hyper_mcmc_predictive(jnp.asarray(x), jnp.asarray(y), jnp.asarray(x), jnp.asarray(y),
                                               JaxGPMixPrior(num_features=1), jax.random.PRNGKey(1), num_samples=32,
                                               num_warmup=64, context_mask=jnp.asarray(mask))
    chains = 4
    xb, yb = _t(x)[None].expand(chains, 40, 1), _t(y)[None].expand(chains, 40)
    nll, accept = P.gp_hyper_mcmc_predictive(xb, yb, xb, yb, GPMixPrior(num_features=1),
                                             torch.Generator().manual_seed(1), num_samples=32, num_warmup=64,
                                             context_mask=_t(mask))
    assert nll.shape == (chains, 40) and accept.shape == (chains,)
    assert bool(((accept > 0.05) & (accept <= 1.0)).all())
    query_nll = nll[:, t:].mean(dim=1)
    assert bool(torch.isfinite(query_nll).all())
    assert abs(float(query_nll.mean()) - float(jnll[t:].mean())) < MCMC_NLL_TOL, (query_nll, float(jnll[t:].mean()))
    assert 0.05 < float(jaccept) <= 1.0

    # A fixed wrong-hyperparameter GP predictive is worse.
    mean, var = gp_posterior(_t(x), _t(y), _t(x), lengthscale=5.0, outputscale=0.01, noise=1.0,
                             kernel=P.matern52_kernel, context_mask=_t(mask))
    bad = 0.5 * (math.log(2 * math.pi) + torch.log(var) + (_t(y) - mean) ** 2 / var)
    assert bool((query_nll < bad[t:].mean()).all())
