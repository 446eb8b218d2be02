"""The port's Bayesian optimisation (``pfn_tpu_torch.bayesopt``) against the
JAX package's, on the CPU.

  * EI, PI and UCB on the same logits, both directions: 1e-6.
  * ``PFNOptimizer.scores`` against JAX's through the weight bridge (the
    same seeded weights in both models), the context padded and masked by
    ``num_obs``: 2e-5 x (1 + max), f32 through a model.
  * ``optimize`` given JAX's initial indices and a deterministic objective
    evaluates the same candidates in the same order as JAX's ``optimize``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu import bayesopt as jbo
from pfn_tpu.distributions import BarDistribution as JaxBar
from pfn_tpu.distributions import get_bucket_limits as jax_bucket_limits
from pfn_tpu.models.transformer import PFNTransformer as JaxPFN
from pfn_tpu.models.transformer import TransformerConfig as JaxConfig
from pfn_tpu_torch import bayesopt
from pfn_tpu_torch.distributions import BarDistribution, get_bucket_limits
from pfn_tpu_torch.models import PFNTransformer, TransformerConfig
from pfn_tpu_torch.train import seeded_flax_params, state_dict_from_flax_params

ACQ_TOL, SCORES_TOL = 1e-6, 2e-5
NUM_BARS = 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bars():
    return (JaxBar.create(jax_bucket_limits(NUM_BARS, full_range=(-2.0, 2.0))),
            BarDistribution(get_bucket_limits(NUM_BARS, full_range=(-2.0, 2.0))))


@pytest.fixture(scope="module")
def models():
    params = seeded_flax_params(1, 32, 64, 2, NUM_BARS, seed=3)
    cfg = dict(num_features=1, n_out=NUM_BARS, emsize=32, nhead=2, nhid=64, nlayers=2)
    jmodel = JaxPFN(JaxConfig(**cfg))
    model = PFNTransformer(TransformerConfig(**cfg)).eval()
    model.load_state_dict(state_dict_from_flax_params(params, 2), strict=True)
    return (jmodel, jax.tree.map(jnp.asarray, params)), model


def test_acquisitions_match_jax(bars):
    jbar, bar = bars
    logits = np.random.default_rng(0).normal(size=(7, NUM_BARS)).astype(np.float32) * 2
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    for maximize in (True, False):
        for best_f in (-0.7, 0.0, 1.3):
            for name in ("ei", "pi"):
                want = jbo.ACQUISITIONS[name](jbar, jl, best_f, maximize=maximize)
                got = bayesopt.ACQUISITIONS[name](bar, tl, best_f, maximize=maximize)
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ACQ_TOL, rtol=ACQ_TOL)
        want = jbo.upper_confidence_bound(jbar, jl, beta=1.5, maximize=maximize)
        got = bayesopt.upper_confidence_bound(bar, tl, beta=1.5, maximize=maximize)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ACQ_TOL, rtol=ACQ_TOL)
    ts = bayesopt.thompson_sample(bar, tl, torch.Generator().manual_seed(0))
    assert ts.shape == (7,) and bool(((ts >= -2.0) & (ts <= 2.0)).all())
    pi = bayesopt.probability_of_improvement(bar, tl, 0.0)
    assert bool(((pi >= 0) & (pi <= 1)).all())
    assert bool((bayesopt.expected_improvement(bar, tl, 0.0) >= 0).all())


@pytest.mark.parametrize("acquisition, maximize", [("ei", True), ("pi", True), ("ucb", True), ("ei", False),
                                                   ("ucb", False)])
def test_scores_match_jax(bars, models, acquisition, maximize):
    jbar, bar = bars
    (jmodel, jparams), model = models
    rng = np.random.default_rng(1)
    x_obs = rng.uniform(size=(6, 1)).astype(np.float32)
    y_obs = np.sin(5 * x_obs[:, 0]).astype(np.float32)
    cands = np.linspace(0, 1, 11, dtype=np.float32)[:, None]
    jopt = jbo.PFNOptimizer(jmodel, jparams, jbar, acquisition=acquisition, maximize=maximize, beta=1.5)
    opt = bayesopt.PFNOptimizer(model, bar, acquisition=acquisition, maximize=maximize, beta=1.5)
    for num_obs in (None, 4, torch.tensor([4])):
        want = np.asarray(jopt.scores(jnp.asarray(x_obs), jnp.asarray(y_obs), jnp.asarray(cands),
                                      num_obs=None if num_obs is None else 4))
        got = opt.scores(torch.from_numpy(x_obs), torch.from_numpy(y_obs), torch.from_numpy(cands), num_obs=num_obs)
        assert got.shape == (11,)
        tol = SCORES_TOL * (1 + float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    assert int(opt.propose(torch.from_numpy(x_obs), torch.from_numpy(y_obs), torch.from_numpy(cands), 4)) == int(
        jopt.propose(jnp.asarray(x_obs), jnp.asarray(y_obs), jnp.asarray(cands), 4))


def test_optimize_picks_the_jax_indices(bars, models):
    jbar, bar = bars
    (jmodel, jparams), model = models
    cands = np.linspace(0.0, 1.0, 17, dtype=np.float32)[:, None]
    table = np.exp(-30.0 * (cands[:, 0] - 0.73) ** 2) + 0.3 * np.sin(9 * cands[:, 0])

    def index(x) -> int:
        return int(np.abs(cands[:, 0] - float(x[0])).argmin())

    key = jax.random.PRNGKey(5)
    num_init, iters = 3, 6
    jx, jy = jbo.optimize(lambda x: float(table[index(x)]), jbo.PFNOptimizer(jmodel, jparams, jbar), jnp.asarray(cands),
                          num_iterations=iters, key=key, num_init=num_init)
    init_idx = np.asarray(jax.random.permutation(jax.random.split(key)[1], len(cands))[:num_init])
    x_obs, y_obs = bayesopt.optimize(lambda x: float(table[index(x)]), bayesopt.PFNOptimizer(model, bar),
                                     torch.from_numpy(cands), num_iterations=iters, num_init=num_init,
                                     init_idx=init_idx)
    assert x_obs.shape == (9, 1) and y_obs.shape == (9,)
    np.testing.assert_array_equal(x_obs.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y_obs.numpy(), np.asarray(jy))
    assert len({index(x) for x in x_obs.numpy()}) == 9  # never the same candidate twice


def test_optimize_draws_its_initial_points_and_checks_the_budget(bars, models):
    _, bar = bars
    _, model = models
    cands = torch.linspace(0, 1, 8)[:, None]
    g = torch.Generator().manual_seed(0)
    want = bayesopt.initial_indices(8, 2, torch.Generator().manual_seed(0))
    x_obs, _ = bayesopt.optimize(lambda x: float(x[0]), bayesopt.PFNOptimizer(model, bar), cands, 3, g, num_init=2)
    assert torch.equal(x_obs[:2], cands[want])
    with pytest.raises(ValueError, match="exceeds the candidate pool"):
        bayesopt.optimize(lambda x: 0.0, bayesopt.PFNOptimizer(model, bar), cands, 7, g, num_init=2)
