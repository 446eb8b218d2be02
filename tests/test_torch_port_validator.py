"""The port's MSE validator (``evals.make_mean_mse_validator``) against the
JAX package's, and inside ``train(validate_fn=...)``.

The JAX validator draws its batch from the JAX GP prior at PRNGKey(seed);
the test takes that batch and hands it to the port's scoring
(``evals.mean_mse``), with the weights carried across by
``state_dict_from_flax_params``: the random streams differ, the function of
a given batch must not. Tolerance: 1e-4 relative (two f32 layers of
summation-order differences, then a mean of squared errors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.evals import make_mean_mse_validator as jax_validator
from pfn_tpu.models.transformer import PFNTransformer as JaxPFN
from pfn_tpu.models.transformer import TransformerConfig as JaxConfig
from pfn_tpu.priors.gp import GPPrior as JaxGPPrior
from pfn_tpu.train import full_support_bar_criterion as jax_full_bar
from pfn_tpu_torch.distributions import get_bucket_limits
from pfn_tpu_torch.evals import draw_validation_batch, make_mean_mse_validator, mean_mse
from pfn_tpu_torch.models import PFNTransformer, TransformerConfig
from pfn_tpu_torch.priors import GPPrior
from pfn_tpu_torch.train import (
    TrainConfig,
    full_support_bar_criterion,
    seeded_flax_params,
    state_dict_from_flax_params,
    train,
)

HP = dict(noise=1e-4, outputscale=1.0, lengthscale=0.6)
EMSIZE, NHEAD, NHID, NLAYERS, BUCKETS = 64, 2, 128, 2, 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: its small CPU ops take as long
    alone, and they do not thrash against the OpenMP threads of the tests
    that other workers run at the same time (several minutes lost there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _borders():
    ys = np.random.default_rng(3).standard_normal(4000).astype(np.float32)
    return get_bucket_limits(BUCKETS, ys=ys)


def _port_model(params):
    model = PFNTransformer(TransformerConfig(num_features=1, n_out=BUCKETS, emsize=EMSIZE, nhead=NHEAD, nhid=NHID,
                                             nlayers=NLAYERS)).eval()
    model.load_state_dict(state_dict_from_flax_params(params, NLAYERS), strict=True)
    return model


@pytest.mark.parametrize("seq_len,batch_size,positions", [(50, 32, None), (40, 8, [3, 17, 39])])
def test_port_scoring_on_the_jax_batch_matches_the_jax_validator(seq_len, batch_size, positions):
    borders = _borders()
    params = seeded_flax_params(1, EMSIZE, NHID, NLAYERS, BUCKETS, seed=0)
    jprior = JaxGPPrior(num_features=1, **HP)
    jcrit = jax_full_bar(np.asarray(borders))
    jmodel = JaxPFN(JaxConfig(num_features=1, n_out=BUCKETS, emsize=EMSIZE, nhead=NHEAD, nhid=NHID,
                              nlayers=NLAYERS))
    want = jax_validator(jprior, jcrit, batch_size=batch_size, seq_len=seq_len, positions=positions, seed=4)(
        jmodel, jax.tree.map(jnp.asarray, params))
    # The JAX validator's own batch: its jitted draw at PRNGKey(seed).
    x, y, target_y = jax.jit(lambda k: jprior.sample(k, batch_size, seq_len))(jax.random.PRNGKey(4))
    got = mean_mse(_port_model(params), full_support_bar_criterion(borders),
                   *(torch.from_numpy(np.array(a)) for a in (x, y, target_y)), positions)
    assert got.shape == () and np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_validator_draws_its_batch_once_and_scores_it():
    """validate_fn(model) draws one batch from a generator seeded with
    ``seed`` on the model's device, and scores it with mean_mse."""
    borders = _borders()
    prior = GPPrior(num_features=1, **HP)
    calls = []

    class Counting:
        num_features, num_outputs = 1, 1

        def sample(self, *a, **k):
            calls.append(a)
            return prior.sample(*a, **k)

    criterion = full_support_bar_criterion(borders)
    model = _port_model(seeded_flax_params(1, EMSIZE, NHID, NLAYERS, BUCKETS, seed=1))
    validate_fn = make_mean_mse_validator(Counting(), criterion, batch_size=6, seq_len=30, seed=2)
    first, second = validate_fn(model), validate_fn(model)
    assert first == second and len(calls) == 1
    batch = draw_validation_batch(prior, 6, 30, seed=2)
    assert first == float(mean_mse(model, criterion, *batch))


def test_train_calls_the_validator():
    """train(validate_fn=...) scores the model every validation_period
    epochs on the CPU; the last score is the trained model's."""
    prior = GPPrior(num_features=1, **HP)
    criterion = full_support_bar_criterion(_borders())
    validate_fn = make_mean_mse_validator(prior, criterion, batch_size=8, seq_len=24, seed=0)
    cfg = TrainConfig(emsize=32, nhid=64, nlayers=2, nhead=2, epochs=4, steps_per_epoch=4, batch_size=8, bptt=24,
                      lr=3e-3, warmup_epochs=1, validation_period=2, device="cpu", verbose=False)
    result = train(prior, criterion, cfg, validate_fn=validate_fn)
    scores = [s["val_score"] for s in result.epoch_stats]
    assert scores[0] is None and scores[2] is None
    assert all(isinstance(s, float) and np.isfinite(s) for s in scores[1::2])
    assert scores[-1] == validate_fn(result.model)
