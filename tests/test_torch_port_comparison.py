"""The Bayesian-comparison harness of the port (``pfn_tpu_torch.evals.comparison``)
against the JAX package's, on the CPU.

  * The BNN's ``logits`` and ``log_joint`` on the same numpy weights, alone
    and batched over datasets: 1e-6 relative (f32 sums in two libraries).
  * ``_evaluate_pred_samples``, per dataset and batched: the accuracy
    exactly, the NLL to 1e-6 relative (XLA's f32 ``log`` differs from
    torch's in the last bit for ~14 % of inputs, and XLA sums in order).
  * ``eval_transformer`` against the JAX one at emsize 64, 2 layers, 4
    heads, T 60, the same weights through the weight bridge: the
    probabilities at 1e-5 (two f32 layers of summation order), the
    accuracies equal, the NLLs at 1e-5.
  * (``eval_svi`` and ``eval_mcmc``: ``test_torch_port_comparison_fits.py``.)
  * The sweeps' cache files: the same names (content hash included), and a
    cache the JAX sweep wrote (its fits stood in for) reads back in the
    port's sweep;
    ``compute_mean_and_conf_interval`` equal.
  * ``as_prior`` and ``generate_toy_data``: shapes, labels, the seeded
    eval set repeating.
  * ``num_classes``: 2 draws the labels as before; C classes draw each by
    its probability; the cache tag tells them apart.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.evals import comparison as jcmp
from pfn_tpu.models.transformer import PFNTransformer as JaxPFN
from pfn_tpu.models.transformer import TransformerConfig as JaxConfig
from pfn_tpu_torch.evals import comparison
from pfn_tpu_torch.models import PFNTransformer, TransformerConfig
from pfn_tpu_torch.train import seeded_flax_params, state_dict_from_flax_params

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


def _weights(rng, batch=()):
    return {k: rng.standard_normal((*batch, *s)).astype(np.float32) for k, s in SPEC.shapes().items()}


@pytest.mark.parametrize("batch", [(), (4,)])
def test_logits_and_log_joint_match_jax(batch):
    rng = np.random.default_rng(0)
    w = _weights(rng, batch)
    x = rng.standard_normal((*batch, 40, 3)).astype(np.float32)
    y = (rng.random((*batch, 40)) < 0.5).astype(np.float32)
    tw = {k: torch.as_tensor(v) for k, v in w.items()}
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    logits = comparison.BayesianNNModel(3, 5).logits(tw, torch.as_tensor(x)).numpy()
    lj = SPEC.log_joint(tw, torch.as_tensor(x), torch.as_tensor(y)).numpy()
    if batch:
        want_logits = np.asarray(jax.vmap(JSPEC.logits)(jw, jnp.asarray(x)))
        want_lj = np.asarray(jax.vmap(JSPEC.log_joint)(jw, jnp.asarray(x), jnp.asarray(y)))
    else:
        want_logits = np.asarray(JSPEC.logits(jw, jnp.asarray(x)))
        want_lj = np.asarray(JSPEC.log_joint(jw, jnp.asarray(x), jnp.asarray(y)))
    assert logits.shape == want_logits.shape and lj.shape == want_lj.shape == batch
    np.testing.assert_allclose(logits, want_logits, rtol=1e-6, atol=1e-6 * np.abs(want_logits).max())
    np.testing.assert_allclose(lj, want_lj, rtol=1e-6)


def test_evaluate_pred_samples_matches_jax():
    rng = np.random.default_rng(1)
    obs = (rng.random((32, 3, 12)) < 0.6).astype(np.float32)
    y = (rng.random((3, 12)) < 0.5).astype(np.float32)
    acc, nll = comparison._evaluate_pred_samples(torch.as_tensor(obs), torch.as_tensor(y))
    for b in range(3):
        want_acc, want_nll = jcmp._evaluate_pred_samples(jnp.asarray(obs[:, b]), jnp.asarray(y[b]))
        one_acc, one_nll = comparison._evaluate_pred_samples(torch.as_tensor(obs[:, b]), torch.as_tensor(y[b]))
        assert float(acc[b]) == float(one_acc) == float(want_acc)
        assert float(nll[b]) == float(one_nll)
        np.testing.assert_allclose(float(nll[b]), float(want_nll), rtol=1e-6)


def test_eval_transformer_matches_jax(toy):
    X, y = toy[0][:, :60], toy[1][:, :60]
    n = 25
    params = seeded_flax_params(3, 64, 128, 2, 1, seed=0)
    jmodel = JaxPFN(JaxConfig(num_features=3, n_out=1, emsize=64, nhead=4, nhid=128, nlayers=2))
    jparams = jax.tree.map(jnp.asarray, params)
    model = PFNTransformer(TransformerConfig(num_features=3, n_out=1, emsize=64, nhead=4, nhid=128,
                                             nlayers=2)).eval()
    model.load_state_dict(state_dict_from_flax_params(params, 2), strict=True)

    want_acc, want_nll, _ = jcmp.eval_transformer(X, y, jmodel, jparams, n)
    # The JAX function's probabilities, as it computes them.
    mean, std = X[:, :n].mean(1, keepdims=True), X[:, :n].std(1, keepdims=True) + 1e-6
    y_ctx = np.where(np.arange(60)[None] < n, y, 0.0)
    want_probs = np.asarray(jax.nn.sigmoid(jmodel.apply(jparams, jnp.asarray((X - mean) / std), jnp.asarray(y_ctx),
                                                        n)[..., 0]))[:, n:]
    probs, seconds = comparison.transformer_probs(X, y, model, n)
    np.testing.assert_allclose(probs.numpy(), want_probs, atol=1e-5, rtol=1e-5)
    acc, nll, elapsed = comparison.eval_transformer(X, y, model, n)
    assert acc.shape == nll.shape == (16,) and seconds >= 0 and elapsed >= 0
    np.testing.assert_array_equal(acc, want_acc)
    np.testing.assert_allclose(nll, want_nll, atol=1e-5, rtol=1e-5)


def test_sweep_caches_are_shared_with_jax(toy, tmp_path, monkeypatch):
    X, y = toy[0][:3, :30], toy[1][:3, :30]
    assert comparison._sweep_cache_tag(X, y, SPEC, 20) == jcmp._sweep_cache_tag(X, y, JSPEC, 20)
    # The JAX sweep's file names and caching are under test, not its fits
    # (an XLA compile each): a stand-in fit of the JAX signature.
    rng = np.random.default_rng(3)
    monkeypatch.setattr(jcmp, "eval_svi", lambda X, y, model, n, steps, samples: (rng.random(len(X)),
                                                                                rng.random(len(X))))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jcmp.training_steps_sweep("svi", X, y, JSPEC, jdir, steps_grid=(2,), training_samples_n=20)
    comparison.training_steps_sweep("svi", X, y, SPEC, pdir, steps_grid=(2,), training_samples_n=20)
    want_n = jcmp.training_samples_sweep("svi", X, y, JSPEC, [5], jdir, steps=2)
    comparison.training_samples_sweep("svi", X, y, SPEC, [5], pdir, steps=2)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir)) and len(os.listdir(jdir)) == 2
    # The JAX sweeps' caches, read by the port's sweeps.
    got = comparison.training_steps_sweep("svi", X, y, SPEC, jdir, steps_grid=(2,), training_samples_n=20)
    got_n = comparison.training_samples_sweep("svi", X, y, SPEC, [5], jdir, steps=2)
    for a, b in ((got[2], want[2]), (got_n[5], want_n[5])):
        assert len(a) == len(b) and all(np.array_equal(u, v) for u, v in zip(a, b))
    assert comparison.default_evaluation_points() == jcmp.default_evaluation_points()


def test_conf_interval_matches_jax():
    values = np.random.default_rng(2).standard_normal(17)
    assert comparison.compute_mean_and_conf_interval(values) == jcmp.compute_mean_and_conf_interval(values)
    assert comparison.compute_mean_and_conf_interval(values, 0.9) == jcmp.compute_mean_and_conf_interval(values, 0.9)


def test_prior_and_toy_data():
    prior = SPEC.as_prior(batch_size_per_model=4)
    x, y, target = prior.sample(8, 30, generator=torch.Generator().manual_seed(0))
    assert x.shape == (8, 30, 3) and y.shape == (8, 30) and torch.equal(y, target)
    assert set(y.unique().tolist()) <= {0.0, 1.0}
    torch.testing.assert_close(x.mean(1), torch.zeros(8, 3), atol=1e-5, rtol=0)  # z-scored per dataset
    X, Y = comparison.generate_toy_data(SPEC, 40, torch.Generator().manual_seed(0), n_samples=5)
    X2, _ = comparison.generate_toy_data(SPEC, 40, torch.Generator().manual_seed(0), n_samples=5)
    assert X.shape == (5, 40, 3) and Y.shape == (5, 40) and torch.equal(X, X2)


def test_two_classes_draw_as_the_reference_does():
    """The default 2-class BNN labels a row 1 where its uniform lies below
    p_1, the uniforms drawn after x, as before ``num_classes`` existed."""
    params = SPEC.sample_params(torch.Generator().manual_seed(4), (3,))
    params = {k: v.unsqueeze(1) for k, v in params.items()}
    x, y = SPEC._draw_data(torch.Generator().manual_seed(5), params, (3, 2, 50, 3))
    g = torch.Generator().manual_seed(5)
    x0 = torch.randn((3, 2, 50, 3), generator=g)
    p1 = torch.softmax(SPEC.logits(params, x0), dim=-1)[..., 1]
    assert torch.equal(x, x0) and torch.equal(y, (torch.rand(p1.shape, generator=g) < p1).float())


def test_c_classes_draw_each_label_by_its_probability():
    """With zero weights and biases log p, every row's label is a draw of
    Cat(p): over 200 000 rows each class's share lies within 5 standard
    errors of p_c, and the cache tag tells the model from the 2-class one."""
    model = comparison.BayesianNNModel(num_features=3, embed=4, num_classes=5)
    assert model.shapes()["w2"] == (4, 5) and model.shapes()["b2"] == (5,)
    probs = torch.tensor([0.05, 0.1, 0.2, 0.25, 0.4])
    params = {"w1": torch.zeros(3, 4), "b1": torch.zeros(4), "w2": torch.zeros(4, 5), "b2": probs.log()}
    _, y = model._draw_data(torch.Generator().manual_seed(6), params, (200_000, 3))
    share = torch.bincount(y.long(), minlength=5).double() / y.numel()
    se = (probs.double() * (1 - probs.double()) / y.numel()).sqrt()
    assert bool(((share - probs.double()).abs() < 5 * se).all()), share
    X, Y = np.zeros((1, 4, 3), np.float32), np.zeros((1, 4), np.float32)
    two = comparison.BayesianNNModel(num_features=3, embed=4)
    assert comparison._sweep_cache_tag(X, Y, model, 1) != comparison._sweep_cache_tag(X, Y, two, 1)
