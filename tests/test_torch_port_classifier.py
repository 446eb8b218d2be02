"""The tabular classification slice end to end, JAX package against the port:
``PFNClassifier`` (BCE and CE heads), ``evaluate_position_pfn`` with
ensembling, the ROC-AUC, and ``train()`` on the MLP prior with a bitwise
resume.

A tiny model (4 features, emsize 32, 2 heads, nhid 64, 2 layers) carries the
same seeded weights on both sides through the weight bridge; on the CPU both
packages take their dense attention paths (on the card the port's auto
dispatch launches the flash kernels, which ``chip_smoke.py`` checks).

Tolerances: probabilities 1e-5 (atol and rtol), two f32 layers of
summation-order differences; predicted labels exactly; AUCs to 1e-12 (the
same ordering of the scores; the two formulas round differently in the last
bit). The port's ROC-AUC is a numpy implementation (ties by average ranks)
where the JAX package calls sklearn's ``roc_auc_score``, which the card's
machine lacks: a deliberate difference, held to sklearn's to 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import roc_auc_score

from pfn_tpu.evals import tabular as jtab
from pfn_tpu.inference import PFNClassifier as JaxPFNClassifier
from pfn_tpu.models.transformer import PFNTransformer as JaxPFN
from pfn_tpu.models.transformer import TransformerConfig as JaxConfig
from pfn_tpu.priors.binarize import BinarizedPrior as JaxBinarizedPrior
from pfn_tpu.priors.gp_mix import GPMixPrior as JaxGPMixPrior
from pfn_tpu.priors.mlp import MLPPrior as JaxMLPPrior
from pfn_tpu.train import bce_criterion as jax_bce
from pfn_tpu.train import ce_criterion as jax_ce
from pfn_tpu.train.loop import TrainConfig as JaxTrainConfig
from pfn_tpu.train.loop import build_model as jax_build_model
from pfn_tpu_torch.evals import tabular
from pfn_tpu_torch.inference import PFNClassifier
from pfn_tpu_torch.models import PFNTransformer, TransformerConfig
from pfn_tpu_torch.priors import BinarizedPrior, GPMixPrior, MLPPrior
from pfn_tpu_torch.priors.hyper import UniformInt
from pfn_tpu_torch.train import (
    TrainConfig,
    bce_criterion,
    build_model,
    ce_criterion,
    seeded_flax_params,
    state_dict_from_flax_params,
    train,
)

NFEAT, EMSIZE, NHEAD, NHID, NLAYERS = 4, 32, 2, 64, 2
TOL = 1e-5


def _models(n_out, seed=0):
    params = seeded_flax_params(NFEAT, EMSIZE, NHID, NLAYERS, n_out, seed=seed)
    jcfg = JaxConfig(num_features=NFEAT, n_out=n_out, emsize=EMSIZE, nhead=NHEAD, nhid=NHID, nlayers=NLAYERS)
    model = PFNTransformer(TransformerConfig(num_features=NFEAT, n_out=n_out, emsize=EMSIZE, nhead=NHEAD,
                                             nhid=NHID, nlayers=NLAYERS)).eval()
    model.load_state_dict(state_dict_from_flax_params(params, NLAYERS), strict=True)
    return (JaxPFN(jcfg), jax.tree.map(jnp.asarray, params)), model


def _data(n, f, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f)).astype(np.float32)
    return X, (X[:, 0] + 0.5 * rng.standard_normal(n) > 0).astype(np.int64)


@pytest.mark.parametrize("kind,f,normalize_x", [("bce", 4, False), ("bce", 3, True), ("ce", 4, False),
                                                ("ce", 2, True)])
def test_classifier_matches_jax(kind, f, normalize_x):
    """BCE: labels {3, 7} as codes 0/1, [1 - p, p]. CE (4 classes): the
    context holds classes {-1, 5, 9}, the softmax runs over the first 3
    logits. Fewer features than the model's are zero-padded and rescaled."""
    criterion, jcriterion = (bce_criterion(), jax_bce()) if kind == "bce" else (ce_criterion(4), jax_ce(4))
    (jmodel, jparams), model = _models(criterion.n_out(1))
    X, codes = _data(50, f, seed=1)
    labels = np.array([3, 7])[codes] if kind == "bce" else np.array([-1, 5, 9])[codes + (X[:, -1] > 0.8)]
    want_clf = JaxPFNClassifier(jmodel, jparams, jcriterion, normalize_x=normalize_x).fit(X[:30], labels[:30])
    clf = PFNClassifier(model, criterion, normalize_x=normalize_x).fit(X[:30], labels[:30])
    np.testing.assert_array_equal(clf.classes_, want_clf.classes_)
    want = want_clf.predict_proba(X[30:])
    got = clf.predict_proba(X[30:])
    assert got.shape == want.shape == (20, len(clf.classes_)) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(clf.predict(X[30:]), want_clf.predict(X[30:]))
    assert set(clf.predict(X[30:])) <= set(clf.classes_)


def test_classifier_checks_its_head_and_classes():
    _, model = _models(1)
    X, codes = _data(12, 4, seed=2)
    with pytest.raises(ValueError, match="binary"):
        PFNClassifier(model, bce_criterion()).fit(X, np.arange(12) % 3)
    with pytest.raises(ValueError, match="bce or ce"):
        PFNClassifier(model, dataclasses.replace(bce_criterion(), kind="mse")).fit(X, codes)
    with pytest.raises(ValueError, match="CE head"):
        PFNClassifier(model, ce_criterion(2)).fit(X, np.arange(12) % 3)
    # One class in the context: the read-out keeps two columns.
    clf = PFNClassifier(model, bce_criterion()).fit(X[:6], np.zeros(6))
    assert clf.predict_proba(X[6:]).shape == (6, 2) and set(clf.predict(X[6:])) == {0.0}


@pytest.mark.parametrize("ensemble", [1, 3])
def test_evaluate_position_pfn_matches_jax(ensemble):
    """30 rows of 3 real features against a 4-feature model (zero-padded),
    bptt 20, eval_position 8, 10 windows; ensemble 3 permutes the real
    columns of members 1-2 and flips member 1's labels."""
    (jmodel, jparams), model = _models(1, seed=3)
    X, y = _data(30, 3, seed=4)
    want_auc, want_p, want_y = jtab.evaluate_position_pfn(jmodel, jparams, X, y, 20, 8, max_samples=10,
                                                          num_features=NFEAT, ensemble=ensemble)
    aucs, probs, ys = tabular.evaluate_position_pfn(model, X, y, 20, 8, max_samples=10, num_features=NFEAT,
                                                    ensemble=ensemble)
    np.testing.assert_array_equal(ys, want_y)
    np.testing.assert_allclose(probs, want_p, atol=TOL, rtol=TOL)
    assert len(aucs) == len(want_auc) > 0
    np.testing.assert_allclose(aucs, want_auc, atol=1e-12, rtol=0)


def test_evaluate_pfn_matches_jax_and_caches(tmp_path):
    (jmodel, jparams), model = _models(1, seed=3)
    datasets = [("a", *_data(30, 3, seed=5), []), ("b", *_data(26, 2, seed=6), [])]
    kw = dict(max_samples=10, num_features=NFEAT, cache_dir=str(tmp_path))
    res = tabular.evaluate(datasets, model, "pfn", 20, [8, 12], **kw)
    want = jtab.evaluate(datasets, jmodel, "pfn", 20, [8, 12], params=jparams, max_samples=10,
                         num_features=NFEAT)
    for key in ("mean_metric", "mean_metric_unweighted", "mean_metric_at_8", "a_num_windows_at_12"):
        assert res[key] == pytest.approx(want[key], abs=1e-12)
    n = {(d, p): res[f"{d}_num_windows_at_{p}"] for d in "ab" for p in (8, 12)}
    for p in (8, 12):
        want = sum(res[f"{d}_mean_metric_at_{p}"] * n[d, p] for d in "ab") / sum(n[d, p] for d in "ab")
        assert res[f"mean_metric_at_{p}"] == pytest.approx(want)
    assert len(list(tmp_path.iterdir())) == 2
    assert tabular.evaluate(datasets, model, "pfn", 20, [8, 12], **kw)["mean_metric"] == res["mean_metric"]
    # The PFN branch follows the argument's type (a torch module), not the
    # method's name, which only names the cache files.
    again = tabular.evaluate(datasets, model, "another_name", 20, [8, 12], max_samples=10, num_features=NFEAT)
    assert again["mean_metric"] == res["mean_metric"]


@pytest.mark.parametrize("seed", range(6))
def test_roc_auc_matches_sklearn_with_ties(seed):
    rng = np.random.default_rng(seed)
    n = [7, 30, 200, 1000, 64, 5][seed]
    y = rng.integers(0, 2, n)
    y[:2] = [0, 1]
    score = np.round(rng.standard_normal(n) + y, [1, 0, 2, 1, 6, 0][seed])  # coarse grids: many ties
    assert abs(tabular.roc_auc(y, score) - roc_auc_score(y, score)) < 1e-12
    labels = np.array(["no", "yes"])[y]
    assert abs(tabular.roc_auc(labels, -score) - roc_auc_score(labels, -score)) < 1e-12


def test_roc_auc_edges():
    assert tabular.roc_auc([0, 0, 1, 1], [0.1, 0.2, 0.3, 0.4]) == 1.0
    assert tabular.roc_auc([0, 1], [0.5, 0.5]) == 0.5
    with pytest.raises(ValueError, match="two classes"):
        tabular.roc_auc([1, 1, 1], [0.1, 0.2, 0.3])


def test_build_windows_matches_jax():
    X, y = _data(30, 3, seed=7)
    for bptt, max_samples in ((20, 10), (30, 5), (10, 100)):
        want = jtab.build_windows(X, y, bptt, max_samples)
        for got, w in zip(tabular.build_windows(X, y, bptt, max_samples), want):
            np.testing.assert_array_equal(got, w)
    with pytest.raises(ValueError, match="too short"):
        tabular.build_windows(X, y, 31, 5)


def test_build_model_takes_the_tabular_priors():
    """num_features and the head width follow the prior and the criterion as
    in the JAX package: BCE gives MLPPrior (num_outputs 1) one output column
    and BinarizedPrior (num_outputs 2) two."""
    cfg = dict(emsize=16, nhid=32, nlayers=1, nhead=2, bptt=10)
    pairs = [(MLPPrior(num_features=60), JaxMLPPrior(num_features=60)),
             (BinarizedPrior(base=GPMixPrior(num_features=8)), JaxBinarizedPrior(base=JaxGPMixPrior(num_features=8)))]
    for prior, jprior in pairs:
        model = build_model(prior, bce_criterion(), TrainConfig(**cfg, device="cpu"))
        jmodel = jax_build_model(jprior, jax_bce(), JaxTrainConfig(**cfg))
        assert (model.config.num_features, model.config.n_out) == (jmodel.config.num_features, jmodel.config.n_out)
    assert build_model(pairs[1][0], bce_criterion(), TrainConfig(**cfg, device="cpu")).config.n_out == 2


def _train_cfg(**kw):
    base = dict(emsize=32, nhid=64, nlayers=2, nhead=2, epochs=2, steps_per_epoch=1, batch_size=16, bptt=20,
                lr=1e-3, warmup_epochs=0, device="cpu", verbose=False)
    base.update(kw)
    return TrainConfig(**base)


def test_train_on_the_mlp_prior_resumes_bitwise(tmp_path, capsys):
    """Two updates on the tabular prior (categorical features, binarized y,
    sampled used features); stopped after the first and resumed, every
    parameter matches the uninterrupted run bit for bit: the prior draws from
    the training generator alone."""
    prior = MLPPrior(num_features=6, max_hidden=16, is_binary_classification=True, categorical_x=True,
                     num_features_used=UniformInt(1, 7))
    full = train(prior, bce_criterion(), _train_cfg())
    assert all(np.isfinite(s["mean_loss"]) and s["mean_loss"] > 0 for s in full.epoch_stats)
    ckdir = str(tmp_path / "ck")
    train(prior, bce_criterion(), _train_cfg(epochs=1, checkpoint_dir=ckdir, checkpoint_every=1))
    resumed = train(prior, bce_criterion(), _train_cfg(checkpoint_dir=ckdir, checkpoint_every=1, verbose=True))
    assert f"resumed from {ckdir}/epoch_1 (epoch 1)" in capsys.readouterr().out
    assert resumed.final_loss == full.final_loss
    a, b = full.model.state_dict(), resumed.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    # The trained model serves through the classifier.
    X, y, _ = prior.sample(1, 20, generator=torch.Generator().manual_seed(9))
    clf = PFNClassifier.from_train_result(resumed).fit(X[0, :12].numpy(), y[0, :12].numpy())
    p = clf.predict_proba(X[0, 12:].numpy())
    assert p.shape == (8, 2) and np.isfinite(p).all()
