"""The BNN-SVI baseline of the tabular benchmark in the port
(``pfn_tpu_torch.evals.tabular``) on the CPU.

  * ``BayesianNNClassifier`` learns separable data (tests/test_inference.py's
    bar, AUC > 0.9), and ``bayes_net_metric`` runs through ``evaluate``.
  * On a window of 100 context rows and 30 queries, ``bayes_net_metric``'s
    AUC lies within BNN_AUC_SPREAD of the JAX ``bayes_net_metric``'s (the
    two draw from different generators, so only the spread over seeds
    binds them).
  * Without a device it needs a card.

torch runs on one intra-op thread here: beside other workers' threads, it
thrashes.
"""

import functools

import numpy as np
import pytest
import torch

from pfn_tpu.evals import tabular as jtab
from pfn_tpu_torch.evals import tabular as tab


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _window(seed=3, n=130, start=100):
    """One z-scored window of 3 features: ``start`` context rows, the rest
    queries (tests/test_torch_port_tabular_baselines.py's window, larger)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 3)).astype(np.float32)
    y = (X[:, 0] + rng.standard_normal(n) > 0).astype(np.float32)
    y[:4] = [0, 1, 0, 1]
    y[start:start + 2] = [0, 1]
    mean, std = X[:start].mean(0), X[:start].std(0) + 1e-6
    X = (X - mean) / std
    return X[:start], y[:start], X[start:], y[start:]


def test_bnn_classifier_learns_separable_data():
    rng = np.random.RandomState(0)
    X = rng.randn(80, 2).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.int32)
    clf = tab.BayesianNNClassifier(num_features=2, embed=8, num_steps=600, lr=1e-2, device="cpu")
    probs = clf.fit(X[:60], y[:60]).predict_proba(X[60:])
    assert probs.shape == (20,) and ((probs >= 0) & (probs <= 1)).all()
    assert tab.roc_auc(y[60:], probs) > 0.9
    with pytest.raises(ValueError, match="features"):
        clf.fit(X[:, :1], y)


def test_bayes_net_metric_through_evaluate():
    rng = np.random.default_rng(8)
    X = rng.standard_normal((40, 2)).astype(np.float32)
    y = (X[:, 0] + rng.standard_normal(40) > 0).astype(np.float32)
    res = tab.evaluate([("d", X, y, [])], functools.partial(tab.bayes_net_metric, device="cpu"), "bayes", 30, [20],
                       max_samples=1)
    assert res["d_num_windows_at_20"] == 1 and 0.0 <= res["mean_metric"] <= 1.0


# The grid's best AUC on _window() over seeds 0-7 of the classifier, in
# either package (CPU), lay in [0.82, 0.84]: a range of 0.02, and 1.5x that
# binds the two packages' seed-0 AUCs.
BNN_AUC_SPREAD = 0.03


def test_bayes_net_metric_matches_jax():
    x, y, tx, ty = _window()
    auc, pred = tab.bayes_net_metric(x, y, tx, ty, [], device="cpu")
    want_auc, want_pred = jtab.bayes_net_metric(x, y, tx, ty, [])
    assert pred.shape == np.shape(want_pred) == (30,)
    assert abs(auc - want_auc) <= BNN_AUC_SPREAD, (auc, want_auc)


def test_bnn_classifier_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tab.BayesianNNClassifier(num_features=2)
