"""The tabular benchmark's data and baselines in the port
(``pfn_tpu_torch.data``, ``pfn_tpu_torch.evals.tabular``) against the JAX
package's, on the CPU.

  * The loaders equal the JAX ones array for array:
    ``class_balance_interleave`` (both label majorities, a cap),
    ``load_local_benchmark``, ``load_svmlight`` on a file written here.
  * ``logistic``, ``knn``, ``gp`` and ``hist_gb`` on one window: the same
    sklearn predictions, and AUCs equal to the JAX functions' to 1e-12 (the
    port's numpy ROC-AUC, which tests/test_torch_port_classifier.py holds to
    sklearn's).
  * ``batch_pred``, ``evaluate_position_baseline`` and ``evaluate`` with a
    deterministic toy metric (the window's first feature as the score):
    every key of ``evaluate``'s result equal to the JAX ``evaluate``'s (the
    ``_time`` keys exist on both), AUCs to 1e-12; the cache round trip,
    and a cache the JAX ``evaluate`` wrote read back by the port's; the
    NaN rules (a dataset without a scored window drops out of the weighted
    mean; a position with none at all is NaN).
  * The ``xgb`` and ``catboost`` baselines raise a clear ImportError where
    their packages are missing (as here).
  * The BNN classifier and ``bayes_net_metric``:
    tests/test_torch_port_tabular_bnn.py.

sklearn runs on one OpenMP thread here (threadpoolctl) and torch on one
intra-op thread: beside other workers' threads, both thrash.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from pfn_tpu.data import datasets as jdata
from pfn_tpu.evals import tabular as jtab
from pfn_tpu_torch import data
from pfn_tpu_torch.evals import tabular as tab


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _rows(n, f, seed, p=0.5):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f)).astype(np.float32)
    return X, (X[:, 0] + rng.standard_normal(n) > 2 * (p - 0.5)).astype(np.float32)


@pytest.mark.parametrize("p,cap", [(0.3, None), (0.7, None), (0.5, 10)])
def test_class_balance_interleave_matches_jax(p, cap):
    X, y = _rows(41, 3, seed=1, p=p)
    got, want = data.class_balance_interleave(X, y, cap), jdata.class_balance_interleave(X, y, cap)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_local_benchmark_matches_jax():
    got, want = data.load_local_benchmark(max_samples=200), jdata.load_local_benchmark(max_samples=200)
    assert [r[0] for r in got] == [r[0] for r in want] == ["2class_iris", "2class_wine", "breast_cancer"]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
        assert a[3] == b[3] == []
    for fn in ("get_iris", "get_wine", "get_diabetes", "get_linnerud"):
        for a, b in zip(getattr(data, fn)(), getattr(jdata, fn)()):
            np.testing.assert_array_equal(a, b)


def test_svmlight_matches_jax(tmp_path):
    from sklearn.datasets import dump_svmlight_file

    rng = np.random.RandomState(0)
    X = rng.randn(50, 4)
    y = np.concatenate([np.full(30, -1.0), np.full(20, 1.0)])
    path = str(tmp_path / "d.svm")
    dump_svmlight_file(X, y, path)
    got, want = data.load_svmlight(path, max_samples=30), jdata.load_svmlight(path, max_samples=30)
    assert got[0].shape == (30, 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _window(seed=3, n=30, start=20):
    """One z-scored window: a 20-row context and 10 queries of 3 features."""
    X, y = _rows(n, 3, seed)
    y[:4] = [0, 1, 0, 1]
    y[start:start + 2] = [0, 1]
    mean, std = X[:start].mean(0), X[:start].std(0) + 1e-6
    X = (X - mean) / std
    return X[:start], y[:start], X[start:], y[start:]


@pytest.mark.parametrize("name", ["logistic_metric", "knn_metric", "gp_metric", "hist_gb_metric"])
def test_sklearn_baselines_match_jax(name):
    x, y, tx, ty = _window()
    np.random.seed(0)  # saga draws its sample order from numpy's global generator
    auc, pred = getattr(tab, name)(x, y, tx, ty, [])
    np.random.seed(0)
    want_auc, want_pred = getattr(jtab, name)(x, y, tx, ty, [])
    np.testing.assert_array_equal(pred, want_pred)
    assert abs(auc - want_auc) <= 1e-12


def _first_feature(auc_fn):
    """A deterministic toy baseline: the window's first feature as the
    score, scored by the package's own AUC."""
    return lambda x, y, tx, ty, cats: (auc_fn(ty, tx[:, 0]), tx[:, 0])


def _datasets():
    A = ["A", *_rows(60, 3, seed=4), []]
    B = ["B", *_rows(20, 3, seed=5), []]
    C = ["C", _rows(25, 3, seed=6)[0], np.zeros(25, np.float32), []]  # one class: no window scores
    return [A, B, C]


def test_batch_pred_and_position_baseline_match_jax():
    X, y = _rows(60, 3, seed=7)
    wx, wy = tab.build_windows(X, y, 20, 8)
    got = tab.batch_pred(_first_feature(tab.metric_used), wx, wy, [], 10)
    want = jtab.batch_pred(_first_feature(jtab.metric_used), wx, wy, [], 10)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got[1], want[1])
    got = tab.evaluate_position_baseline(_first_feature(tab.metric_used), X, y, 20, 10, max_samples=8)
    want = jtab.evaluate_position_baseline(_first_feature(jtab.metric_used), X, y, 20, 10, max_samples=8)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def _assert_same_result(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.endswith("_time"):
            continue
        if isinstance(v, np.ndarray):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12)
        elif isinstance(v, float) and np.isnan(v):
            assert np.isnan(got[k]), k
        elif isinstance(v, float):
            assert abs(got[k] - v) <= 1e-12, k
        else:
            assert got[k] == v, k


def test_evaluate_with_a_metric_matches_jax(tmp_path):
    ds = _datasets()
    want = jtab.evaluate(ds, _first_feature(jtab.metric_used), "first", 20, [5, 10], max_samples=6,
                         cache_dir=str(tmp_path / "jax"))
    got = tab.evaluate(ds, _first_feature(tab.metric_used), "first", 20, [5, 10], max_samples=6,
                       cache_dir=str(tmp_path / "port"))
    _assert_same_result(got, want)
    assert got["C_num_windows_at_10"] == 0 and np.isnan(got["C_mean_metric_at_10"])
    assert np.isfinite(got["mean_metric_at_10"])
    # The cache round trip, and the JAX cache read by the port.
    never = lambda *a: pytest.fail("a cached dataset was evaluated again")  # noqa: E731
    _assert_same_result(tab.evaluate(ds, never, "first", 20, [5, 10], max_samples=6,
                                     cache_dir=str(tmp_path / "port")), want)
    _assert_same_result(tab.evaluate(ds, never, "first", 20, [5, 10], max_samples=6,
                                     cache_dir=str(tmp_path / "jax")), want)
    # No scored window at a position at all: NaN, as in the JAX module.
    only_c = tab.evaluate(ds[2:], _first_feature(tab.metric_used), "first", 20, [10], max_samples=6)
    assert np.isnan(only_c["mean_metric_at_10"]) and np.isnan(only_c["mean_metric_unweighted"])


@pytest.mark.parametrize("name,package", [("xgb_metric", "xgboost"), ("catboost_metric", "catboost")])
def test_missing_boosting_packages_raise(name, package):
    x, y, tx, ty = _window()
    with pytest.raises(ImportError, match=f"{package} is not installed"):
        getattr(tab, name)(x, y, tx, ty, [])
    assert tab.BASELINES[name.split("_")[0]] is getattr(tab, name)
