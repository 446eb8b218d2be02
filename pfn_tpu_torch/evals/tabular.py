"""Tabular benchmark: the PFN against the classic baselines on real datasets.

Port of ``pfn_tpu/evals/tabular.py`` (reference tabular.py: evaluate
:160-213, evaluate_position :231-306, the baseline zoo :325-626): every
length-bptt window of a dataset, a seeded subsample of ``max_samples`` of
them, each window z-scored by the statistics of its context prefix, and the
ROC-AUC of the predictions at positions >= eval_position, per window. The
PFN branch zero-pads the features to the model's, and runs all windows (and
ensemble members) in one batched forward. The baselines (logistic, KNN, the
sklearn GP classifier, the BNN fitted by SVI, HistGradientBoosting, XGBoost,
CatBoost) each grid-search per window, with the JAX module's grids and its
``CV`` rule.

Differences from the JAX module, on purpose:
  * ``roc_auc`` is computed here with numpy (the Mann-Whitney statistic, ties
    by average ranks), where the JAX module calls
    ``sklearn.metrics.roc_auc_score``: the card's machine has no sklearn.
    ``tests/test_torch_port_classifier.py`` holds it to sklearn's. sklearn,
    xgboost and catboost are imported inside the baselines that need them.
  * The model holds its weights: ``evaluate_position_pfn`` takes ``model``
    where the JAX one takes ``model, params``, and ``evaluate`` takes the PFN
    branch where ``model_or_metric`` is a ``torch.nn.Module`` (the JAX one
    where ``params`` is given).
  * ``BayesianNNClassifier`` fits on the port's ``svi`` on a torch device
    (``bayes_net_metric``'s ``device``: the current card by default, "cpu"
    on the host).
"""

from __future__ import annotations

import itertools
import os
import time
import warnings

import numpy as np
import torch

from pfn_tpu_torch.device import require_cuda
from pfn_tpu_torch.evals.comparison import BayesianNNModel
from pfn_tpu_torch.evals.harness import pfn_predict
from pfn_tpu_torch.evals.inference import svi

CV = 5


def roc_auc(y_true, y_score) -> float:
    """Area under the ROC curve of binary labels ``y_true`` against scores:
    P(score of a positive > score of a negative) + P(tie) / 2, from the ranks
    of the scores (ties share their average rank). Raises ValueError when
    y_true holds one class, as sklearn does."""
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    classes = np.unique(y_true)
    if len(classes) != 2:
        raise ValueError(f"ROC AUC needs exactly two classes in y_true, got {len(classes)}")
    pos = y_true == classes[1]
    order = np.argsort(y_score, kind="mergesort")
    s = y_score[order]
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    ends = np.r_[starts[1:], len(s)]
    ranks = np.empty(len(s))
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)  # 1-based average ranks
    n_pos = int(pos.sum())
    n_neg = len(s) - n_pos
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


metric_used = roc_auc


def build_windows(X: np.ndarray, y: np.ndarray, bptt: int, max_samples: int, seed: int = 13):
    """All sliding length-bptt windows (the exactly fitting one included),
    then a seeded subsample of ``max_samples`` of them. Returns (windows_X
    (S, bptt, F), windows_y (S, bptt))."""
    num = len(X) - bptt + 1
    if num <= 0:
        raise ValueError(f"dataset too short ({len(X)}) for bptt={bptt}")
    wx = np.stack([X[i: i + bptt] for i in range(num)])
    wy = np.stack([y[i: i + bptt] for i in range(num)])
    sel = np.random.RandomState(seed).permutation(num)[:max_samples]
    return wx[sel], wy[sel]


@torch.no_grad()
def evaluate_position_pfn(model, X: np.ndarray, y: np.ndarray, bptt: int, eval_position: int,
                          max_samples: int = 40, rescale_features: float = 1.0, num_features: int | None = None,
                          ensemble: int = 1):
    """ROC-AUC of the PFN at one eval_position over subsampled windows.

    Windows are z-scored by their context prefix's statistics, optionally
    rescaled, and zero-padded to ``num_features``. ``ensemble > 1`` averages
    the probabilities of that many input-symmetry variants, all in one
    batched forward: member e > 0 permutes the real feature columns (the
    permutations drawn from ``np.random.RandomState(1234)``), and the odd
    members flip the binary labels (their probabilities flipped back). The
    forward runs on the model's device. Returns (per-window AUCs, probs
    (S, bptt - eval_position), ys), windows with one class skipped in the
    AUCs.
    """
    wx, wy = build_windows(X, y, bptt, max_samples)
    mean = wx[:, :eval_position].mean(axis=1, keepdims=True)
    std = wx[:, :eval_position].std(axis=1, keepdims=True) + 1e-6
    wx = (wx - mean) / std
    wx = wx / rescale_features
    F_real = wx.shape[-1]
    if num_features is not None and F_real < num_features:
        wx = np.concatenate([wx, np.zeros((*wx.shape[:2], num_features - F_real), np.float32)], -1)

    members_x, members_y, flipped = [], [], []
    rng = np.random.RandomState(1234)
    for e in range(max(1, ensemble)):
        xe = wx
        if e > 0:
            perm = rng.permutation(F_real)
            xe = np.concatenate([wx[..., perm], wx[..., F_real:]], -1)
        flip = e % 2 == 1
        members_x.append(xe)
        members_y.append(1.0 - wy if flip else wy)
        flipped.append(flip)

    device = next(model.parameters()).device
    x = torch.as_tensor(np.concatenate(members_x, 0), dtype=torch.float32, device=device)
    yy = torch.as_tensor(np.concatenate(members_y, 0), dtype=torch.float32, device=device)
    logits = pfn_predict(model, x, yy, eval_position)
    p = torch.sigmoid(logits[..., 0]).cpu().numpy().reshape(len(members_x), wx.shape[0], bptt)
    for e, flip in enumerate(flipped):
        if flip:
            p[e] = 1.0 - p[e]
    probs = p.mean(axis=0)[:, eval_position:]
    ys = wy[:, eval_position:]
    aucs = [metric_used(ys[i], probs[i]) for i in range(len(wx)) if len(np.unique(ys[i])) >= 2]
    return np.asarray(aucs), probs, ys


# ---------------------------------------------------------------------------
# Baseline zoo: each (x, y, test_x, test_y, cat_feats) -> (metric, pred)
# ---------------------------------------------------------------------------

def _cv(x) -> int:
    return max(2, min(CV, len(x) // 2))


def logistic_metric(x, y, test_x, test_y, cat_features):
    """GridSearchCV'd LogisticRegression (tabular.py:325-346)."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.model_selection import GridSearchCV

    grid = {
        "solver": ["saga"],
        "penalty": ["l1", "l2", None],
        "tol": [1e-2, 1e-4, 1e-10],
        "max_iter": [500],
        "fit_intercept": [True, False],
        "C": [1e-5, 0.001, 0.01, 0.1, 1.0, 2.0],
    }
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        clf = GridSearchCV(LogisticRegression(), grid, cv=_cv(x))
        clf.fit(x, y.astype(int))
        pred = clf.predict_proba(test_x)[:, 1]
    return metric_used(test_y, pred), pred


def knn_metric(x, y, test_x, test_y, cat_features):
    """GridSearchCV'd KNN (tabular.py:350-369)."""
    from sklearn import neighbors
    from sklearn.model_selection import GridSearchCV

    grid = {"n_neighbors": np.arange(1, max(2, min(6, len(y) - 1)))}
    clf = GridSearchCV(neighbors.KNeighborsClassifier(), grid, cv=_cv(x))
    clf.fit(x, y.astype(int))
    pred = clf.predict_proba(test_x)[:, 1]
    return metric_used(test_y, pred), pred


def gp_metric(x, y, test_x, test_y, cat_features):
    """GridSearchCV'd sklearn GP classifier over y_scale x length_scale RBF
    kernels (tabular.py:481-503)."""
    from sklearn.gaussian_process import GaussianProcessClassifier
    from sklearn.gaussian_process.kernels import RBF
    from sklearn.model_selection import GridSearchCV

    params_y_scale = [0.05, 0.1, 0.5, 1.0, 5.0, 10.0]
    params_length_scale = [0.1, 0.5, 1.0, 2.0]
    grid = {"kernel": [s * RBF(l) for s, l in itertools.product(params_y_scale, params_length_scale)]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        clf = GridSearchCV(GaussianProcessClassifier(), grid, cv=_cv(x))
        clf.fit(x, y.astype(int))
        pred = clf.predict_proba(test_x)[:, 1]
    return metric_used(test_y, pred), pred


class BayesianNNClassifier:
    """2-layer BNN classifier with N(0, 1) priors fitted by SVI: the JAX
    package's replacement for the reference's Pyro BayesianNNClassifier
    (tabular.py:414-462), with sklearn's fit / predict_proba. It runs on
    ``device`` (None: the current card, an error without one). The JAX
    module caches its jitted fit and predict per configuration to save
    recompiles; eager torch compiles nothing, so there is no such cache
    here."""

    def __init__(self, num_features, embed=10, lr=1e-3, num_steps=400, num_pred_samples=400, seed=0, device=None):
        self.num_features = num_features
        self.embed = embed
        self.lr = lr
        self.num_steps = num_steps
        self.num_pred_samples = num_pred_samples
        self.seed = seed
        self.device = require_cuda() if device is None else torch.device(device)
        self._model = BayesianNNModel(num_features, embed)  # the same network and N(0, 1) priors

    def fit(self, X, y):
        X = torch.as_tensor(np.asarray(X), dtype=torch.float32, device=self.device)
        y = torch.as_tensor(np.asarray(y), dtype=torch.int64, device=self.device)
        F, E = self.num_features, self.embed
        if X.shape[1] != F:
            raise ValueError(f"X has {X.shape[1]} features, the classifier {F}")
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        init = {"w1": 0.1 * torch.randn(F, E, generator=g, device=self.device),
                "b1": torch.zeros(E, device=self.device),
                "w2": 0.1 * torch.randn(E, 2, generator=g, device=self.device),
                "b2": torch.zeros(2, device=self.device)}
        self.guide_ = svi(lambda theta: self._model.log_joint(theta, X, y), init, g, num_steps=self.num_steps,
                          lr=self.lr)
        return self

    @torch.no_grad()
    def predict_proba(self, X):
        """P(class 1) of each row: the mean over ``num_pred_samples`` draws
        of the guide."""
        X = torch.as_tensor(np.asarray(X), dtype=torch.float32, device=self.device)
        g = torch.Generator(device=self.device).manual_seed(self.seed + 100)
        thetas = self.guide_.sample(g, self.num_pred_samples)
        return torch.softmax(self._model.logits(thetas, X), dim=-1)[..., 1].mean(0).cpu().numpy()


def bayes_net_metric(x, y, test_x, test_y, cat_features, device=None):
    """BNN-SVI baseline (tabular.py:465-478); a small grid over embed and lr.
    ``device``: where the classifiers fit (None: the current card)."""
    best = None
    for embed in [5, 30]:
        for lr in [1e-3, 1e-4]:
            clf = BayesianNNClassifier(x.shape[1], embed=embed, lr=lr, device=device)
            clf.fit(x, y)
            pred = clf.predict_proba(test_x)
            m = metric_used(test_y, pred)
            if best is None or m > best[0]:
                best = (m, pred)
    return best


def xgb_metric(x, y, test_x, test_y, cat_features):
    """XGBoost baseline (tabular.py:599-626); needs the xgboost package."""
    try:
        import xgboost as xgb
    except ImportError as e:
        raise ImportError("xgboost is not installed in this environment") from e
    from sklearn.model_selection import GridSearchCV

    grid = {
        "min_child_weight": [0.5, 1.0],
        "learning_rate": [0.02, 0.2],
        "subsample": [0.5, 0.8],
        "max_depth": [1, 2],
        "colsample_bytree": [0.8],
        "eval_metric": ["logloss"],
        "n_estimators": [100],
    }
    clf = GridSearchCV(xgb.XGBClassifier(), grid, cv=CV)
    clf.fit(x, y.astype(int))
    pred = clf.predict_proba(test_x)[:, 1]
    return metric_used(test_y, pred), pred


def catboost_metric(x, y, test_x, test_y, cat_features):
    """CatBoost baseline (tabular.py:556-596); needs the catboost package."""
    try:
        from catboost import CatBoostClassifier
    except ImportError as e:
        raise ImportError("catboost is not installed in this environment") from e
    model = CatBoostClassifier(loss_function="Logloss", logging_level="Silent")
    model.grid_search(
        {
            "learning_rate": [0.1, 0.5, 1.0],
            "depth": [2, 4, 7],
            "l2_leaf_reg": [0.0, 0.5, 1],
            "iterations": [10, 40, 70],
        },
        X=x, y=y, cv=CV, plot=False, verbose=False,
    )
    pred = model.predict_proba(test_x)[:, 1]
    return metric_used(test_y, pred), pred


def hist_gb_metric(x, y, test_x, test_y, cat_features):
    """Gradient-boosted trees by sklearn's HistGradientBoostingClassifier,
    the stand-in for the reference's xgboost/catboost columns
    (tabular.py:556-626): the union of their grids (learning rate x depth x
    boosting rounds), grid-searched per window, with min_samples_leaf
    (sklearn's default of 20 would make one leaf of a ~30-row context)."""
    from sklearn.ensemble import HistGradientBoostingClassifier
    from sklearn.model_selection import GridSearchCV

    grid = {
        "learning_rate": [0.02, 0.1, 0.5],
        "max_depth": [1, 2, 4],
        "max_iter": [10, 50, 100],
        "min_samples_leaf": [2, 8],
        "early_stopping": [False],
    }
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        clf = GridSearchCV(HistGradientBoostingClassifier(), grid, cv=_cv(x))
        clf.fit(x, y.astype(int))
        pred = clf.predict_proba(test_x)[:, 1]
    return metric_used(test_y, pred), pred


BASELINES = {
    "logistic": logistic_metric,
    "knn": knn_metric,
    "gp": gp_metric,
    "bayes": bayes_net_metric,
    "xgb": xgb_metric,
    "catboost": catboost_metric,
    "hgb": hist_gb_metric,
}


def batch_pred(metric_function, wx, wy, cat_feats, start):
    """A baseline on each window, z-scored by its context prefix
    (tabular.py:309-323). Windows whose query suffix holds one class are
    skipped (the AUC is undefined there), as in the PFN branch."""
    metrics, outputs = [], []
    for i in range(len(wx)):
        if len(np.unique(wy[i][start:])) < 2:
            continue
        x = wx[i]
        mean = x[:start].mean(axis=0)
        std = x[:start].std(axis=0) + 1e-6
        x = (x - mean) / std
        m, out = metric_function(x[:start], wy[i][:start], x[start:], wy[i][start:], cat_feats)
        metrics.append(m)
        outputs.append(out)
    return np.asarray(metrics), np.asarray(outputs)


def evaluate_position_baseline(metric_function, X, y, bptt, eval_position, max_samples=40, cat_feats=()):
    wx, wy = build_windows(X, y, bptt, max_samples)
    metrics, outputs = batch_pred(metric_function, wx, wy, list(cat_feats), eval_position)
    return metrics, outputs, wy[:, eval_position:]


# ---------------------------------------------------------------------------
# Top-level sweep with result caching (tabular.py:160-213)
# ---------------------------------------------------------------------------

def evaluate(datasets, model_or_metric, method: str, bptt: int, eval_positions, max_samples: int = 40,
             cache_dir: str | None = None, overwrite: bool = False, num_features: int | None = None,
             ensemble: int = 1):
    """Evaluate a PFN (a ``torch.nn.Module``) or a baseline metric function
    over a list of (name, X, y, cat_feats) datasets, with per-dataset .npy
    caching keyed by everything that changes the numbers (the reference keys
    on method and dataset alone, :168-179). Returns per-dataset and mean
    metrics: ``mean_metric_at_{pos}`` weights each dataset by its count of
    scored windows, ``..._unweighted`` is the reference's plain mean over
    datasets (:209)."""
    is_pfn = isinstance(model_or_metric, torch.nn.Module)
    result = {"metric": "auc"}
    spec = f"bptt{bptt}_pos{'-'.join(map(str, eval_positions))}_n{max_samples}"
    if ensemble > 1:
        spec += f"_e{ensemble}"
    for name, X, y, cat_feats in datasets:
        cache_path = os.path.join(cache_dir, f"results_{method}_{name}_{spec}.npy") if cache_dir else None
        if cache_path and os.path.isfile(cache_path) and not overwrite:
            result.update(np.load(cache_path, allow_pickle=True).tolist())
            continue
        ds_result = {}
        t0 = time.time()
        for pos in eval_positions:
            if is_pfn:
                aucs, _, _ = evaluate_position_pfn(model_or_metric, X, y, bptt, pos, max_samples=max_samples,
                                                   num_features=num_features, ensemble=ensemble)
            else:
                aucs, _, _ = evaluate_position_baseline(model_or_metric, X, y, bptt, pos, max_samples=max_samples,
                                                        cat_feats=cat_feats)
            ds_result[f"{name}_mean_metric_at_{pos}"] = float(np.asarray(aucs).mean())
            ds_result[f"{name}_per_ds_metric_at_{pos}"] = np.asarray(aucs)
            ds_result[f"{name}_num_windows_at_{pos}"] = int(np.size(aucs))
        ds_result[f"{name}_time"] = time.time() - t0
        if cache_path:
            os.makedirs(cache_dir, exist_ok=True)
            np.save(cache_path, ds_result)
        result.update(ds_result)

    for pos in eval_positions:
        counts = np.asarray([np.size(result[f"{d[0]}_per_ds_metric_at_{pos}"]) for d in datasets], np.float64)
        means = np.asarray([result[f"{d[0]}_mean_metric_at_{pos}"] for d in datasets])
        # A dataset with no scored window (mean NaN) drops out; no data at all
        # at this position gives NaN, not a plausible-looking 0.
        means = np.where(counts > 0, np.nan_to_num(means), 0.0)
        result[f"mean_metric_at_{pos}"] = float(np.sum(means * counts) / np.sum(counts)
                                                if counts.sum() > 0 else float("nan"))
        valid = counts > 0
        result[f"mean_metric_at_{pos}_unweighted"] = float(np.mean(means[valid]) if valid.any() else float("nan"))
    result["mean_metric"] = float(np.mean([result[f"mean_metric_at_{pos}"] for pos in eval_positions]))
    result["mean_metric_unweighted"] = float(
        np.mean([result[f"mean_metric_at_{pos}_unweighted"] for pos in eval_positions]))
    return result
