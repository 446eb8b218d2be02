"""Tabular benchmark: the PFN branch of the sliding-window evaluation.

Port of the PFN half of ``pfn_tpu/evals/tabular.py`` (reference tabular.py:
evaluate :160-213, evaluate_position :231-306): every length-bptt window of a
dataset, a seeded subsample of ``max_samples`` of them, each window z-scored
by the statistics of its context prefix, zero-padded to the model's
features, all windows (and ensemble members) in one batched forward, and the
ROC-AUC of the predictions at positions >= eval_position, per window.

Differences from the JAX module, on purpose:
  * ``roc_auc`` is computed here with numpy (the Mann-Whitney statistic, ties
    by average ranks), where the JAX module calls
    ``sklearn.metrics.roc_auc_score``: the card's machine has no sklearn.
    ``tests/test_torch_port_classifier.py`` holds it to sklearn's.
  * The baseline zoo (logistic, KNN, BNN, GP classifier, CatBoost, XGBoost)
    and ``BayesianNNClassifier`` are not ported yet (ROADMAP.md queue 1 item
    12): ``evaluate`` takes only ``method="pfn"``.
  * The model holds its weights: the functions take ``model`` where the JAX
    ones take ``model, params``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from pfn_tpu_torch.evals.harness import pfn_predict


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
    aucs = [roc_auc(ys[i], probs[i]) for i in range(len(wx)) if len(np.unique(ys[i])) >= 2]
    return np.asarray(aucs), probs, ys


def evaluate(datasets, model, method: str, bptt: int, eval_positions, max_samples: int = 40,
             cache_dir: str | None = None, overwrite: bool = False, num_features: int | None = None,
             ensemble: int = 1):
    """Evaluate a PFN over a list of (name, X, y, cat_feats) datasets, with
    per-dataset .npy caching keyed by everything that changes the numbers.
    Returns per-dataset and mean metrics: ``mean_metric_at_{pos}`` weights
    each dataset by its count of scored windows, ``..._unweighted`` is the
    reference's plain mean over datasets."""
    if method != "pfn":
        raise NotImplementedError(
            f"method {method!r}: the sklearn baselines are not ported yet (ROADMAP.md queue 1 item 12)")
    result = {"metric": "auc"}
    spec = f"bptt{bptt}_pos{'-'.join(map(str, eval_positions))}_n{max_samples}"
    if ensemble > 1:
        spec += f"_e{ensemble}"
    for name, X, y, _cat_feats in datasets:
        cache_path = os.path.join(cache_dir, f"results_{method}_{name}_{spec}.npy") if cache_dir else None
        if cache_path and os.path.isfile(cache_path) and not overwrite:
            result.update(np.load(cache_path, allow_pickle=True).tolist())
            continue
        ds_result = {}
        t0 = time.time()
        for pos in eval_positions:
            aucs, _, _ = evaluate_position_pfn(model, X, y, bptt, pos, max_samples=max_samples,
                                               num_features=num_features, ensemble=ensemble)
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
