"""The boosting baseline (hgb: sklearn's HistGradientBoostingClassifier)
across the tabular suite.

Port of ``experiments/tabular_hgb_baseline.py``: the reference paper's
comparison against tuned boosting (tabular.py:556-626, xgboost and
catboost) without those packages: the same window protocol, per-window grid
search and per-window z-scoring as every other baseline column. sklearn on
the host; no model and no card.

    python -m pfn_tpu_torch.experiments.tabular_hgb_baseline --ref_root <dir of the reference's datasets>
    python -m pfn_tpu_torch.experiments.tabular_hgb_baseline

It writes ``--out`` (default ``results/tabular_hgb_reference_suite.json``,
never under ``docs/results/``) with the JAX script's keys, merging the new
hgb column with the committed PFN, logistic, KNN and GP columns of
``docs/results/tabular_reference_suite.json``, which it only reads.
``main(argv)`` returns what it writes.

Differences from the JAX script, on purpose:
  * ``--out`` lies under ``results/``, where the JAX script writes into
    ``docs/results/``.
  * ``--ref_root`` has no default; without it the suite is the three
    sklearn datasets alone (the JAX script always reads the reference's
    files too).
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np

from pfn_tpu_torch.data import load_local_benchmark, load_reference_benchmark
from pfn_tpu_torch.evals.tabular import evaluate, hist_gb_metric

BASE_PATH = "docs/results/tabular_reference_suite.json"  # in the checkout this package lies in
ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bptt", type=int, default=100)
    p.add_argument("--eval_position", type=int, default=30)
    p.add_argument("--max_samples", type=int, default=20)
    p.add_argument("--ref_root", default=None, help="directory with the reference's bundled dataset files")
    p.add_argument("--out", default="results/tabular_hgb_reference_suite.json")
    p.add_argument("--cache_dir", default="results/tabular_hgb_cache")
    args = p.parse_args(argv)

    # The committed tabular_reference_suite.json's suite: the reference's
    # bundled svmlight/CSV files, then the sklearn trio.
    datasets = []
    if args.ref_root:
        datasets += load_reference_benchmark(args.ref_root, max_samples=400)
    datasets += load_local_benchmark(max_samples=400)
    print(f"datasets: {[d[0] for d in datasets]}", flush=True)

    pos = args.eval_position
    res = evaluate(datasets, hist_gb_metric, method="hgb", bptt=args.bptt, eval_positions=[pos],
                   max_samples=args.max_samples, cache_dir=args.cache_dir)
    hgb = {d[0]: round(float(res[f"{d[0]}_mean_metric_at_{pos}"]), 4) for d in datasets}
    hgb["_windows"] = {d[0]: int(res[f"{d[0]}_num_windows_at_{pos}"]) for d in datasets}
    counts = np.asarray([hgb["_windows"][d[0]] for d in datasets], float)
    means = np.asarray([hgb[d[0]] for d in datasets], float)
    hgb_weighted = float((counts * means).sum() / counts.sum())

    out = {
        "protocol": (
            f"bptt={args.bptt}, eval_position={pos}, <=400 rows class-balanced, {args.max_samples} "
            "windows/dataset, per-window ROC-AUC; hgb = sklearn HistGradientBoostingClassifier grid-searched per "
            "window (learning_rate x max_depth x max_iter x min_samples_leaf, 5-fold) - the stand-in for the "
            "reference's xgboost/catboost columns (tabular.py:556-626)"
        ),
        "hgb": hgb,
        "hgb_weighted_mean": round(hgb_weighted, 4),
    }
    if (ROOT / BASE_PATH).is_file():
        with open(ROOT / BASE_PATH) as f:
            base = json.load(f)
        out["other_columns_from"] = BASE_PATH
        out["weighted_mean"] = dict(base.get("weighted_mean", {}))
        out["weighted_mean"]["hgb"] = round(hgb_weighted, 4)
        for col in ("pfn", "logistic", "knn", "gp"):
            if col in base:
                out[col] = base[col]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    print(json.dumps({"hgb_weighted_mean": hgb_weighted,
                      "per_dataset": {k: v for k, v in hgb.items() if k != "_windows"}}), flush=True)
    print(f"wrote {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
