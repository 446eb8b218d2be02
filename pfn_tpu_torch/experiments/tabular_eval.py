"""Tabular PFN against the classic baselines on real datasets.

Port of ``experiments/tabular_eval.py`` (reference
notebooks/TabularEvalSimple.ipynb and tabular.py's main): train (or load) a
classification PFN on a synthetic tabular prior, then score the ROC-AUC at
eval_position 30 over bptt-100 windows against the baseline zoo (logistic,
KNN, GP classifier, the BNN fitted by SVI, XGBoost, CatBoost, and hgb, the
HistGradientBoosting stand-in). The reference's protocol: 60 padded
features, at most 400 class-balanced rows per dataset (tabular.py:628-634).

    python -m pfn_tpu_torch.experiments.tabular_eval --quick
    python -m pfn_tpu_torch.experiments.tabular_eval --prior mlp --epochs 100
    python -m pfn_tpu_torch.experiments.tabular_eval --cpu --quick

It runs on the current CUDA device (an error without one) unless ``--cpu``
is given; the sklearn baselines run on the host and need sklearn, which the
card's machine lacks (a baseline that cannot run prints "skipped", as in
the JAX script). It writes ``<out>/summary.json`` with the JAX script's keys
(``pfn`` and each baseline's mean AUC); ``main(argv)`` returns it.

Differences from the JAX script, on purpose:
  * The non-quick config trains with ``attention_impl="auto"``, where the
    JAX script asks ``bench._resolve_impl("best")`` for its fused-versus-XLA
    A/B winner on the TPU: the port imports nothing of ``bench.py``.
  * ``--ref_root`` has no default: ``--suite auto`` takes the reference's
    files where ``--ref_root`` names a directory, else the sklearn suite.
  * ``--baselines hgb`` runs the hgb column, which the JAX script's help
    names but its table of baselines lacks.
  * ``--load`` and ``--checkpoint`` read and write the model's state_dict.
  * A baseline is skipped where a package it needs is missing (an
    ImportError) or its name is unknown; any other error in it raises, where
    the JAX script prints every exception as "skipped".
"""

from __future__ import annotations

import argparse
import functools
import json
import os

import torch

from pfn_tpu_torch.data import load_local_benchmark, load_reference_benchmark
from pfn_tpu_torch.device import require_cuda
from pfn_tpu_torch.evals import tabular as tab
from pfn_tpu_torch.train import TrainConfig, bce_criterion, build_model, restore_checkpoint, save_checkpoint, train


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the current CUDA device)")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--prior", default="mlp", choices=["mlp", "binarized_gp", "mlp_gp_mixture"])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--bptt", type=int, default=100)
    p.add_argument("--eval_positions", type=int, nargs="+", default=[30])
    p.add_argument("--num_features", type=int, default=None)
    p.add_argument("--max_samples", type=int, default=20)
    p.add_argument("--baselines", nargs="+", default=["logistic", "knn", "xgb"],
                   help="subset of: logistic knn gp bayes_net xgb catboost hgb (hgb = the HistGradientBoosting "
                        "stand-in for the xgb/catboost columns)")
    p.add_argument("--out", default="results/tabular")
    p.add_argument("--checkpoint", default=None, help="save the trained model's state_dict here")
    p.add_argument("--load", default=None, help="skip training, load a state_dict saved by --checkpoint")
    p.add_argument("--checkpoint_dir", default=None,
                   help="full-state checkpoint/resume dir for the meta-training (train() resumes from the newest "
                        "checkpoint)")
    p.add_argument("--checkpoint_every", type=int, default=50)
    p.add_argument("--suite", default="auto", choices=["auto", "reference", "sklearn", "both"],
                   help="dataset suite: the reference's bundled svmlight/CSV files, the sklearn suite, or both; "
                        "auto = reference when --ref_root is a directory, else sklearn")
    p.add_argument("--ref_root", default=None, help="directory with the reference's bundled dataset files")
    p.add_argument("--ensemble", type=int, default=1,
                   help="PFN inference-time ensemble size: feature permutations + label flips, probabilities "
                        "averaged (1 = reference protocol)")
    p.add_argument("--no_categorical", action="store_true",
                   help="disable categorical feature discretization in the MLP prior")
    return p


def load_datasets(args) -> list:
    suite = args.suite
    if suite == "auto":
        suite = "reference" if args.ref_root and os.path.isdir(args.ref_root) else "sklearn"
    if suite in ("reference", "both") and not args.ref_root:
        raise SystemExit(f"--suite {suite} needs --ref_root")
    datasets = []
    if suite in ("reference", "both"):
        datasets += load_reference_benchmark(args.ref_root, max_samples=400)
    if suite in ("sklearn", "both"):
        datasets += load_local_benchmark(max_samples=400)
    print(f"suite={suite}: {[d[0] for d in datasets]}")
    return datasets


def build_prior(args, num_features: int):
    from pfn_tpu_torch.priors import BatchMixture, BinarizedPrior, GPMixPrior, MLPPrior, binarized_gp_prior
    from pfn_tpu_torch.priors.hyper import UniformInt

    if args.prior == "binarized_gp":
        return binarized_gp_prior(num_features=num_features)
    # num_features_used drawn per group, as the reference's tabular
    # hyperparameters (tabular.py:47-70): real datasets of any width up to
    # num_features are in distribution after zero-padding.
    prior = MLPPrior(num_features=num_features, is_binary_classification=True, is_causal=False,
                     categorical_x=not args.no_categorical, num_features_used=UniformInt(1, num_features + 1))
    if args.prior == "mlp_gp_mixture":
        # 20 % binarized GP-hyperprior datasets blended into the MLP stream.
        prior = BatchMixture(components=(prior, BinarizedPrior(base=GPMixPrior(num_features=min(8, num_features)),
                                                               num_outputs=1)), weights=(0.8, 0.2))
    return prior


def train_config(args, device) -> TrainConfig:
    ck = dict(checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every if args.checkpoint_dir else 0)
    if args.quick:
        return TrainConfig(emsize=64, nhid=128, nlayers=3, nhead=4, bptt=args.bptt, batch_size=32,
                           epochs=args.epochs or 20, steps_per_epoch=30, lr=1e-3, warmup_epochs=4, device=device,
                           **ck)
    # TabularEvalSimple.ipynb cells 9-10.
    return TrainConfig(emsize=512, nhid=1024, nlayers=6, nhead=4, bptt=args.bptt, batch_size=256,
                       epochs=args.epochs or 300, steps_per_epoch=100, lr=1e-4, warmup_epochs=25,
                       attention_impl="auto", device=device, **ck)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = torch.device("cpu") if args.cpu else require_cuda()
    datasets = load_datasets(args)
    data_width = max(d[1].shape[1] for d in datasets)
    num_features = args.num_features or max(data_width, 30 if args.quick else 60)
    prior = build_prior(args, num_features)
    cfg = train_config(args, device)

    criterion = bce_criterion()
    if args.load:
        model = build_model(prior, criterion, cfg)
        model.load_state_dict(restore_checkpoint(args.load, map_location=device)["model"], strict=True)
        model.eval()
    else:
        result = train(prior, criterion, cfg)
        model = result.model
        print(f"trained: final loss {result.final_loss:.4f}")
        if args.checkpoint:
            save_checkpoint(args.checkpoint, {"model": model.state_dict()})

    os.makedirs(args.out, exist_ok=True)
    all_results = {}
    # The PFN's cache lives in a model-tagged directory: the protocol's cache
    # key cannot see which model made the numbers. The baselines' caches
    # depend on no model.
    pfn_cache = os.path.join(args.out, f"pfn_{args.prior}_e{cfg.epochs}_em{cfg.emsize}_f{num_features}")
    pfn_res = tab.evaluate(datasets, model, "pfn", args.bptt, args.eval_positions, max_samples=args.max_samples,
                           cache_dir=pfn_cache, num_features=num_features, ensemble=args.ensemble)
    all_results["pfn"] = pfn_res["mean_metric"]
    print(f"PFN mean AUC: {pfn_res['mean_metric']:.4f}")

    metric_fns = {
        "logistic": tab.logistic_metric,
        "knn": tab.knn_metric,
        "gp": tab.gp_metric,
        "bayes_net": functools.partial(tab.bayes_net_metric, device=device),
        "xgb": tab.xgb_metric,
        "catboost": tab.catboost_metric,
        "hgb": tab.hist_gb_metric,
    }
    for name in args.baselines:
        if name not in metric_fns:
            print(f"{name}: skipped (no such baseline)")
            continue
        try:
            res = tab.evaluate(datasets, metric_fns[name], name, args.bptt, args.eval_positions,
                               max_samples=args.max_samples, cache_dir=args.out)
        except ImportError as e:  # a package the baseline needs is not installed
            print(f"{name}: skipped ({e})")
            continue
        all_results[name] = res["mean_metric"]
        print(f"{name} mean AUC: {res['mean_metric']:.4f}")

    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(all_results, f, indent=2)
    print(f"wrote {args.out}/summary.json")
    return all_results


if __name__ == "__main__":
    main()
