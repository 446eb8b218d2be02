"""Statistically robust Fig-3a eval of a trained bptt=2010 checkpoint: the
single-draw estimator.

Port of ``experiments/fig3a_robust_eval.py``. Per-position NLL is heavy-tailed
across prior draws, so this script scores many chunks of datasets, keeps the
full (P, N) per-dataset loss matrix, and reports the mean, median and a
bootstrap CI of the per-position gap against the float64 exact-GP oracle.
``fig3a_analytic_gap --data <this out>`` compares its variance with the
analytic estimator's on the same datasets.

Phase A: the PFN's per-dataset positional NLL over ``--chunks`` chunks of
``--chunk_batch`` datasets from the exact sampler. Phase B (``--oracle_pass``,
also run after A): the chunked f64 exact-GP oracle at the nominal noise and
at 1e-3, on the same device, in process.

    python -m pfn_tpu_torch.experiments.fig3a_robust_eval --ck results/fig3a/ck \\
        --out results/fig3a/robust_eval
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from pfn_tpu_torch.evals import eval_positional_loss_per_dataset, gp_exact_evaluate
from pfn_tpu_torch.experiments.common import (
    FIG3A_MODEL,
    GP_HP,
    POSITIONS,
    add_device_argument,
    bucket_criterion,
    resolve_device,
    restore_model,
)
from pfn_tpu_torch.priors import GPPrior

EFFECTIVE_NOISE = 1e-3
BOOTSTRAP = 1000


def oracle_pass(out_dir: str, chunk: int, device) -> dict:
    """Phase B: the f64 oracle NLL at the nominal noise and at 1e-3, chunk by
    chunk (each chunk kept in its own file, so a killed run resumes); writes
    oracle_per_dataset.npz ((P, N) each)."""
    data = np.load(os.path.join(out_dir, "eval_data.npz"))
    x, y, positions = data["x"], data["y"], data["positions"].tolist()
    per_nominal, per_eff = [], []
    for s in range(0, len(x), chunk):
        part = os.path.join(out_dir, f"oracle_chunk_{s // chunk:03d}.npz")
        if os.path.exists(part):
            p = np.load(part)
            all_n, all_e = p["nominal"], p["effective"]
        else:
            xb, yb = (torch.as_tensor(a[s: s + chunk], device=device) for a in (x, y))
            all_n = gp_exact_evaluate(xb, yb, GP_HP, positions=positions, dtype=torch.float64)[0].cpu().numpy()
            all_e = gp_exact_evaluate(xb, yb, dict(GP_HP, noise=EFFECTIVE_NOISE), positions=positions,
                                      dtype=torch.float64)[0].cpu().numpy()
            np.savez(part, nominal=all_n, effective=all_e)
        per_nominal.append(all_n)  # (P, chunk)
        per_eff.append(all_e)
        print(f"oracle chunk {s // chunk + 1} done", flush=True)
    out = {"nominal": np.concatenate(per_nominal, axis=1), "effective": np.concatenate(per_eff, axis=1)}
    np.savez(os.path.join(out_dir, "oracle_per_dataset.npz"), **out)
    return out


def write_stats(out_dir: str, label: str, pfn_mat: np.ndarray, orc, positions, checkpoint: str) -> dict:
    """The gap's mean, median and 95 % bootstrap CI per context size against
    both oracles (numpy, ``np.random.default_rng(0)``, as the JAX script);
    writes robust_eval.json."""
    rng = np.random.default_rng(0)
    out = {"positions": np.asarray(positions).tolist(), "n_datasets": int(pfn_mat.shape[1]),
           "checkpoint": checkpoint, "label": label}
    for name in ("nominal", "effective"):
        gap = pfn_mat - orc[name]  # (P, N)
        boots = np.stack([gap[:, rng.integers(0, gap.shape[1], gap.shape[1])].mean(axis=1)
                          for _ in range(BOOTSTRAP)])  # (BOOTSTRAP, P)
        out[f"gap_mean_{name}"] = gap.mean(axis=1).tolist()
        out[f"gap_median_{name}"] = np.median(gap, axis=1).tolist()
        out[f"gap_ci95_{name}"] = np.stack([np.percentile(boots, 2.5, axis=0),
                                            np.percentile(boots, 97.5, axis=0)]).T.tolist()
    with open(os.path.join(out_dir, "robust_eval.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nrobust eval over {out['n_datasets']} datasets (gap vs effective-noise f64 oracle):")
    for i, t in enumerate(out["positions"]):
        lo, hi = out["gap_ci95_effective"][i]
        print(f"  ctx={t:4d} mean={out['gap_mean_effective'][i]:7.4f} "
              f"median={out['gap_median_effective'][i]:7.4f} ci95=[{lo:7.4f},{hi:7.4f}]")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(p)
    p.add_argument("--ck", default="results/fig3a/ck")
    p.add_argument("--out", default="results/fig3a/robust_eval")
    p.add_argument("--chunks", type=int, default=8)
    p.add_argument("--chunk_batch", type=int, default=32)
    p.add_argument("--bptt", type=int, default=2010)
    p.add_argument("--num_buckets", type=int, default=1000)
    p.add_argument("--seed", type=int, default=991)
    p.add_argument("--oracle_pass", action="store_true")
    p.add_argument("--oracle_chunk", type=int, default=32)
    p.add_argument("--stats_only", action="store_true",
                   help="recompute the summary JSON from the saved pfn_per_dataset.npy and oracle_per_dataset.npz")
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.oracle_pass:
        return oracle_pass(args.out, args.oracle_chunk, device)
    if args.stats_only:
        pfn_mat = np.load(os.path.join(args.out, "pfn_per_dataset.npy"))
        orc = np.load(os.path.join(args.out, "oracle_per_dataset.npz"))
        positions = np.load(os.path.join(args.out, "eval_data.npz"))["positions"]
        return write_stats(args.out, args.label, pfn_mat, orc, positions, checkpoint="(stats only)")

    os.makedirs(args.out, exist_ok=True)
    prior = GPPrior(num_features=1, **GP_HP)
    # The bucket seed of fig3a_longrun, so that the criterion matches training.
    criterion = bucket_criterion(prior, args.num_buckets, args.bptt, device, seed=7)
    model, path = restore_model(args.ck, prior, criterion, args.bptt, device, FIG3A_MODEL)
    print(f"restored {path}", flush=True)

    positions = [t for t in POSITIONS if t < args.bptt]
    xs, ys, pfn = [], [], []
    for c in range(args.chunks):
        g = torch.Generator(device=device).manual_seed(args.seed * 1000 + c)
        x, y, target_y = prior.sample(args.chunk_batch, args.bptt, generator=g, device=device)
        per = eval_positional_loss_per_dataset(model, criterion, x, y, target_y, positions=positions)
        xs.append(x.cpu().numpy())
        ys.append(y.cpu().numpy())
        pfn.append(per.float().cpu().numpy())  # (P, B)
        print(f"pfn chunk {c + 1}/{args.chunks} done", flush=True)
    np.savez(os.path.join(args.out, "eval_data.npz"), x=np.concatenate(xs), y=np.concatenate(ys),
             positions=np.asarray(positions))
    pfn_mat = np.concatenate(pfn, axis=1)  # (P, N)
    np.save(os.path.join(args.out, "pfn_per_dataset.npy"), pfn_mat)

    orc_path = os.path.join(args.out, "oracle_per_dataset.npz")
    # The oracle depends only on (seed, chunks, chunk_batch, bptt): for a
    # second checkpoint scored on the same datasets, copy the first run's
    # oracle_per_dataset.npz into --out to skip this pass.
    orc = np.load(orc_path) if os.path.exists(orc_path) else oracle_pass(args.out, args.oracle_chunk, device)
    return write_stats(args.out, args.label, pfn_mat, orc, positions, checkpoint=path)


if __name__ == "__main__":
    main()
