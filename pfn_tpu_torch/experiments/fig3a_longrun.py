"""Resumable Fig-3a training at bptt=2010 (the paper's long-sequence config).

Port of ``experiments/fig3a_longrun.py``. It runs the notebook's grid point
(SetupForGPFittingExperiments cell 5) with a full-state checkpoint every
``--checkpoint_every`` epochs under ``<out>/ck``; running it again resumes
from the newest checkpoint there, so a long run goes in bounded slots. Once
the target epoch count is reached it scores the PFN against the exact-GP
oracle at the context sizes of ``common.POSITIONS`` and writes
``<out>/curves.json``.

    python -m pfn_tpu_torch.experiments.fig3a_longrun --epochs 500   # repeat until done
    python -m pfn_tpu_torch.experiments.fig3a_longrun --grid 8192 --eval_pos_sampler mixture \\
        --num_buckets 10000 --bucket_seq_cap 128 --epochs 2000

The oracle pass (``--oracle_pass``, also run after training) takes the
float64 exact-GP NLL on the same device, in process, at the nominal noise and
at the sampler's effective noise.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from pfn_tpu_torch.evals import eval_positional_loss, gp_exact_evaluate
from pfn_tpu_torch.experiments.common import (
    FIG3A_MODEL,
    GP_HP,
    POSITIONS,
    add_device_argument,
    bucket_criterion,
    resolve_device,
)
from pfn_tpu_torch.priors import GPPrior
from pfn_tpu_torch.train import TrainConfig, latest_state_checkpoint, restore_checkpoint, train


def oracle_pass(out_dir: str, device, effective_noise: float = 1e-3) -> dict:
    """Phase B: the exact-GP oracle in float64 on ``device`` at the nominal
    noise and at ``effective_noise``, on the datasets of
    ``<out_dir>/eval_data.npz``; writes ``<out_dir>/oracle.json``.

    f32 is not enough here: at T ~ 2000 with noise 1e-4 the masked Cholesky
    needs ~1e-3 of jitter to factor in f32, which inflates the predictive
    variance ~10x. The second pass is at the sampler's measured effective
    noise: ~1e-3 for the exact per-dataset f32 Cholesky sampler at T ~ 2000,
    the nominal noise for the grid sampler (its latent comes from an
    f64-factored constant; ``grid_fidelity`` measures it), where the two
    curves coincide."""
    data = np.load(os.path.join(out_dir, "eval_data.npz"))
    x, y = (torch.as_tensor(data[k], device=device) for k in ("x", "y"))
    positions = data["positions"].tolist()
    _, oracle_at, secs = gp_exact_evaluate(x, y, GP_HP, positions=positions, dtype=torch.float64)
    _, oracle_eff, secs2 = gp_exact_evaluate(x, y, dict(GP_HP, noise=effective_noise), positions=positions,
                                             dtype=torch.float64)
    out = {
        "oracle_nll": oracle_at.tolist(),
        "oracle_nll_noise1e-3": oracle_eff.tolist(),
        "effective_noise": effective_noise,
        "seconds": secs + secs2,
    }
    with open(os.path.join(out_dir, "oracle.json"), "w") as f:
        json.dump(out, f)
    print(f"oracle (f64, {device}, nominal + effective noise) done in {secs + secs2:.1f}s")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(p)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--bptt", type=int, default=2010)
    p.add_argument("--num_buckets", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--checkpoint_every", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=4,
                   help="microbatch size; with --agg it keeps the notebook's schedule (100 datasets an update, 4 "
                        "updates an epoch) as long as batch_size * agg == 100")
    p.add_argument("--agg", type=int, default=25, help="aggregate_k_gradients (microbatches per update)")
    p.add_argument("--out", default="results/fig3a")
    p.add_argument("--eval_batch", type=int, default=32)
    p.add_argument("--skip_eval", action="store_true")
    p.add_argument("--oracle_pass", action="store_true")
    p.add_argument("--grid", type=int, default=0,
                   help="G > 0: sample the GP prior on a fixed G-point grid (ops/gp_sample.py:gp_sample_paths_grid) "
                        "instead of a per-dataset f32 Cholesky every step; removes the exact sampler's ~1e-3 "
                        "effective-noise confound. It changes the x distribution, so set it on fresh runs (or a "
                        "resume of an exact-sampler lineage, as the reference's round 5) and score with a matching "
                        "--grid. 8192 at bptt 2010.")
    p.add_argument("--effective_noise", type=float, default=None,
                   help="the sampler's effective noise for the second oracle pass (default: 1e-3 for the exact "
                        "f32 sampler, the nominal noise when --grid > 0)")
    p.add_argument("--eval_pos_sampler", default="weighted", choices=["weighted", "uniform", "mixture"],
                   help="weighted = notebook parity (p(sep) ~ 1/(max - sep)); uniform = small-context patch "
                        "schedule; mixture = 0.9 weighted + 0.1 uniform capped at 300 (utils/samplers.py)")
    p.add_argument("--eval_pos_max", type=int, default=None,
                   help="cap on the sampled sep (default min(2000, bptt))")
    p.add_argument("--bucket_seq_cap", type=int, default=None,
                   help="cap the per-dataset seq_len of the bucket-estimation sample (a wider equal-mass span); it "
                        "changes the criterion, so set it on fresh runs only")
    p.add_argument("--init_from", default=None,
                   help="start from the weights of the newest checkpoint in this ck dir (a fresh optimizer); "
                        "ignored once --out holds checkpoints of its own")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    eff_noise = args.effective_noise
    if eff_noise is None:
        eff_noise = GP_HP["noise"] if args.grid > 0 else 1e-3

    if args.oracle_pass:
        return oracle_pass(args.out, device, effective_noise=eff_noise)

    os.makedirs(args.out, exist_ok=True)
    prior = GPPrior(num_features=1, grid=args.grid, **GP_HP)
    # Seeded bucket estimation: a resumed run keeps the identical criterion.
    criterion = bucket_criterion(prior, args.num_buckets, args.bptt, device, seed=7, max_seq_len=args.bucket_seq_cap)

    if args.batch_size * args.agg != 100:
        raise SystemExit("keep the notebook schedule: batch_size * agg must equal 100 datasets an update "
                         f"(got {args.batch_size} x {args.agg})")
    cfg = TrainConfig(
        **FIG3A_MODEL, bptt=args.bptt, batch_size=args.batch_size, aggregate_k_gradients=args.agg,
        epochs=args.epochs, steps_per_epoch=4 * args.agg, lr=args.lr, warmup_epochs=max(2, args.epochs // 25),
        eval_pos_sampler=args.eval_pos_sampler, eval_pos_max=args.eval_pos_max or min(2000, args.bptt),
        dtype=torch.bfloat16, checkpoint_dir=os.path.join(args.out, "ck"), checkpoint_every=args.checkpoint_every,
        device=device,
    )
    init_params = None
    if args.init_from:
        if latest_state_checkpoint(cfg.checkpoint_dir) is not None:
            print("own checkpoints exist; resuming those (ignoring --init_from)")
        else:
            latest = latest_state_checkpoint(args.init_from)
            if latest is None:
                raise SystemExit(f"--init_from {args.init_from}: no checkpoints")
            init_params = restore_checkpoint(latest[0], map_location=device)["model"]
            print(f"warm-started params from {latest[0]}")
    result = train(prior, criterion, cfg, init_params=init_params)
    last = result.epoch_stats[-1]["epoch"] if result.epoch_stats else args.epochs
    done = last >= args.epochs
    print(f"trained through epoch {last} (target {args.epochs}); {'DONE' if done else 'rerun to continue'}")
    summary = {"epoch_stats": result.epoch_stats, "done": done, "model": result.model}
    if not done or args.skip_eval:
        return summary

    # Phase A: the PFN's positional NLL; the eval data are saved so that the
    # oracle pass scores the identical datasets.
    eval_T = args.bptt
    g = torch.Generator(device=device).manual_seed(1234)
    x, y, target_y = prior.sample(args.eval_batch, eval_T, generator=g, device=device)
    positions = [t for t in POSITIONS if t < eval_T]
    pfn_nll, _ = eval_positional_loss(result.model, result.criterion, x, y, target_y, positions=positions)
    np.savez(os.path.join(args.out, "eval_data.npz"), x=x.cpu().numpy(), y=y.cpu().numpy(),
             positions=np.asarray(positions))

    # Phase B: the f64 oracle, on the same device.
    oracle = oracle_pass(args.out, device, effective_noise=eff_noise)
    out = {
        "positions": positions,
        "pfn_nll": pfn_nll.tolist(),
        "oracle_nll": oracle["oracle_nll"],
        "oracle_nll_noise1e-3": oracle["oracle_nll_noise1e-3"],
        "final_train_loss": result.final_loss,
        "oracle_seconds": oracle["seconds"],
        "epochs": args.epochs,
        "bucket_seq_cap": args.bucket_seq_cap,
        "grid": args.grid,
        "effective_noise": eff_noise,
        "note": "oracle_nll_noise1e-3 = f64 oracle at the sampler's measured effective noise (1e-3 for the exact "
                "f32 sampler at T=2010; nominal when --grid > 0).",
    }
    with open(os.path.join(args.out, "curves.json"), "w") as f:
        json.dump(out, f, indent=2)
    # The gap against the effective-noise oracle: the honest comparison for
    # data the sampler produced (the nominal-noise gap follows from the JSON).
    gap = np.asarray(out["pfn_nll"]) - np.asarray(oracle["oracle_nll_noise1e-3"])
    print(f"mean gap {gap.mean():.4f} nats (vs effective-noise oracle); per-position:")
    for t, gp in zip(positions, gap.tolist()):
        print(f"  ctx={t:4d} gap={gp:.4f}")
    return {**summary, **out}


if __name__ == "__main__":
    main()
