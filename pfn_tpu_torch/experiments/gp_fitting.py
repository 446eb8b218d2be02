"""Fig-3a pipeline: PFN training, then NLL against context size beside the
exact-GP oracle.

Port of ``experiments/gp_fitting.py``, itself at parity with the reference
notebook SetupForGPFittingExperiments.ipynb: cell 5's training grid (full
config: bptt 2010, emsize 512, 4 heads, 6 layers, nhid 1024, a full-support
bar head on 1000 buckets estimated from 100k sampled ys, batch 4 x 25
aggregated microbatches, the weighted eval-position sampler, GP noise 1e-4,
outputscale 1.0, lengthscale 0.6), then cell 6's PFN NLL at each context size
against cell 3's exact-GP NLL.

    python -m pfn_tpu_torch.experiments.gp_fitting --quick          # small config
    python -m pfn_tpu_torch.experiments.gp_fitting                  # the Fig-3a config
    python -m pfn_tpu_torch.experiments.gp_fitting --quick --device cpu

It writes ``<out>/curves.json`` with the JAX script's keys and prints the
mean PFN-minus-oracle NLL gap.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from pfn_tpu_torch.evals import eval_positional_loss, gp_exact_evaluate
from pfn_tpu_torch.experiments.common import FIG3A_MODEL, GP_HP, add_device_argument, bucket_criterion, resolve_device
from pfn_tpu_torch.priors import GPPrior
from pfn_tpu_torch.train import TrainConfig, save_checkpoint, train

# The quick config (emsize 128, 4 heads of 32, 4 layers, bptt 100, f32).
QUICK = dict(emsize=128, nhid=256, nlayers=4, nhead=4, batch_size=64, steps_per_epoch=60, warmup_epochs=5,
             updates_per_call=10)
EVAL_DATASETS = 128


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(p)
    p.add_argument("--quick", action="store_true", help="small config, minutes on one card")
    p.add_argument("--bptt", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--num_buckets", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--out", default="results/gp_fitting")
    p.add_argument("--checkpoint", default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.quick:
        bptt = args.bptt or 100
        cfg = TrainConfig(**QUICK, bptt=bptt, epochs=args.epochs or 40, lr=args.lr or 1e-3,
                          eval_pos_sampler="weighted", device=device)
        num_buckets = args.num_buckets or 200
    else:
        # The Fig-3a grid point (notebook cell 5; epochs there go up to 10000).
        bptt = args.bptt or 2010
        cfg = TrainConfig(**FIG3A_MODEL, bptt=bptt, batch_size=4, aggregate_k_gradients=25,
                          epochs=args.epochs or 1250, steps_per_epoch=100, lr=args.lr or 1e-4, warmup_epochs=20,
                          eval_pos_sampler="weighted", eval_pos_max=min(2000, bptt), dtype=torch.bfloat16,
                          device=device)
        num_buckets = args.num_buckets or 1000

    prior = GPPrior(num_features=1, **GP_HP)
    criterion = bucket_criterion(prior, num_buckets, bptt, device)  # cell 5: 100k sampled ys

    print(f"training: bptt={bptt} buckets={num_buckets} epochs={cfg.epochs} device={device}")
    result = train(prior, criterion, cfg)

    # Evaluation: the PFN curve against the exact-GP oracle (cells 3 and 6).
    eval_T = min(bptt, 200)
    g = torch.Generator(device=device).manual_seed(1234)
    x, y, target_y = prior.sample(EVAL_DATASETS, eval_T, generator=g, device=device)
    positions = list(range(1, eval_T, max(1, eval_T // 50)))
    pfn_nll, _ = eval_positional_loss(result.model, result.criterion, x, y, target_y, positions=positions)
    _, oracle_nll, secs = gp_exact_evaluate(x, y, GP_HP, start_pos=1)
    oracle_at = oracle_nll[torch.as_tensor(positions, device=oracle_nll.device) - 1]

    os.makedirs(args.out, exist_ok=True)
    out = {
        "positions": positions,
        "pfn_nll": pfn_nll.tolist(),
        "oracle_nll": oracle_at.tolist(),
        "final_train_loss": result.final_loss,
        "oracle_seconds": secs,
    }
    with open(os.path.join(args.out, "curves.json"), "w") as f:
        json.dump(out, f, indent=2)

    gap = float(np.mean(np.asarray(out["pfn_nll"]) - np.asarray(out["oracle_nll"])))
    print(f"mean PFN-minus-oracle NLL gap: {gap:.4f} nats")
    print(f"wrote {args.out}/curves.json")

    if args.checkpoint:
        save_checkpoint(args.checkpoint, {"model": result.model.state_dict()})
        print(f"saved {args.checkpoint}")
    return {**out, "mean_gap": gap, "epoch_stats": result.epoch_stats}


if __name__ == "__main__":
    main()
