"""PFN-driven Bayesian optimisation against random search on GP-prior
objectives.

Port of ``experiments/bayesopt_eval.py``. The reference ships only a
truncated acquisition stub (acquisition_functions.py:5-16) and the bar
head's EI (bar_distribution.py:69-80); this driver meta-trains a GP-prior
PFN, then optimises functions drawn from the same prior, one forward pass
per iteration scoring every candidate, and reports the simple regret of EI
and UCB (beta 1.5) against random search on the same budget.

    python -m pfn_tpu_torch.experiments.bayesopt_eval --quick
    python -m pfn_tpu_torch.experiments.bayesopt_eval --cpu --quick

It runs on the current CUDA device (an error without one) unless ``--cpu``
is given, and writes ``results/bayesopt_<quick|full>.json`` (or ``--out``)
with the JAX script's keys, then prints the regret table. Each objective is
a GP draw over the candidate grid, from a generator seeded 1000 + its index
on the device; EI and UCB start from the same initial points.
``main(argv)`` returns the payload.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from pfn_tpu_torch.bayesopt import PFNOptimizer, initial_indices, optimize
from pfn_tpu_torch.device import require_cuda
from pfn_tpu_torch.distributions import get_bucket_limits
from pfn_tpu_torch.ops.gp_sample import gp_sample_paths
from pfn_tpu_torch.priors import GPPrior
from pfn_tpu_torch.train import TrainConfig, bar_criterion, train

GP_HP = dict(noise=1e-2, outputscale=1.0, lengthscale=0.3)
NUM_BUCKETS, BUCKET_RANGE = 256, (-4.0, 4.0)
NUM_INIT = 3
# The JAX script's quick and full models.
QUICK = dict(emsize=64, nhid=128, nlayers=3, nhead=4)
FULL = dict(emsize=128, nhid=256, nlayers=4, nhead=4)
UCB_BETA = 1.5


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the current CUDA device)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--num_functions", type=int, default=None)
    p.add_argument("--num_candidates", type=int, default=128)
    p.add_argument("--num_iterations", type=int, default=25)
    p.add_argument("--out", default=None)
    return p


def train_config(args, device) -> TrainConfig:
    """The surrogate's config: QUICK or FULL, bptt max(64, num_init +
    iterations + 10), batch 64, 30 steps an epoch, lr 1e-3."""
    epochs = args.epochs or (60 if args.quick else 400)
    bptt = max(64, NUM_INIT + args.num_iterations + 10)
    return TrainConfig(**(QUICK if args.quick else FULL), epochs=epochs, steps_per_epoch=30, batch_size=64,
                       bptt=bptt, lr=1e-3, warmup_epochs=max(2, epochs // 20), verbose=False,
                       updates_per_call=1 if args.cpu else 10, device=device)


def objective_table(index: int, num_candidates: int, device):
    """(candidates (M, 1), the objective's values at them (M,), the
    generator that drew them, which the run goes on drawing from): one GP
    draw over the grid of M points in [0, 1]."""
    g = torch.Generator(device=device).manual_seed(1000 + index)
    xs = torch.linspace(0.0, 1.0, num_candidates, device=device)[:, None]
    ys = gp_sample_paths(xs[None], GP_HP["lengthscale"], GP_HP["outputscale"], GP_HP["noise"], generator=g)[0]
    return xs, ys, g


def run_function(index: int, optimizers: dict, num_candidates: int, num_iterations: int, device) -> dict:
    """The simple regret after each iteration (num_iterations + 1,) of each
    optimizer and of random search, on objective ``index``."""
    xs, ys, g = objective_table(index, num_candidates, device)
    table, grid = ys.cpu().numpy(), xs[:, 0].cpu().numpy()
    true_best = float(table.max())

    def objective(x):
        return float(table[int(np.abs(grid - float(x[0])).argmin())])

    init = initial_indices(num_candidates, NUM_INIT, g)
    regrets = {}
    for name, opt in optimizers.items():
        _, y_obs = optimize(objective, opt, xs, num_iterations=num_iterations, num_init=NUM_INIT, init_idx=init)
        regrets[name] = true_best - np.maximum.accumulate(y_obs.cpu().numpy())[NUM_INIT - 1:]
    perm = torch.argsort(torch.rand(num_candidates, generator=g, device=device))[: NUM_INIT + num_iterations]
    regrets["random"] = true_best - np.maximum.accumulate(table[perm.cpu().numpy()])[NUM_INIT - 1:]
    return regrets


def summarize(regrets: dict) -> dict:
    summary = {}
    for name, r in regrets.items():
        arr = np.stack(r)  # (num_fns, T + 1)
        summary[name] = {
            "mean_regret": arr.mean(axis=0).tolist(),
            "final_regret": float(arr[:, -1].mean()),
            "iters_to_0.1": float(np.mean([np.argmax(row < 0.1) if (row < 0.1).any() else len(row)
                                           for row in arr])),
        }
    return summary


def regret_table(summary: dict, num_iterations: int) -> str:
    lines = [f"{'iter':>4} {'EI':>8} {'UCB':>8} {'random':>8}"]
    for t in range(0, num_iterations + 1, max(1, num_iterations // 8)):
        lines.append(f"{t:4d} {summary['ei']['mean_regret'][t]:8.3f} {summary['ucb']['mean_regret'][t]:8.3f} "
                     f"{summary['random']['mean_regret'][t]:8.3f}")
    lines.append(f"final regret: EI {summary['ei']['final_regret']:.3f} | UCB {summary['ucb']['final_regret']:.3f} "
                 f"| random {summary['random']['final_regret']:.3f}")
    return "\n".join(lines)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = torch.device("cpu") if args.cpu else require_cuda()
    num_fns = args.num_functions or (8 if args.quick else 32)
    prior = GPPrior(num_features=1, **GP_HP)
    crit = bar_criterion(get_bucket_limits(NUM_BUCKETS, full_range=BUCKET_RANGE))
    cfg = train_config(args, device)
    print(f"training surrogate PFN ({cfg.epochs} epochs, bptt={cfg.bptt})...")
    result = train(prior, crit, cfg)
    print(f"final train loss {result.final_loss:.3f}")

    bar = result.criterion.bar
    optimizers = {"ei": PFNOptimizer(result.model, bar, acquisition="ei"),
                  "ucb": PFNOptimizer(result.model, bar, acquisition="ucb", beta=UCB_BETA)}
    regrets = {"ei": [], "ucb": [], "random": []}
    for f_idx in range(num_fns):
        for name, r in run_function(f_idx, optimizers, args.num_candidates, args.num_iterations, device).items():
            regrets[name].append(r)
    summary = summarize(regrets)

    tag = "quick" if args.quick else "full"
    out_path = args.out or os.path.join("results", f"bayesopt_{tag}.json")
    payload = {"gp_hp": GP_HP, "epochs": cfg.epochs, "num_functions": num_fns, "num_candidates": args.num_candidates,
               "num_iterations": args.num_iterations, "num_init": NUM_INIT, "summary": summary}
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"wrote {out_path}")
    print(regret_table(summary, args.num_iterations))
    return payload


if __name__ == "__main__":
    main()
