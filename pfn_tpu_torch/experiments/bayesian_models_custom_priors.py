"""Custom (BNN) prior, PFN training, then the PFN against SVI and MCMC.

Port of ``experiments/bayesian_models_custom_priors.py`` (reference
notebooks/BayesianModels_And_Custom_Pyro_Modules.ipynb and
mcmc_svi_transformer_on_bayesian.py, the Fig-2-style experiment):
  1. a Bayesian NN prior (``evals.comparison.BayesianNNModel``; any sampler
     works through ``priors.module.ModulePrior``);
  2. a PFN meta-trained on datasets drawn from it (the reference config: lr
     2.006434e-5, 160 epochs of 100 steps, emsize 256, nhid 512, 5 layers, 4
     heads, bptt 300, batch 256; mcmc_svi_transformer_on_bayesian.py:70-83),
     in ``TrainConfig``'s default f32: at bptt 300 its attention runs the
     flash f32 kernels at head dim 64;
  3. the PFN, SVI and HMC on a fixed-seed eval set.

    python -m pfn_tpu_torch.experiments.bayesian_models_custom_priors --quick
    python -m pfn_tpu_torch.experiments.bayesian_models_custom_priors --size big --epochs 400
    python -m pfn_tpu_torch.experiments.bayesian_models_custom_priors --cpu --quick

It runs on the current CUDA device (an error without one) unless ``--cpu``
is given, and writes ``<out>/summary.json`` with the JAX script's keys; the
eval set comes from a generator seeded 0 on that device. ``main(argv)``
returns the summary.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from pfn_tpu_torch.device import require_cuda
from pfn_tpu_torch.evals import comparison
from pfn_tpu_torch.train import TrainConfig, bce_criterion, save_checkpoint, train

# The quick config of the JAX script (emsize 64, 4 heads of 16, 3 layers).
QUICK = dict(emsize=64, nhid=128, nlayers=3, nhead=4, batch_size=64, steps_per_epoch=50, lr=1e-3, warmup_epochs=5)
# The reference config (mcmc_svi_transformer_on_bayesian.py:70-83).
REFERENCE = dict(emsize=256, nhid=512, nlayers=5, nhead=4, batch_size=256, steps_per_epoch=100, lr=2.006434e-5)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the current CUDA device)")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--size", default="small", help="small | big | F_E_N")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--bptt", type=int, default=None)
    p.add_argument("--training_samples", type=int, default=None)
    p.add_argument("--out", default="results/bayesian_models")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--methods", nargs="+", default=["transformer", "svi", "mcmc"])
    return p


def train_config(args, device) -> tuple[TrainConfig, int, int]:
    """(the training config, the context size of the eval, the number of
    eval datasets) for the parsed ``args``."""
    if args.quick:
        cfg = TrainConfig(**QUICK, bptt=args.bptt or 60, epochs=args.epochs or 30, device=device)
        return cfg, args.training_samples or 30, 20
    epochs = args.epochs or 160
    cfg = TrainConfig(**REFERENCE, bptt=args.bptt or 300, epochs=epochs, warmup_epochs=min(20, epochs // 4),
                      device=device)
    return cfg, args.training_samples or 100, 100


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = torch.device("cpu") if args.cpu else require_cuda()
    spec = comparison.default_model_spec(args.size)
    cfg, n_train, eval_sets = train_config(args, device)

    result = train(spec.as_prior(), bce_criterion(), cfg)
    print(f"PFN trained: final loss {result.final_loss:.4f}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, {"model": result.model.state_dict()})

    # The fixed-seed eval set (reference :195-207).
    X, y = comparison.generate_toy_data(spec, cfg.bptt, torch.Generator(device=device).manual_seed(0),
                                        n_samples=eval_sets)

    os.makedirs(args.out, exist_ok=True)
    summary = {}
    if "transformer" in args.methods:
        acc, nll, secs = comparison.eval_transformer(X, y, result.model, n_train)
        summary["transformer"] = dict(acc=float(np.mean(acc)), nll=float(np.mean(nll)), seconds=secs)
        print(f"PFN: acc {np.mean(acc):.3f} nll {np.mean(nll):.3f} in {secs:.3f}s")
    steps = 64 if args.quick else 1024
    if "svi" in args.methods:
        nll, acc = comparison.eval_svi(X, y, spec, n_train, steps, steps)
        summary["svi"] = dict(acc=float(np.mean(acc)), nll=float(np.mean(nll)))
        print(f"SVI({steps}): acc {np.mean(acc):.3f} nll {np.mean(nll):.3f}")
    if "mcmc" in args.methods:
        mc = 64 if args.quick else 512
        nll, acc = comparison.eval_mcmc(X, y, spec, n_train, mc, mc)
        summary["mcmc"] = dict(acc=float(np.mean(acc)), nll=float(np.mean(nll)))
        print(f"MCMC({mc}): acc {np.mean(acc):.3f} nll {np.mean(nll):.3f}")

    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"wrote {args.out}/summary.json")
    return summary


if __name__ == "__main__":
    main()
