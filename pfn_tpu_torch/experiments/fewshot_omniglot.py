"""Few-shot image classification: stroke-prior pretraining, then Omniglot
transfer.

Port of ``experiments/fewshot_omniglot.py`` (reference
notebooks/FewShotOmniglot.ipynb): train a PFN on the synthetic stroke prior
(5-way episodes, bptt 5 * 5 + 1 = 26, emsize 1024 in the notebook), score
its zero-shot accuracy on Omniglot N-way k-shot episodes of held-out classes
(last-position accuracy, priors/omniglot.py:74-98), then warm-start a
finetune on the train classes' episodes (the notebook's
load_weights_from_this_state_dict) and score it again.

Real Omniglot needs torchvision's files on disk (nothing is downloaded);
without them a synthetic stroke-alphabet class bank stands in, and the
transfer is synthetic to unseen synthetic classes through the same pipeline.
The bank and the episodes live on the training device.

    python -m pfn_tpu_torch.experiments.fewshot_omniglot --quick
    python -m pfn_tpu_torch.experiments.fewshot_omniglot --omniglot_root /data/omniglot
    python -m pfn_tpu_torch.experiments.fewshot_omniglot --cpu --quick

It runs on the current CUDA device (an error without one) unless ``--cpu``
is given, and writes ``<out>/summary.json`` with the JAX script's keys.
``main(argv)`` returns the summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from pfn_tpu_torch.data.omniglot import load_omniglot_class_bank, synthetic_class_bank
from pfn_tpu_torch.device import require_cuda
from pfn_tpu_torch.priors import OmniglotPrior, StrokePrior, omniglot_accuracy
from pfn_tpu_torch.train import TrainConfig, ce_criterion, train

# The JAX script's quick config (emsize 64, 2 layers, 4 heads, batch 16).
QUICK = dict(emsize=64, nhid=128, nlayers=2, nhead=4, batch_size=16, steps_per_epoch=20, lr=1e-3, warmup_epochs=2)
# FewShotOmniglot.ipynb cell 2 (experiments/fewshot_omniglot.py:70-77):
# emsize 1024, nhid 2048, 6 layers, 8 heads, batch 64, bptt 26.
FULL = dict(emsize=1024, nhid=2048, nlayers=6, nhead=8, batch_size=64, steps_per_epoch=100, lr=1e-4,
            warmup_epochs=10)
# The synthetic bank's shape and split (the JAX script's).
SYNTHETIC_BANK = dict(seed=7, num_classes=40, per_class=20, num_train_classes=30)
# Accuracy: batches of test episodes.
ACCURACY = dict(batch_size=32, num_batches=4)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the current CUDA device)")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--n_way", type=int, default=5)
    p.add_argument("--k_shot", type=int, default=5)
    p.add_argument("--imgsz", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--finetune_epochs", type=int, default=None)
    p.add_argument("--omniglot_root", default="omniglot")
    p.add_argument("--out", default="results/fewshot")
    return p


def pretrain_config(args, device) -> TrainConfig:
    """The stroke pretraining's config: QUICK or FULL, at bptt n_way k_shot
    + 1, every loss at the last position (fixed sep)."""
    seq_len = args.n_way * args.k_shot + 1
    base, epochs = (QUICK, 12) if args.quick else (FULL, 100)
    return TrainConfig(**base, bptt=seq_len, epochs=args.epochs or epochs, eval_pos_sampler="fixed",
                       fixed_eval_pos=seq_len - 1, device=device)


def finetune_config(cfg: TrainConfig, args) -> TrainConfig:
    """The finetune's config: the pretraining's at a quarter of its LR."""
    return dataclasses.replace(cfg, epochs=args.finetune_epochs or (8 if args.quick else 40),
                               lr=(cfg.lr or 1e-3) / 4, warmup_epochs=2)


def episode_banks(args, imgsz: int, device):
    """(train bank, test bank, source) on ``device``: real Omniglot under
    ``--omniglot_root`` if it is there, else the synthetic bank."""
    try:
        train_bank, test_bank = load_omniglot_class_bank(args.omniglot_root, imgsz=imgsz).to(device).split()
        return train_bank, test_bank, "omniglot"
    except FileNotFoundError:
        s = SYNTHETIC_BANK
        full = synthetic_class_bank(seed=s["seed"], num_classes=s["num_classes"], per_class=s["per_class"],
                                    imgsz=imgsz, device=device)
        train_bank, test_bank = full.split(num_train_classes=s["num_train_classes"])
        return train_bank, test_bank, "synthetic"


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = torch.device("cpu") if args.cpu else require_cuda()
    imgsz = args.imgsz or (12 if args.quick else 28)
    seq_len = args.n_way * args.k_shot + 1

    # Stage 1: pretrain on the stroke prior (the notebook's cells 2-4).
    stroke = StrokePrior(num_features=imgsz * imgsz, num_outputs=args.n_way, only_train_for_last_idx=True)
    crit = ce_criterion(args.n_way)
    cfg = pretrain_config(args, device)
    result = train(stroke, crit, cfg)
    print(f"stroke pretraining: final loss {result.final_loss:.4f}")

    # Stage 2: Omniglot episodes of held-out classes.
    train_bank, test_bank, source = episode_banks(args, imgsz, device)
    print(f"episode source: {source} ({train_bank.num_classes} train / {test_bank.num_classes} test classes)")
    test_prior = OmniglotPrior(test_bank, num_outputs=args.n_way)
    acc_zero = omniglot_accuracy(result.model, test_prior, seq_len=seq_len, **ACCURACY)
    print(f"zero-shot transfer accuracy: {acc_zero:.3f} (chance {1 / args.n_way:.3f})")

    # Stage 3: finetune on the train classes' episodes from the pretrained
    # weights (the notebook's cell 5 warm start).
    ft_prior = OmniglotPrior(train_bank, num_outputs=args.n_way)
    ft = train(ft_prior, crit, finetune_config(cfg, args), init_params=result.model.state_dict())
    acc_ft = omniglot_accuracy(ft.model, test_prior, seq_len=seq_len, **ACCURACY)
    print(f"finetuned accuracy: {acc_ft:.3f}")

    summary = {"source": source, "n_way": args.n_way, "k_shot": args.k_shot, "zero_shot_acc": acc_zero,
               "finetuned_acc": acc_ft, "chance": 1 / args.n_way}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"wrote {args.out}/summary.json")
    return summary


if __name__ == "__main__":
    main()
