"""Sweep microbatch x gradient-accumulation shapes of the bptt=2010 Fig-3a
config.

Port of ``experiments/batch_shape_sweep.py``. The reference trains bptt
2010 with batch 4 x aggregate_k 25 (notebook SetupForGPFittingExperiments
cell 5), a shape forced by its GPU materialising the (B, H, T, T) scores;
the flash kernels lift that constraint. The sweep holds the OPTIMIZATION
SCHEDULE fixed (100 datasets an update, 4 updates an epoch, 400 datasets an
epoch) and varies only how the 100 datasets split into microbatches:

    (B=4,  agg=25)  (B=10, agg=10)  (B=20, agg=5)
    (B=25, agg=4)   (B=50, agg=2)   (B=100, agg=1)

Each config times ``--epochs_timed`` epoch-equivalents (4 updates each) after
two warm-up updates, the clock read after a device sync. It writes
``--out`` (default results/batch_sweep.json) with the s/epoch of each shape
and the winner, merging into an existing file: a timed shape is skipped, a
failed one is tried again.

    python -m pfn_tpu_torch.experiments.batch_shape_sweep [--shapes 4x25,100x1] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from pfn_tpu_torch.experiments.common import (
    FIG3A_MODEL,
    GP_HP,
    add_device_argument,
    bucket_criterion,
    resolve_device,
    synchronize,
)
from pfn_tpu_torch.priors import GPPrior
from pfn_tpu_torch.train import TrainConfig, TrainState, build_model
from pfn_tpu_torch.train.loop import _make_optimizer, make_train_step

SHAPES = [(4, 25), (10, 10), (20, 5), (25, 4), (50, 2), (100, 1)]


def sweep_config(batch_size: int, agg: int, bptt: int, device) -> TrainConfig:
    """The sweep's TrainConfig of one shape (the JAX script's :49-55)."""
    return TrainConfig(**FIG3A_MODEL, bptt=bptt, batch_size=batch_size, aggregate_k_gradients=agg,
                       steps_per_epoch=4 * agg, epochs=1, lr=1e-4, warmup_epochs=1, eval_pos_sampler="weighted",
                       eval_pos_max=min(2000, bptt), dtype=torch.bfloat16, verbose=False, device=device)


def _check_finite(loss: float, where: str) -> None:
    if not math.isfinite(loss):
        raise FloatingPointError(f"non-finite {where} loss {loss}")


def time_config(batch_size: int, agg: int, bptt: int, epochs_timed: int = 2, device=None) -> float:
    """Seconds per epoch-equivalent (4 updates of ``agg`` microbatches of
    ``batch_size`` datasets) of the exact-GP Fig-3a config with the
    full-support bar on 1000 buckets (borders from 100k ys, seed 7)."""
    device = resolve_device(device)
    prior = GPPrior(num_features=1, **GP_HP)
    criterion = bucket_criterion(prior, 1000, bptt, device, seed=7)
    cfg = sweep_config(batch_size, agg, bptt, device)
    model = build_model(prior, criterion, cfg)
    optimizer, _, schedule = _make_optimizer(cfg, model)
    state = TrainState(model, optimizer, torch.Generator(device=device).manual_seed(1))
    step = make_train_step(prior, criterion, cfg, schedule)

    for _ in range(2):  # warm-up: the first update, then a steady one
        metrics = step(state)
    _check_finite(float(metrics["loss"]), "warm-up")
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(4 * epochs_timed):  # 4 updates per epoch-equivalent
        metrics = step(state)
    loss = float(metrics["loss"])
    synchronize(device)
    dt = time.perf_counter() - t0
    _check_finite(loss, "timed")
    return dt / epochs_timed


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(p)
    p.add_argument("--bptt", type=int, default=2010)
    p.add_argument("--out", default="results/batch_sweep.json")
    p.add_argument("--shapes", default=None, help="comma list like 4x25,20x5 (default: full sweep)")
    p.add_argument("--epochs_timed", type=int, default=2, help="epoch-equivalents timed per shape")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    shapes = SHAPES
    if args.shapes:
        shapes = [tuple(map(int, s.split("x"))) for s in args.shapes.split(",")]

    # Resume-friendly: merge into an existing result file and skip shapes
    # already timed, so that a failure in one config (out of memory) leaves
    # the others.
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f).get("s_per_epoch", {})
    for batch_size, agg in shapes:
        name = f"{batch_size}x{agg}"
        if isinstance(results.get(name), float):
            print(f"{name}: cached {results[name]} s/epoch", flush=True)
            continue
        try:
            s_per_epoch = time_config(batch_size, agg, args.bptt, args.epochs_timed, device)
            results[name] = round(s_per_epoch, 3)
            print(f"{name}: {s_per_epoch:.2f} s/epoch", flush=True)
        except Exception as e:  # out of memory and the like: record it, go on with the sweep
            results[name] = f"failed: {type(e).__name__}: {str(e)[:200]}"
            traceback.print_exc()
            print(f"{name}: FAILED {type(e).__name__}", flush=True)
        _write(args, results)
    payload = _write(args, results)
    print(json.dumps(payload))
    return payload


def _write(args, results):
    ok = {k: v for k, v in results.items() if isinstance(v, float)}
    payload = {
        "bptt": args.bptt,
        "schedule_invariant": "100 datasets/update, 4 updates/epoch",
        "s_per_epoch": results,
        "winner": min(ok, key=ok.get) if ok else None,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    return payload


if __name__ == "__main__":
    main()
