"""Isolate the 10x10 batch-shape anomaly: the full train step at three
microbatch shapes, then attention alone and the GP prior alone.

Port of ``experiments/anomaly_10x10.py``. On the TPU the bptt=2010 sweep
measured the microbatch-10 x accumulation-10 shape slower than 4 x 25,
though larger microbatches otherwise won. In one process, back to back:

  1. step: the full train step's s/epoch at 4x25, 10x10 and 20x5, with the
     schedule held at 100 datasets an update and 4 updates an epoch (the
     sweep's machinery, ``batch_shape_sweep.time_config``);
  2. attn: the flash attention's forward and backward through autograd
     alone, bf16 (B, 4, 2010, 128) at sep 1000 (on the card the bf16
     kernels 1-3), ``100 // B`` repeats of the microbatch: seconds per 100
     datasets, at B 4, 10, 20 and 25;
  3. prior: the exact GP prior's sampling alone, seconds per 100 datasets,
     at the same B.

**Deviation.** The JAX script forces the TPU flash tile to 128 and to 256
rows (``_force_block``, monkeypatching ``_choose_block``) and keys its step
and attention results by the block ("4x25_block128", "B4_block256"). The
Hopper kernels' tiles are fixed by T and dtype (the tile rule is not
ported), so the block axis is dropped: the keys are "{B}x{agg}" and
"B{B}".

    python -m pfn_tpu_torch.experiments.anomaly_10x10 [--phase attn] [--device cpu]

It writes ``--out`` (default results/anomaly_10x10.json), merging into an
existing file: a key already there is skipped.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from pfn_tpu_torch.experiments.batch_shape_sweep import time_config as time_step
from pfn_tpu_torch.experiments.common import GP_HP, add_device_argument, resolve_device, synchronize
from pfn_tpu_torch.ops.flash_attention import pfn_flash_attention
from pfn_tpu_torch.priors import GPPrior

STEP_SHAPES = [(4, 25), (10, 10), (20, 5)]
ATTN_BATCHES = [4, 10, 20, 25]


def time_attention(batch: int, bptt: int, nhead: int = 4, d: int = 128, reps_timed: int = 3, device=None) -> float:
    """Flash forward + backward seconds per 100 datasets: one warm-up call,
    then ``reps_timed`` x (100 // batch) timed calls, over reps_timed."""
    device = resolve_device(device)
    agg = 100 // batch
    g = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(batch, nhead, bptt, d, generator=g, device=device).to(torch.bfloat16).requires_grad_()
               for _ in range(3))
    sep = torch.full((1,), 1000, dtype=torch.int32, device=device)

    def fwd_bwd():
        loss = pfn_flash_attention(q, k, v, sep).float().sum()
        return loss, torch.autograd.grad(loss, (q, k, v))

    fwd_bwd()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps_timed * agg):
        fwd_bwd()
    synchronize(device)
    return (time.perf_counter() - t0) / reps_timed


def time_prior(batch: int, bptt: int, reps_timed: int = 3, device=None) -> float:
    """Exact GP prior sampling seconds per 100 datasets: one warm-up draw,
    then ``reps_timed`` x (100 // batch) timed draws, over reps_timed."""
    device = resolve_device(device)
    agg = 100 // batch
    prior = GPPrior(num_features=1, **GP_HP)
    g = torch.Generator(device=device).manual_seed(0)
    prior.sample(batch, bptt, generator=g, device=device)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps_timed * agg):
        prior.sample(batch, bptt, generator=g, device=device)
    synchronize(device)
    return (time.perf_counter() - t0) / reps_timed


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(p)
    p.add_argument("--bptt", type=int, default=2010)
    p.add_argument("--out", default="results/anomaly_10x10.json")
    p.add_argument("--phase", default="all", choices=["all", "step", "attn", "prior"])
    p.add_argument("--epochs_timed", type=int, default=2, help="epoch-equivalents timed per step shape")
    p.add_argument("--reps_timed", type=int, default=3, help="100-dataset repeats timed per attn and prior batch")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    results.setdefault("bptt", args.bptt)
    results.setdefault("step_s_per_epoch", {})
    results.setdefault("attn_s_per_100ds", {})
    results.setdefault("prior_s_per_100ds", {})

    def save():
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)

    def run(table: str, name: str, fn, digits: int, unit: str) -> None:
        """results[table][name] = fn() rounded, unless it is there already; a
        failure (out of memory and the like) is recorded and the run goes on."""
        if name in results[table]:
            return
        try:
            s = fn()
            results[table][name] = round(s, digits)
            print(f"{table.split('_')[0]} {name}: {s:.3f} {unit}", flush=True)
        except Exception as e:
            results[table][name] = f"failed: {type(e).__name__}: {str(e)[:160]}"
            traceback.print_exc()
            print(f"{table.split('_')[0]} {name}: FAILED {type(e).__name__}", flush=True)
        save()

    if args.phase in ("all", "step"):
        for b, agg in STEP_SHAPES:
            run("step_s_per_epoch", f"{b}x{agg}", lambda: time_step(b, agg, args.bptt, args.epochs_timed, device), 3,
                "s/epoch")
    if args.phase in ("all", "attn"):
        for b in ATTN_BATCHES:
            run("attn_s_per_100ds", f"B{b}", lambda: time_attention(b, args.bptt, reps_timed=args.reps_timed,
                                                                    device=device), 4, "s/100ds")
    if args.phase in ("all", "prior"):
        for b in ATTN_BATCHES:
            run("prior_s_per_100ds", f"B{b}", lambda: time_prior(b, args.bptt, reps_timed=args.reps_timed,
                                                                 device=device), 4, "s/100ds")

    save()
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
