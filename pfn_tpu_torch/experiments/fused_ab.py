"""A/B: the fused whole-layer kernels against the unfused train step.

Port of ``experiments/fused_ab.py``. It runs the flagship measurement
(``flagship_throughput.measure_pfn_torch``: bptt 100, B 64, the Fig-3a
width, bf16) three times in one process, in ABA order to expose drift:
``attention_impl`` "auto" (dense attention at T 100 by the T >= 256 rule),
"fused" (the fused layer's kernels 4-6), "auto" again. The speedup is the
fused prior-batches/s over the mean of the two baselines.

    python -m pfn_tpu_torch.experiments.fused_ab [--steps 20] [--device cpu]

It writes ``--out`` (default ``flagship_throughput.FUSED_AB_FILE``,
docs/results/torch_h100/fused_ab.json in the checkout, what
``flagship_throughput``'s ``attention_impl="best"`` reads from any working
directory; never the TPU's docs/results/fused_ab.json), with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os

from pfn_tpu_torch.experiments import flagship_throughput
from pfn_tpu_torch.experiments.common import add_device_argument, card, resolve_device
from pfn_tpu_torch.experiments.flagship_throughput import measure_pfn_torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(p)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--grid", type=int, default=2048)
    p.add_argument("--updates_per_call", type=int, default=25)
    p.add_argument("--out", default=flagship_throughput.FUSED_AB_FILE)
    return p


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)

    kw = dict(steps=args.steps, grid=args.grid, updates_per_call=args.updates_per_call)
    results = {}
    for label, impl in [("baseline_a", "auto"), ("fused", "fused"), ("baseline_b", "auto")]:
        v = measure_pfn_torch(attention_impl=impl, device=device, **kw)
        results[label] = v
        print(f"{label:12s} ({impl}): {v:.1f} prior-batches/sec", flush=True)

    base = 0.5 * (results["baseline_a"] + results["baseline_b"])
    results["speedup"] = results["fused"] / base
    results["config"] = kw
    results["card"] = card(device)
    print(f"fused speedup vs the unfused step: {results['speedup']:.3f}x")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print("wrote", args.out)
    return results


if __name__ == "__main__":
    main()
