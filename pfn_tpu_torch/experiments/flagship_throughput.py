"""The flagship throughput measurements: prior-batches/s of the port's train
step, and of a reference-style stock-PyTorch pipeline.

Port of ``bench.py``'s measurement functions (``measure_pfn_tpu``
:55-113, ``measure_torch_baseline`` :116-175 and ``_resolve_impl``
:41-52). Not ported here: bench.py's command line, its one-line JSON
result and its cached baseline file. The flagship: the Fig-3a width
(emsize 512, 4 heads, nhid 1024, 6 layers), B 64 datasets of bptt 100
from the GP prior sampled on the device (the grid sampler at ``grid`` > 0,
the exact Cholesky sampler at 0), 100 buckets on (-4, 4), bf16, each timed
call ``updates_per_call`` full updates (sample, forward, backward, clip,
Adam).

    python -m pfn_tpu_torch.experiments.flagship_throughput [--grid 2048] [--device cpu]

runs both measurements once and prints their prior-batches/s. ``device``
None is the current CUDA device (an error without one); "cpu" runs on the
host. ``attention_impl="best"`` reads the port's own fused A/B
(``FUSED_AB_FILE``, what ``fused_ab`` writes), found beside the package as
``bench.py`` finds its own, from any working directory; ``main`` prints the
implementation it resolved.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import torch

from pfn_tpu_torch.distributions import get_bucket_limits
from pfn_tpu_torch.experiments.common import FIG3A_MODEL, GP_HP, add_device_argument, resolve_device, synchronize
from pfn_tpu_torch.priors import GPPrior
from pfn_tpu_torch.train import TrainConfig, TrainState, bar_criterion, build_model
from pfn_tpu_torch.train.loop import _make_optimizer, make_train_chunk, make_train_step

BATCH_SIZE = 64
BPTT = 100
NUM_BUCKETS = 100
# The port's fused-vs-unfused A/B on the H100 (fused_ab's default --out),
# anchored at the checkout as bench.py:36-38 anchors its own; never
# docs/results/fused_ab.json, which holds the TPU's.
FUSED_AB_FILE = str(Path(__file__).resolve().parents[2] / "docs" / "results" / "torch_h100" / "fused_ab.json")


def _resolve_impl(attention_impl: str) -> str:
    """'best' -> the winner of the port's fused-vs-unfused A/B, with a 5 %
    threshold so that noise cannot flip the default; 'auto' when no A/B
    exists or it cannot be read. Any other name is returned as it is."""
    if attention_impl != "best":
        return attention_impl
    try:
        with open(FUSED_AB_FILE) as f:
            ab = json.load(f)
        return "fused" if ab.get("speedup", 0.0) > 1.05 else "auto"
    except (OSError, ValueError):
        return "auto"


def measure_pfn_torch(steps: int = 20, warmup: int = 3, updates_per_call: int = 25, grid: int = 0,
                      attention_impl: str = "best", device=None) -> float:
    """Prior-batches/s of the flagship: ``steps`` timed calls of
    ``updates_per_call`` updates after ``warmup`` calls, the clock stopped
    after a device sync; raises if the last loss is not finite."""
    attention_impl = _resolve_impl(attention_impl)
    device = resolve_device(device)
    prior = GPPrior(num_features=1, grid=grid, **GP_HP)
    criterion = bar_criterion(get_bucket_limits(NUM_BUCKETS, full_range=(-4.0, 4.0))).to(device)
    cfg = TrainConfig(**FIG3A_MODEL, batch_size=BATCH_SIZE, bptt=BPTT, lr=1e-4, warmup_epochs=1, epochs=1,
                      steps_per_epoch=steps, dtype=torch.bfloat16, attention_impl=attention_impl, device=device)
    model = build_model(prior, criterion, cfg)
    optimizer, _, schedule = _make_optimizer(cfg, model)
    state = TrainState(model, optimizer, torch.Generator(device=device).manual_seed(1))
    chunk = make_train_chunk(make_train_step(prior, criterion, cfg, schedule), updates_per_call)

    for _ in range(warmup):
        metrics = chunk(state)
    float(metrics["loss"])
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = chunk(state)
    last = float(metrics["loss"])
    synchronize(device)
    dt = time.perf_counter() - t0
    if not math.isfinite(last):
        raise FloatingPointError(f"non-finite loss {last} in the flagship measurement")
    return steps * updates_per_call / dt


def measure_torch_baseline(steps: int = 3, warmup: int = 1, device=None) -> float:
    """Steps/s of a reference-style PyTorch pipeline at the flagship shape
    (stock torch building blocks, not reference source): GP sampling by
    torch Cholesky, a TransformerEncoder with the additive PFN mask, the
    bar NLL, clip and Adam. The copy of ``bench.py``'s with two repairs: it
    runs on ``device`` (None: the card, an error without one; bench.py falls
    back to the CPU), and the clock stops after a device sync."""
    import torch.nn as nn

    device = resolve_device(device)
    torch.manual_seed(0)
    B, T, D = BATCH_SIZE, BPTT, FIG3A_MODEL["emsize"]
    nhead, nhid, nlayers = FIG3A_MODEL["nhead"], FIG3A_MODEL["nhid"], FIG3A_MODEL["nlayers"]

    layer = nn.TransformerEncoderLayer(D, nhead, nhid, 0.0, activation="gelu", batch_first=True)
    encoder_stack = nn.TransformerEncoder(layer, nlayers)
    x_enc = nn.Linear(1, D)
    y_enc = nn.Linear(1, D)
    head = nn.Sequential(nn.Linear(D, nhid), nn.GELU(), nn.Linear(nhid, NUM_BUCKETS))
    model = nn.ModuleList([encoder_stack, x_enc, y_enc, head]).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)

    borders = torch.linspace(-4.0, 4.0, NUM_BUCKETS + 1, device=device)
    widths = borders[1:] - borders[:-1]

    def pfn_mask(sep):
        m = torch.zeros(T, T, device=device)
        allow = torch.zeros(T, T, dtype=torch.bool, device=device)
        allow[:, :sep] = True
        allow |= torch.eye(T, dtype=torch.bool, device=device)
        m[~allow] = float("-inf")
        return m

    def one_step():
        # On-the-fly GP sample (the reference's data hot loop, fast_gp.py:44-56).
        x = torch.rand(B, T, 1, device=device)
        d2 = torch.cdist(x, x).pow(2)
        K = GP_HP["outputscale"] * torch.exp(-0.5 * d2 / GP_HP["lengthscale"] ** 2)
        A = K + (GP_HP["noise"] + 1e-6) * torch.eye(T, device=device)
        L = torch.linalg.cholesky(A)
        y = (L @ torch.randn(B, T, 1, device=device)).squeeze(-1)

        sep = T // 2
        tok = x_enc(x)
        tok[:, :sep] += y_enc(y[:, :sep, None])
        out = encoder_stack(tok, pfn_mask(sep))
        logits = head(out[:, sep:])
        idx = (torch.searchsorted(borders, y[:, sep:].clamp(-3.999, 3.999)) - 1).clamp(0, NUM_BUCKETS - 1)
        logp = torch.log_softmax(logits, -1) - widths.log()
        loss = -logp.gather(-1, idx.unsqueeze(-1)).mean()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0)
        opt.step()
        opt.zero_grad()

    for _ in range(warmup):
        one_step()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        one_step()
    synchronize(device)
    return steps / (time.perf_counter() - t0)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(p)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--updates_per_call", type=int, default=25)
    p.add_argument("--grid", type=int, default=0, help="G > 0: the grid GP sampler; 0: the exact one")
    p.add_argument("--attention_impl", default="best")
    p.add_argument("--baseline_steps", type=int, default=3)
    args = p.parse_args(argv)
    impl = _resolve_impl(args.attention_impl)
    print(f"attention_impl {args.attention_impl} -> {impl}"
          + (f" (the A/B in {FUSED_AB_FILE})" if args.attention_impl == "best" else ""), flush=True)
    device = resolve_device(args.device)
    out = {
        "prior_batches_per_sec": measure_pfn_torch(steps=args.steps, updates_per_call=args.updates_per_call,
                                                   grid=args.grid, attention_impl=impl, device=device),
        "torch_baseline_prior_batches_per_sec": measure_torch_baseline(steps=args.baseline_steps, device=device),
        "attention_impl": impl,
        "config": {"steps": args.steps, "updates_per_call": args.updates_per_call, "grid": args.grid,
                   "baseline_steps": args.baseline_steps, "device": str(device)},
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
