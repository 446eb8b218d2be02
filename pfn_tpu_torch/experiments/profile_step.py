"""Break down the train step's time: prior sampling, the forward, forward +
backward, the optimizer alone and the full update, plus a bf16 matmul
roofline share.

Port of ``experiments/profile_step.py``, with its flags and its JSON keys
(``docs/results/profile_2010.json``), plus the card's name and power limit
(``card``) and the device. The defaults profile the flagship (B 64, bptt
100, the Fig-3a width, 100 buckets, the exact GP sampler);

    python -m pfn_tpu_torch.experiments.profile_step --bptt 2010 --batch_size 4 --grid 8192 --num_buckets 10000

profiles the Fig-3a microbatch. Each stage runs ``WARMUP`` times, then
``REPS`` times between two device syncs on the host clock: the mean is its
time. ``--device cpu`` runs on the host; the default is the card.

The roofline is the JAX script's formula (:135-154), kept so that the two
drivers' shares mean the same thing, over the H100's dense bf16 peak (989
TFLOP/s, in place of the v5e's 197). It counts 2 P B T for the parameters'
products, every parameter as bf16 work (the f32 decoder's too), and 4 B T²
emsize nlayers for attention: dense T² pairs, about twice the PFN pairs
that the flash kernels compute at sep T/2. At bptt 2010, B 4, attention is
0.199 of the forward's 0.575 TFLOP. The backward counts as twice the
forward.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from pfn_tpu_torch.distributions import get_bucket_limits
from pfn_tpu_torch.experiments.common import (
    FIG3A_MODEL,
    GP_HP,
    add_device_argument,
    card,
    resolve_device,
    synchronize,
)
from pfn_tpu_torch.models.transformer import num_params
from pfn_tpu_torch.priors import GPPrior
from pfn_tpu_torch.train import TrainConfig, TrainState, bar_criterion, build_model
from pfn_tpu_torch.train.loop import _clip_and_step, _make_optimizer, _masked_loss, make_train_step

PEAK_BF16_TFLOPS = 989.0  # NVIDIA H100 SXM, dense bf16, at its 700 W limit
WARMUP = 3
REPS = 30


def timeit(name: str, fn, device) -> float:
    """Seconds per fn() call: the mean of REPS calls after WARMUP, the clock
    read after a device sync on both sides."""
    for _ in range(WARMUP):
        fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    synchronize(device)
    dt = (time.perf_counter() - t0) / REPS
    print(f"{name:34s} {dt * 1e3:8.3f} ms")
    return dt


def roofline(P: int, B: int, T: int, forward_ms: float, fwd_bwd_ms: float, full_step_ms: float,
             emsize: int, nlayers: int) -> dict:
    """The JAX script's bf16 roofline (module docstring) of the three timed
    stages, in % of PEAK_BF16_TFLOPS."""
    attn_flops = 4 * B * T * T * emsize * nlayers  # QK^T + PV, all layers
    param_flops = 2 * P * B * T
    fwd_flops = param_flops + attn_flops
    step_flops = 3 * fwd_flops  # fwd + ~2x for bwd
    peak = PEAK_BF16_TFLOPS * 1e12
    return {
        "peak_bf16_tflops": PEAK_BF16_TFLOPS,
        "fwd_tflop": fwd_flops / 1e12,
        "fwd_pct_of_peak": 100 * fwd_flops / (forward_ms / 1e3) / peak,
        "fwd_bwd_pct_of_peak": 100 * step_flops / (fwd_bwd_ms / 1e3) / peak,
        "full_step_pct_of_peak": 100 * step_flops / (full_step_ms / 1e3) / peak,
    }


def setup(batch_size: int, bptt: int, grid: int, num_buckets: int, device):
    """The profiled config: (prior, criterion, cfg, train state, LR
    schedule) of the Fig-3a width in bf16 with ``num_buckets`` buckets on
    (-4, 4)."""
    prior = GPPrior(num_features=1, grid=grid, **GP_HP)
    criterion = bar_criterion(get_bucket_limits(num_buckets, full_range=(-4.0, 4.0))).to(device)
    cfg = TrainConfig(**FIG3A_MODEL, batch_size=batch_size, bptt=bptt, lr=1e-4, warmup_epochs=1, epochs=1,
                      steps_per_epoch=20, dtype=torch.bfloat16, device=device)
    model = build_model(prior, criterion, cfg)
    optimizer, _, schedule = _make_optimizer(cfg, model)
    return prior, criterion, cfg, TrainState(model, optimizer, torch.Generator(device=device).manual_seed(1)), schedule


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(ap)
    ap.add_argument("--bptt", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--grid", type=int, default=0, help="G > 0: profile the grid/FFT prior sampler path")
    ap.add_argument("--num_buckets", type=int, default=100)
    ap.add_argument("--out", default=None, help="also write the breakdown + roofline JSON here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    B, T = args.batch_size, args.bptt

    prior, criterion, cfg, state, schedule = setup(B, T, args.grid, args.num_buckets, device)
    model = state.model
    g = torch.Generator(device=device).manual_seed(0)
    res = {"bptt": T, "batch_size": B, "grid": args.grid, "num_buckets": args.num_buckets}

    # 1. prior sampling alone
    res["prior_sample_ms"] = 1e3 * timeit(f"prior.sample ({B}x {'grid-fft' if args.grid else 'chol'} T={T})",
                                          lambda: prior.sample(B, T, generator=g, device=device), device)

    # 2. forward only
    x, y, target_y = prior.sample(B, T, generator=g, device=device)
    sep = torch.full((1,), T // 2, dtype=torch.int32, device=device)

    def forward():
        with torch.no_grad():
            return model(x, y, sep)

    res["forward_ms"] = 1e3 * timeit("forward", forward, device)

    # 3. the masked loss forward + backward to the parameters (no optimizer)
    params = list(model.parameters())

    def fwd_bwd():
        return torch.autograd.grad(_masked_loss(model, criterion, cfg, x, y, target_y, sep), params)

    res["fwd_bwd_ms"] = 1e3 * timeit("forward+backward", fwd_bwd, device)

    # 4. the optimizer alone (clip + Adam on the f32 parameters)
    for p, grad in zip(params, fwd_bwd()):
        p.grad = grad
    res["optimizer_ms"] = 1e3 * timeit("clip+adam update only", lambda: _clip_and_step(state, schedule), device)

    # 5. the full update (sample + fwd + bwd + update)
    step = make_train_step(prior, criterion, cfg, schedule)
    res["full_step_ms"] = 1e3 * timeit("full step", lambda: step(state), device)

    P = num_params(model)
    res["params_m"] = P / 1e6
    print("params:", P / 1e6, "M")
    res["roofline"] = roofline(P, B, T, res["forward_ms"], res["fwd_bwd_ms"], res["full_step_ms"],
                               FIG3A_MODEL["emsize"], FIG3A_MODEL["nlayers"])
    for k, v in res["roofline"].items():
        print(f"{k:34s} {v:8.3f}")
    res["card"] = card(device)
    res["device"] = str(device)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print("wrote", args.out)
    return res


if __name__ == "__main__":
    main()
