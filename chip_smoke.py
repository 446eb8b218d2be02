#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pfn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the checkout

Phases, each printing one JSON line:
  1. card: the device, and its name and power limit from nvidia-smi (also
     printed raw on a line of its own). TF32 must be off for matmuls.
  2. build: compiles the CUDA kernel from the checkout's sources.
  3. kernel: the PFN flash-attention forward kernel, both variants, against
     its plain dense f32 version over T in {127, 128, 129, 2010}, sep in
     {0, 1, T//2, T-1}, head dim in {32, 64, 128}, f32 and bf16, plus
     Tq != Tk for the prefix variant; then its time beside the plain
     version's at the main-path shape (B*H = 32, T = 2010, D = 128, bf16).
  4. slice: GP-regression inference at the Fig-3a width (emsize 512, 4 heads,
     nhid 1024, 6 layers, bf16, seeded random weights through the weight
     bridge) at T = 2010: positional logits for 8 datasets, a PFNRegressor
     predict and predict_quantiles, the f64 exact-GP oracle and the analytic
     KL; kernel path against the dense path and an f32 model.
Then the kernels line, and last {"ok": true, "device": {...}}.

Any failure raises, so the script exits nonzero and prints no result line.
It also fails when there is no CUDA device, and when the package beside it
is missing. It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

F32_TOL = 2e-5  # atol and rtol for f32, as tests/test_flash_attention.py uses
BF16_LSE_TOL = 1e-4  # lse from the same bf16 inputs: only the f32 summation order differs
# The slice at the Fig-3a width (experiments/fig3a_longrun.py:173-179), depth
# and widths uncut; the weights are random.
FIG3A = dict(T=2010, datasets=8, n_ctx=1000, positions=[1, 10, 100, 1000, 2000], emsize=512, nhead=4,
             nhid=1024, nlayers=6, buckets=1000, grid=8192)
TIMING_SEPS = [400, 1000, 2000]
REPEATS = 5  # slice requests after the first call; their median is reported


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_request(fn):
    """(ms by CUDA events, wall ms, result) of one request."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), (time.perf_counter() - t0) * 1e3, out


def phase_card():
    import torch

    from pfn_tpu_torch.device import require_cuda

    device = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is True; the port's f32 numerics need it off")
    torch.backends.cudnn.allow_tf32 = False
    emit({
        "phase": "card", "name": torch.cuda.get_device_name(device), "nvidia_smi": smi,
        "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    })
    return device, smi


def phase_build():
    from pfn_tpu_torch.ops import _ext

    info = _ext.build()
    ptxas = [line.strip() for line in info["log"].splitlines() if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": info["seconds"], "built": info["built"],
          "library": str(Path(info["path"]).relative_to(ROOT)), "ptxas": ptxas})


def phase_kernel_cases(device):
    """Kernel against its plain version on the grid of flash_equivalence."""
    import torch

    from pfn_tpu_torch.ops.attention import (
        pfn_attention,
        pfn_attention_reference,
        pfn_prefix_attention_reference,
    )
    from pfn_tpu_torch.ops.flash_attention import _flash_fwd, _flash_fwd_plain

    g = torch.Generator(device=device).manual_seed(0)
    B, H = 2, 2
    worst = {}
    n = 0
    for include_diag in (True, False):
        variant = "diag" if include_diag else "prefix"
        for T in (127, 128, 129, 2010):
            for Tq in ([T] if include_diag else [T, T // 2 + 1]):
                for sep in sorted({0, 1, T // 2, T - 1}):
                    for D in (32, 64, 128):
                        for dtype in (torch.float32, torch.bfloat16):
                            q = torch.randn(B, H, Tq, D, generator=g, device=device).to(dtype)
                            k = torch.randn(B, H, T, D, generator=g, device=device).to(dtype)
                            v = torch.randn(B, H, T, D, generator=g, device=device).to(dtype)
                            qs = (q * D**-0.5).reshape(B * H, Tq, D)
                            kf, vf = k.reshape(B * H, T, D), v.reshape(B * H, T, D)
                            o, lse = _flash_fwd(qs, kf, vf, sep, include_diag)
                            torch.cuda.synchronize()
                            o_plain, lse_plain = _flash_fwd_plain(qs.float(), kf.float(), vf.float(), sep, T,
                                                                  include_diag)
                            case = dict(variant=variant, T=T, Tq=Tq, sep=sep, D=D, dtype=str(dtype))
                            tol = F32_TOL if dtype == torch.float32 else BF16_LSE_TOL
                            if not torch.allclose(lse, lse_plain, atol=tol, rtol=tol):
                                raise AssertionError(f"lse mismatch {case}: {max_abs(lse, lse_plain)}")
                            if sep == 0 and not include_diag:
                                if not (bool((lse <= -1e29).all()) and bool((o == 0).all())):
                                    raise AssertionError(f"empty prefix must give o=0, lse<=-1e29: {case}")
                            if dtype == torch.float32:
                                if not torch.allclose(o, o_plain, atol=F32_TOL, rtol=F32_TOL):
                                    raise AssertionError(f"o mismatch {case}: {max_abs(o, o_plain)}")
                                err, budget = max_abs(o, o_plain), None
                            else:
                                # bf16: the kernel's error and the dense bf16 path's, each
                                # against the f32 result for the same bf16 inputs.
                                if include_diag:
                                    gold = pfn_attention_reference(q.float(), k.float(), v.float(), sep)
                                    dense = pfn_attention_reference(q, k, v, sep)
                                else:
                                    gold = pfn_prefix_attention_reference(q.float(), k.float(), v.float(), sep)[0]
                                    dense = pfn_prefix_attention_reference(q, k, v, sep)[0]
                                err = max_abs(o.reshape(B, H, Tq, D), gold)
                                budget = 2 * max_abs(dense, gold) + 1e-3
                                if err > budget:
                                    raise AssertionError(f"bf16 error {err} over budget {budget}: {case}")
                            torch.cuda.synchronize()
                            key = f"{variant}/{case['dtype']}"
                            w = worst.setdefault(key, {"cases": 0, "max_err": 0.0, "max_lse_err": 0.0})
                            w["cases"] += 1
                            w["max_err"] = max(w["max_err"], err)
                            w["max_lse_err"] = max(w["max_lse_err"], max_abs(lse, lse_plain))
                            n += 1
    # The prefix + exact-merge dispatch on the card, against the dense path.
    q, k, v = (torch.randn(2, 4, 2010, 128, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    gold = pfn_attention_reference(q.float(), k.float(), v.float(), 1000)
    merge_err = max_abs(pfn_attention(q, k, v, 1000, impl="prefix"), gold)
    merge_budget = 2 * max_abs(pfn_attention(q, k, v, 1000, impl="dense"), gold) + 1e-3
    if merge_err > merge_budget:
        raise AssertionError(f"impl='prefix' bf16 error {merge_err} over budget {merge_budget}")
    torch.cuda.synchronize()
    emit({"phase": "kernel", "cases": n, "worst": worst, "tol_f32": F32_TOL, "tol_bf16_lse": BF16_LSE_TOL,
          "bf16_rule": "err <= 2 * dense_bf16_err + 1e-3", "prefix_merge_err": merge_err,
          "prefix_merge_budget": merge_budget})


def phase_kernel_timing(device, smi: str):
    """Kernel and plain-version times at the main-path shape."""
    import torch

    from pfn_tpu_torch.ops.attention import pfn_attention_reference
    from pfn_tpu_torch.ops.flash_attention import _flash_fwd, _flash_fwd_plain

    g = torch.Generator(device=device).manual_seed(1)
    B, H, T, D = 8, 4, 2010, 128
    q, k, v = (torch.randn(B, H, T, D, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    qs = (q * D**-0.5).reshape(B * H, T, D)
    kf, vf = k.reshape(B * H, T, D), v.reshape(B * H, T, D)
    rows = []
    for sep in TIMING_SEPS:
        sep_t = torch.full((1,), sep, dtype=torch.int32, device=device)
        o, _ = _flash_fwd(qs, kf, vf, sep_t, True)
        o_plain, _ = _flash_fwd_plain(qs.float(), kf.float(), vf.float(), sep, T, True)
        err = max_abs(o, o_plain)
        rows.append({
            "sep": sep,
            "kernel_ms": cuda_ms(lambda: _flash_fwd(qs, kf, vf, sep_t, True)),
            "plain_ms": cuda_ms(lambda: _flash_fwd_plain(qs, kf, vf, sep_t, T, True)),
            "dense_bf16_ms": cuda_ms(lambda: pfn_attention_reference(q, k, v, sep_t)),
            "kernel_ms_again": cuda_ms(lambda: _flash_fwd(qs, kf, vf, sep_t, True)),
            "max_abs_err": err,
            "gflop_4_T_sep_D": 4.0 * B * H * T * sep * D / 1e9,
        })
    emit({"phase": "kernel_timing", "shape": {"BH": B * H, "T": T, "D": D, "dtype": "bf16"},
          "card": smi, "rows": rows})
    return rows


def phase_slice(device, smi: str, size: dict = FIG3A):
    import numpy as np
    import torch

    from pfn_tpu_torch.distributions import get_bucket_limits
    from pfn_tpu_torch.evals import eval_positional_logits_per_dataset, gp_exact_posterior_moments
    from pfn_tpu_torch.inference import PFNRegressor
    from pfn_tpu_torch.models import PFNTransformer, TransformerConfig
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.priors import GPPrior, sample_y_for_buckets
    from pfn_tpu_torch.train import full_support_bar_criterion, seeded_flax_params, state_dict_from_flax_params

    T, n_ctx, positions = size["T"], size["n_ctx"], size["positions"]
    prior = GPPrior(num_features=1, noise=1e-4, outputscale=1.0, lengthscale=0.6, grid=size["grid"])
    ys = sample_y_for_buckets(prior, 100_000, T, seed=7, device=device)
    criterion = full_support_bar_criterion(get_bucket_limits(size["buckets"], ys=ys)).to(device)
    cfg = TransformerConfig(num_features=1, n_out=size["buckets"], emsize=size["emsize"], nhead=size["nhead"],
                            nhid=size["nhid"], nlayers=size["nlayers"], dtype=torch.bfloat16)
    state_dict = state_dict_from_flax_params(
        seeded_flax_params(1, cfg.emsize, cfg.nhid, cfg.nlayers, cfg.n_out, seed=0), cfg.nlayers)
    for name in ("self_attn.out_proj.weight", "linear2.weight"):
        if not bool(state_dict[f"transformer_encoder.layers.0.{name}"].abs().sum() > 0):
            raise AssertionError(f"{name} is zero: attention would not reach the output")

    def build(**over):
        model = PFNTransformer(dataclasses.replace(cfg, **over)).to(device).eval()
        model.load_state_dict(state_dict, strict=True)
        return model

    model = build()
    g = torch.Generator(device=device).manual_seed(991)
    x, y, _ = prior.sample(size["datasets"], T, generator=g, device=device)
    x_np, y_np = x[0].cpu().numpy(), y[0].cpu().numpy()
    regressor = PFNRegressor(model, criterion).fit(x_np[:n_ctx], y_np[:n_ctx])
    hp = prior.hyperparameters()
    requests = {
        "positional_logits": lambda: eval_positional_logits_per_dataset(model, x, y, positions),
        "predict_return_std": lambda: regressor.predict(x_np[n_ctx:], return_std=True),
        "predict_quantiles": lambda: regressor.predict_quantiles(x_np[n_ctx:], (0.05, 0.5, 0.95)),
        "oracle_f64": lambda: gp_exact_posterior_moments(x, y, hp, positions=positions, dtype=torch.float64),
        "gaussian_kl_f64": lambda: criterion.bar.gaussian_kl(out["positional_logits"].double(), *out["oracle_f64"]),
    }
    # The first call in the process pays for lazy CUDA module loading and
    # library handles; the median of the repeats that follow is the steady
    # state.
    forwards = (1 + REPEATS) * (len(positions) + 2)
    runs = {name: [] for name in requests}
    out = {}
    _ext.reset_launch_counts()
    for _ in range(1 + REPEATS):
        for name, fn in requests.items():
            ms, wall_ms, out[name] = timed_request(fn)
            runs[name].append((ms, wall_ms))
    launches = _ext.launch_counts["pfn_flash_fwd"]
    latency = {f"{name}/first": r[0][0] for name, r in runs.items()}
    latency.update({f"{name}/median_of_{REPEATS}": float(np.median([ms for ms, _ in r[1:]]))
                    for name, r in runs.items()})
    wall = {f"{name}/first": r[0][1] for name, r in runs.items()}
    wall.update({f"{name}/median_of_{REPEATS}": float(np.median([w for _, w in r[1:]])) for name, r in runs.items()})
    if launches != cfg.nlayers * forwards:
        raise AssertionError(f"{launches} kernel launches, expected {cfg.nlayers} layers x {forwards} forwards")
    logits, (mean, std), quants = out["positional_logits"], out["predict_return_std"], out["predict_quantiles"]
    (mu, var), kl = out["oracle_f64"], out["gaussian_kl_f64"]

    logits_dense = eval_positional_logits_per_dataset(build(attention_impl="dense"), x, y, positions)
    logits_f32 = eval_positional_logits_per_dataset(
        build(attention_impl="dense", dtype=torch.float32), x, y, positions)
    err_kernel_dense = max_abs(logits, logits_dense)
    err_dense_f32 = max_abs(logits_dense, logits_f32)
    err_kernel_f32 = max_abs(logits, logits_f32)

    checks = {
        "logits_shape": tuple(logits.shape) == (len(positions), size["datasets"], cfg.n_out),
        "logits_finite": bool(torch.isfinite(logits).all()),
        "predict_finite": bool(np.isfinite(mean).all() and np.isfinite(std).all() and (std > 0).all()),
        "quantiles_ordered": bool(np.isfinite(quants).all() and (np.diff(quants, axis=0) >= 0).all()),
        "oracle_finite": bool(torch.isfinite(mu).all() and torch.isfinite(var).all() and (var > 0).all()),
        "kl_finite": bool(torch.isfinite(kl).all()),
        "kl_nonnegative": bool(kl.min() >= -1e-6),
        # bf16 tolerance: the kernel path and the dense path may differ by at
        # most twice the dense bf16 path's own distance from an f32 model.
        "kernel_vs_dense": err_kernel_dense <= 2 * err_dense_f32 + 1e-3,
    }
    emit({
        "phase": "slice", "card": smi, "size": size, "dtype": "bf16",
        "latency_ms": latency, "wall_ms": wall,
        "kl_mean_per_position": kl.mean(dim=1).tolist(),
        "err_kernel_vs_dense": err_kernel_dense, "err_dense_vs_f32": err_dense_f32,
        "err_kernel_vs_f32": err_kernel_f32, "launches": launches, "checks": checks,
    })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"slice checks failed: {failed}")
    return launches


def main() -> int:
    import torch

    import pfn_tpu_torch

    if Path(pfn_tpu_torch.__file__).resolve().parent.parent != ROOT:
        raise SystemExit(f"pfn_tpu_torch at {pfn_tpu_torch.__file__} is not the checkout beside this script")
    device, smi = phase_card()
    phase_build()
    phase_kernel_cases(device)
    timing = phase_kernel_timing(device, smi)
    launches = phase_slice(device, smi)
    main_row = next(r for r in timing if r["sep"] == 1000)
    emit({"kernels": [{
        "name": "pfn_flash_fwd", "route": "cuda", "source": "pfn_tpu_torch/ops/csrc/pfn_flash_fwd.cu",
        "replaces": "pfn_tpu/ops/flash_attention.py:255", "launches": launches,
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
