#!/usr/bin/env python3
"""Time the flash backward kernels, or the fused layer's kernels, of the
PyTorch port (``pfn_tpu_torch``) in several checkouts, in turns, on one
NVIDIA GPU.

    python3 experiments/port_flash_bwd_ab.py TREE_A TREE_B [--fused [--f32]] [--train] [--out FILE]

Each TREE is a directory that holds a ``pfn_tpu_torch`` package and its
``chip_smoke.py``: a checkout, or a commit unpacked by ``git archive`` into a
git-ignored directory. The trees run in the order A B B A (with more trees,
the list and then its reverse), each in a process of its own, so that each
imports its own package and builds its own kernels into its own ``build/``.
Comparing two versions is only meaningful within one such call on one card.

Each run prints one JSON line, tagged with its tree. By default: the forward
(diagonal variant), dq and dk/dv kernels' mean time by CUDA events (50 calls
after 5 warm-ups; and ``*_dev_ms``, their device time alone by
torch.profiler over 20 calls, which a host slower than the kernels does not
inflate) at the training microbatch (B*H 16, T 2010, D 128, bf16)
at sep 400, 1000, 1595 and 2000 and dq and dk/dv for the prefix variant at
sep 1000, each backward with its largest error against the plain backward
relative to the gold's largest entry; ptxas's registers and spills of the
dk/dv kernels; and with ``--train`` the JSON line of that tree's
``chip_smoke.phase_train`` (the Fig-3a update at full width). With
``--fused``: the fused layer's forward and its two backward entry points at
the bench.py flagship shape (B 64, T 100, D 512, H 4, F 1024, bf16) at sep
10, 50 and 90 (both times, as above), each backward output's largest error
against the plain bf16
backward relative to its largest entry, a device profile of one call of each
of the three at sep 50 (every device kernel), their host time per
call (50 calls without a synchronize), ptxas's report of the forward and
backward libraries' kernels; and with ``--train`` the JSON line of the tree's
``chip_smoke.phase_fused_train``. ``--fused --f32`` does the same for the
fused layer's f32 bodies (the weights in f32, errors against the plain f32
versions). Any failure of a run stops the script with a nonzero exit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

SEPS = [400, 1000, 1595, 2000]
BH, T, D = 16, 2010, 128


def ms(fn) -> float:
    import chip_smoke

    return chip_smoke.cuda_ms(fn, iters=50, warmup=5)


def dev_ms(fn, calls: int = 20) -> float:
    """Mean device time of one fn() call: the time of the kernels it
    launches, by torch.profiler over ``calls`` calls after a warm-up call and
    a profiler warm-up step (the tracer can miss the first kernels of a
    window), the recorded step padded by 20 ms on both sides (the profiler
    drops kernels whose timestamps fall outside it); as chip_smoke.device_ms,
    which a parent tree may lack. Unlike ``ms`` it does not grow when the
    host enqueues slower than the card runs."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.02)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
        prof.step()
    us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / calls / 1e3


def host_us(fn, calls: int = 50) -> float:
    """Mean host time of one fn() call over ``calls`` calls without a
    synchronize in between (the enqueue), in us; as chip_smoke.host_us,
    which a parent tree may lack."""
    import time

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def run_fused(tree: str, device, smi: str, train: bool, f32: bool = False) -> dict:
    """The fused layer's kernels of one tree, in this process, in bf16 or
    with ``f32`` their f32 bodies."""
    import torch

    import chip_smoke
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.ops.fused_layer import _bwd_attn_plain, _bwd_ffn_plain, _kernel_params

    logs = {name: info["log"] for name, info in _ext.build(["pfn_fused_layer_fwd", "pfn_fused_layer_bwd"]).items()}
    dtype = torch.float32 if f32 else torch.bfloat16
    out = {"tree": tree, "card": smi, "dtype": str(dtype),
           "ptxas_fwd": chip_smoke.ptxas_report(logs["pfn_fused_layer_fwd"]),
           "ptxas_bwd": chip_smoke.ptxas_report(logs["pfn_fused_layer_bwd"])}
    size = chip_smoke.FLAGSHIP
    B, T, D, H, F = size["B"], size["T"], size["emsize"], size["nhead"], size["nhid"]
    g = torch.Generator(device=device).manual_seed(10)
    p = chip_smoke._fused_params(D, F, g, device)
    kp = _kernel_params(p, dtype)
    x, dy = (torch.randn(B, T, D, generator=g, device=device) for _ in range(2))

    def rel_err(got, want):
        return float((got.float() - want.float()).abs().max() / want.float().abs().max())

    for sep in (10, 50, 90):
        sep_t = torch.full((1,), sep, dtype=torch.int32, device=device)
        _, r, lse = _ext.fused_layer_fwd(x, kp, sep_t, H)
        dr, dp_ffn = _ext.fused_layer_bwd_ffn(r, kp, dy)
        dx, dp_attn = _ext.fused_layer_bwd_attn(x, kp, lse, dr, sep_t, H)
        dr_plain, dp_ffn_plain = _bwd_ffn_plain(r, p, dy, dtype)
        dx_plain, dp_attn_plain = _bwd_attn_plain(x, p, sep_t, lse, dr, H, dtype)
        calls = {"ffn": lambda: _ext.fused_layer_bwd_ffn(r, kp, dy),
                 "attn": lambda: _ext.fused_layer_bwd_attn(x, kp, lse, dr, sep_t, H),
                 "fwd": lambda: _ext.fused_layer_fwd(x, kp, sep_t, H)}
        row = {**{f"{part}_ms": ms(fn) for part, fn in calls.items()},
               **{f"{part}_dev_ms": dev_ms(fn) for part, fn in calls.items()},
               "rel_err": {"dr": rel_err(dr, dr_plain), "dx": rel_err(dx, dx_plain),
                           **{k: rel_err(v, dp_ffn_plain[k]) for k, v in dp_ffn.items()},
                           **{k: rel_err(v, dp_attn_plain[k].reshape(v.shape)) for k, v in dp_attn.items()}}}
        if sep == size["sep"]:
            row["profiles"] = {part: chip_smoke.device_profile(fn, top=64) for part, fn in calls.items()}
            row["host_us_per_call"] = {part: host_us(fn) for part, fn in calls.items()}
        out[f"sep_{sep}"] = row
    if train:
        chip_smoke.phase_fused_train(device, smi, **({"f32": True} if f32 else {}))
    return out


def run_tree(tree: str, train: bool, fused: bool, f32: bool = False) -> dict:
    """The measurements of one tree, in this process."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.ops.flash_attention import _flash_bwd_plain, _flash_fwd

    if not (_ext.__file__.startswith(tree) and chip_smoke.__file__.startswith(tree)):
        raise RuntimeError(f"{tree}: imported {_ext.__file__} and {chip_smoke.__file__}")
    device, smi = chip_smoke.phase_card()
    if fused:
        return run_fused(tree, device, smi, train, f32)
    log = _ext.build(["pfn_flash_fwd", "pfn_flash_bwd"])["pfn_flash_bwd"]["log"]
    out = {"tree": tree, "card": smi,
           "ptxas_dkv": [k for k in chip_smoke.ptxas_report(log) if "dkv" in k["kernel"]]}
    g = torch.Generator(device=device).manual_seed(3)
    qs = (torch.randn(BH, T, D, generator=g, device=device) * D**-0.5).to(torch.bfloat16)
    k, v, do = (torch.randn(BH, T, D, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    for include_diag, seps in ((True, SEPS), (False, [1000])):
        for sep in seps:
            sep_t = torch.full((1,), sep, dtype=torch.int32, device=device)
            o, lse = _flash_fwd(qs, k, v, sep_t, include_diag)
            delta = (do.float() * o.float()).sum(-1)
            got = (_ext.flash_bwd_dq(qs, k, v, do, lse, delta, sep_t, include_diag),
                   *_ext.flash_bwd_dkv(qs, k, v, do, lse, delta, sep_t, include_diag))
            gold = _flash_bwd_plain(qs.float(), k.float(), v.float(), o.float(), lse, do.float(), None, sep_t, T,
                                    include_diag)
            calls = {"dq": lambda: _ext.flash_bwd_dq(qs, k, v, do, lse, delta, sep_t, include_diag),
                     "dkv": lambda: _ext.flash_bwd_dkv(qs, k, v, do, lse, delta, sep_t, include_diag)}
            if include_diag:
                calls["fwd"] = lambda: _flash_fwd(qs, k, v, sep_t, True)
            out[f"{'diag' if include_diag else 'prefix'}_{sep}"] = {
                **{f"{name}_ms": ms(fn) for name, fn in calls.items()},
                **{f"{name}_dev_ms": dev_ms(fn) for name, fn in calls.items()},
                "rel_err": {name: float((a.float() - b).abs().max() / b.abs().max())
                            for name, a, b in zip(("dq", "dk", "dv"), got, gold)},
            }
    if train:
        chip_smoke.phase_train(device, smi)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="*", help="directories holding pfn_tpu_torch and chip_smoke.py")
    parser.add_argument("--fused", action="store_true", help="time the fused layer's kernels, not the flash ones")
    parser.add_argument("--f32", action="store_true", help="with --fused: the f32 bodies, not the bf16 ones")
    parser.add_argument("--train", action="store_true",
                        help="also run each tree's chip_smoke train phase (fused_train with --fused)")
    parser.add_argument("--out", help="also append every JSON line to this file")
    parser.add_argument("--one", help=argparse.SUPPRESS)  # internal: measure this tree in this process
    args = parser.parse_args()
    if args.one:
        print(json.dumps({"ab": run_tree(args.one, args.train, args.fused, args.f32)}), flush=True)
        return 0
    if not args.trees:
        parser.error("give at least one tree")
    trees = [str(Path(t).resolve()) for t in args.trees]
    for tree in trees + trees[::-1]:
        cmd = [sys.executable, __file__, "--one", tree, *(["--train"] if args.train else []),
               *(["--fused"] if args.fused else []), *(["--f32"] if args.f32 else [])]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=tree, env={**os.environ, "PYTHONPATH": tree})
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            raise SystemExit(f"{tree}: exit code {proc.returncode}")
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                record = json.loads(line)
                record["tree"] = tree
                text = json.dumps(record)
                print(text, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
