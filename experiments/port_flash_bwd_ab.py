#!/usr/bin/env python3
"""Time the flash backward kernels of the PyTorch port (``pfn_tpu_torch``) in
several checkouts, in turns, on one NVIDIA GPU.

    python3 experiments/port_flash_bwd_ab.py TREE_A TREE_B [--train] [--out FILE]

Each TREE is a directory that holds a ``pfn_tpu_torch`` package and its
``chip_smoke.py``: a checkout, or a commit unpacked by ``git archive`` into a
git-ignored directory. The trees run in the order A B B A (with more trees,
the list and then its reverse), each in a process of its own, so that each
imports its own package and builds its own kernels into its own ``build/``.
Comparing two versions is only meaningful within one such call on one card.

Each run prints one JSON line, tagged with its tree: the dq and dk/dv
kernels' mean time by CUDA events (50 calls after 5 warm-ups) at the training
microbatch (B*H 16, T 2010, D 128, bf16) at sep 400, 1000, 1595 and 2000 and
for the prefix variant at sep 1000, each with its largest error against the
plain backward relative to the gold's largest entry; ptxas's registers and
spills of the dk/dv kernels; and with ``--train`` the JSON line of that
tree's ``chip_smoke.phase_train`` (the Fig-3a update at full width). Any
failure of a run stops the script with a nonzero exit.
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


def run_tree(tree: str, train: bool) -> dict:
    """The measurements of one tree, in this process."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.ops.flash_attention import _flash_bwd_plain, _flash_fwd

    if not (_ext.__file__.startswith(tree) and chip_smoke.__file__.startswith(tree)):
        raise RuntimeError(f"{tree}: imported {_ext.__file__} and {chip_smoke.__file__}")
    device, smi = chip_smoke.phase_card()
    log = _ext.build(["pfn_flash_fwd", "pfn_flash_bwd"])["pfn_flash_bwd"]["log"]
    out = {"tree": tree, "card": smi,
           "ptxas_dkv": [k for k in chip_smoke.ptxas_report(log) if "dkv" in k["kernel"]]}
    g = torch.Generator(device=device).manual_seed(3)
    qs = (torch.randn(BH, T, D, generator=g, device=device) * D**-0.5).to(torch.bfloat16)
    k, v, do = (torch.randn(BH, T, D, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    def ms(fn):
        return chip_smoke.cuda_ms(fn, iters=50, warmup=5)

    for include_diag, seps in ((True, SEPS), (False, [1000])):
        for sep in seps:
            sep_t = torch.full((1,), sep, dtype=torch.int32, device=device)
            o, lse = _flash_fwd(qs, k, v, sep_t, include_diag)
            delta = (do.float() * o.float()).sum(-1)
            got = (_ext.flash_bwd_dq(qs, k, v, do, lse, delta, sep_t, include_diag),
                   *_ext.flash_bwd_dkv(qs, k, v, do, lse, delta, sep_t, include_diag))
            gold = _flash_bwd_plain(qs.float(), k.float(), v.float(), o.float(), lse, do.float(), None, sep_t, T,
                                    include_diag)
            out[f"{'diag' if include_diag else 'prefix'}_{sep}"] = {
                "dq_ms": ms(lambda: _ext.flash_bwd_dq(qs, k, v, do, lse, delta, sep_t, include_diag)),
                "dkv_ms": ms(lambda: _ext.flash_bwd_dkv(qs, k, v, do, lse, delta, sep_t, include_diag)),
                "rel_err": {name: float((a.float() - b).abs().max() / b.abs().max())
                            for name, a, b in zip(("dq", "dk", "dv"), got, gold)},
            }
    if train:
        chip_smoke.phase_train(device, smi)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="*", help="directories holding pfn_tpu_torch and chip_smoke.py")
    parser.add_argument("--train", action="store_true", help="also run each tree's chip_smoke train phase")
    parser.add_argument("--out", help="also append every JSON line to this file")
    parser.add_argument("--one", help=argparse.SUPPRESS)  # internal: measure this tree in this process
    args = parser.parse_args()
    if args.one:
        print(json.dumps({"ab": run_tree(args.one, args.train)}), flush=True)
        return 0
    if not args.trees:
        parser.error("give at least one tree")
    trees = [str(Path(t).resolve()) for t in args.trees]
    for tree in trees + trees[::-1]:
        cmd = [sys.executable, __file__, "--one", tree, *(["--train"] if args.train else [])]
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
