"""Readings from which a cell's limits are set (run on the card).

    python3 -m pfnbench.calibrate --workload <cell> --seeds 1,2,... --control-seeds 7,8,9 \\
        [--seconds 1] [--out chiprun_out/calibrate_<cell>.json]

For each of ``--seeds``: a sound run of the program (a short window), and
its numbers against the reference: the lower readings. For each of
``--control-seeds``: the control (the reference computed one precision
below the configuration's, the model kind's ``control``) put in the
program's place, and the planted faults the cell can have, each against the
reference: the upper readings. Train cells: half of every microbatch's
datasets left out (the mean over the rest); a state left unchanged reads 1
on ``change_gap`` by its measure. The score cell: one dataset's logits at
one position answered with another's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from pfnbench import borders, check, program, run, spec, weights
from pfnbench.reference import part
from pfnbench.reference import score as ref_score
from pfnbench.reference import train as ref_train
from pfnbench.seeds import DATA, SCORE, WEIGHTS, derive


def _train_side(cfg: dict, wl: dict, seed: int, device, prec: dict | None, prior_mode: str, drop_half: bool = False):
    """What the check reads of a run of the reference (at ``prec``, None:
    float32) in the program's place."""
    t, m, n_out, kind = cfg["train"], cfg["model"], program.n_out(cfg), spec.model_kind(cfg)
    B, k = wl["batch_size"], wl["aggregate_k_gradients"]
    steps = ref_train.replay(torch.Generator(device=device).manual_seed(derive(seed, DATA)), t, cfg["prior"], B, k,
                             3, prior_mode)
    shapes = spec.program_model(kind).parameter_shapes(m, cfg["prior"]["num_features"], n_out)
    out = ref_train.follow(part("model", kind), weights.make(shapes, derive(seed, WEIGHTS), device), m, n_out,
                           cfg["criterion"]["kind"], borders.make(cfg["criterion"], cfg["prior"], device), steps,
                           t["lr"], prec, drop_half)
    out["batches"] = [mb for update in steps for mb in update]
    out["seps"] = [[mb["sep"] for mb in update] for update in steps]
    out["pos_cnt"] = []
    for update in steps:
        counts = torch.zeros(t["bptt"])
        for mb in update:
            counts[mb["sep"]] += 1
        out["pos_cnt"].append(counts)
    return out


def train_upper(cfg: dict, wl: dict, seed: int, device) -> dict:
    ref = _train_side(cfg, wl, seed, device, None, "f32")
    ctl = part("model", spec.model_kind(cfg)).control(cfg["model"]["dtype"])
    readings = {"control": check.train_numbers(_train_side(cfg, wl, seed, device, ctl, ctl["prior"]), ref,
                                               cfg["train"]["bptt"]),
                "half_batch": check.train_numbers(_train_side(cfg, wl, seed, device, None, "f32", True), ref,
                                                  cfg["train"]["bptt"])}
    unchanged = dict(ref, change_leaf_norms={n: 0.0 for n in ref["change_leaf_norms"]})
    readings["unchanged_state"] = {"change_gap": check.train_numbers(unchanged, ref, cfg["train"]["bptt"])[
        "change_gap"]}
    return readings


def score_upper(cfg: dict, wl: dict, seed: int, device) -> dict:
    m, T, kind = cfg["model"], cfg["train"]["bptt"], spec.model_kind(cfg)
    B, P, positions = wl["datasets"], wl["pool_chunks"], wl["positions"]
    g = torch.Generator(device=device).manual_seed(derive(seed, SCORE))
    draw = part("prior", cfg["prior"]["kind"]).draw
    pool = [draw(g, B, T, cfg["prior"]) for _ in range(P)]
    shapes = spec.program_model(kind).parameter_shapes(m, cfg["prior"]["num_features"], program.n_out(cfg))
    params = weights.make(shapes, derive(seed, WEIGHTS), device)
    net = part("model", kind)
    ctl = net.control(m["dtype"])
    control, altered = 0.0, 0.0
    for chunk in pool:
        ref = ref_score.logits_at(net, params, m, chunk["x"], chunk["y"], positions).cpu()
        low = ref_score.logits_at(net, params, m, chunk["x"], chunk["y"], positions, ctl).cpu()
        control = max(control, check.logit_tv(low, ref))
        wrong = ref.clone()
        wrong[len(positions) // 2, 0] = ref[len(positions) // 2, 1]
        altered = max(altered, check.logit_tv(wrong, ref))
    return {"control": {"logit_tv": control}, "altered_answer": {"logit_tv": altered}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    wl = spec.workload(args.workload)
    cfg = spec.config(wl["config"])
    device = "cuda"
    out = {"workload": args.workload, "card": run.card(), "lower": {}, "upper": {}}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        r = run.run(args.workload, seed, args.seconds, False, device, t_start=t0)
        out["lower"][seed] = dict(r["numbers"])
        worst = {k: v for k, v in r["timing"]["detail"].items() if k != "step_s"}
        print(f"lower seed {seed} {out['lower'][seed]} {worst} ({time.perf_counter() - t0:.1f} s)", file=sys.stderr,
              flush=True)
        torch.cuda.empty_cache()
    upper = train_upper if wl["kind"] == "train" else score_upper
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        out["upper"][seed] = upper(cfg, wl, seed, device)
        print(f"upper seed {seed} {out['upper'][seed]} ({time.perf_counter() - t0:.1f} s)", file=sys.stderr,
              flush=True)
        torch.cuda.empty_cache()
    path = Path(args.out or f"chiprun_out/calibrate_{args.workload}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
