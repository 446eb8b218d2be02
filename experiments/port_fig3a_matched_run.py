#!/usr/bin/env python3
"""The Fig-3a run of the PyTorch port (``pfn_tpu_torch``) at the round-5
recipe, in slots, and its score against the JAX package's artifact.

    python3 experiments/port_fig3a_matched_run.py --out build/dev/fig3a_matched \\
        --log results/fig3a_matched [--stages exact grid score] [--train_deadline_s S]

The recipe (``ROUND5.md``): the Fig-3a width in bf16, bptt 2010, 4 x 25
microbatches, ``--eval_pos_sampler mixture --num_buckets 10000
--bucket_seq_cap 128``, one 2000-epoch cosine schedule from the first epoch
on. The lineage is the reference artifact's (a fresh init does not train on
the grid sampler): 100 epochs on the exact sampler, then ``--grid 8192`` on
the same checkpoints (``RECIPE``). Every stage calls the port's
drivers, ``fig3a_longrun`` and ``fig3a_analytic_gap``, through their
``main(argv)``, and picks up what an earlier stage or call left under
``--out``:

  exact  ``fig3a_longrun`` without ``--grid`` up to epoch 100 (skipped
         once a checkpoint there exists);
  grid   ``fig3a_longrun --grid 8192``, resuming the newest checkpoint, up to
         epoch 2 000 or, with ``--train_deadline_s``, until the first
         checkpoint epoch past which the next 20 epochs would not end by
         then (seconds since this script started). Epoch 1 620's
         checkpoint is copied aside when it appears, before the driver's
         retention prunes it. The slot stops after 10 epochs if most of
         their updates' gradient norms are not finite (a grid lineage that
         does not train);
  score  ``fig3a_analytic_gap --grid 8192`` (256 datasets, seed 991, the
         nominal noise) on the newest checkpoint and on each kept copy, then
         ``bar_resolution_floor`` and ``analytic_gap_decompose`` on its
         intermediates, ``experiments/compare_analytic_gaps.py`` against
         ``docs/results/analytic_gap_r5.json``, the overlap of the two 95 % CIs of
         ``kl_mean_nominal`` at every ctx >= 400, and the shift between the
         exact and the grid sampler's borders.

A training stage records each update's loss and gradient norm, each epoch's
loss, learning rate, seconds (the train loop's own ``epoch_time``) and
gradient norm, the flash kernels' ``_ext.launch_counts`` and the peak
memory; the last training stage in a process on a card also profiles one
more update (``chip_smoke.device_profile``: device time and idle share).
``--log`` receives small JSON only: ``run_log.json`` (merged over calls),
the analytic-gap, floor and decomposition JSONs and, once the schedule is
done, the driver's ``curves.json``. Checkpoints and the scoring's arrays stay
under ``--out``. Without ``--device`` it runs on the card and raises without
one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # the checkout's pfn_tpu_torch and chip_smoke
T_START = time.perf_counter()
# The round-5 recipe (ROUND5.md:25-29), the lineage's exact epochs, and the
# reference artifact's scoring: epoch 1 620 of 2 000, 8 x 32 datasets.
RECIPE = dict(epochs=2000, exact_epochs=100, grid=8192, bptt=2010, num_buckets=10_000, bucket_seq_cap=128,
              batch_size=4, agg=25, checkpoint_every=20, keep_epochs=(1620,), chunks=8, chunk_batch=32)
REFERENCE = ROOT / "docs" / "results" / "analytic_gap_r5.json"


class StopSlot(Exception):
    """Raised by the recorded train step at a checkpoint epoch to end a slot."""


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "not available"


def latest_epoch(ck_dir: str) -> int:
    from pfn_tpu_torch.train import latest_state_checkpoint

    latest = latest_state_checkpoint(ck_dir)
    return 0 if latest is None else latest[1]


class SlotRecorder:
    """Wraps the train loop's step for one slot: records every update,
    reads the loop's epoch lines, copies kept checkpoints aside and raises
    StopSlot at a checkpoint epoch when the slot has to end."""

    def __init__(self, args, sampler: str, stop_epoch: int | None, deadline_s: float | None):
        self.args, self.sampler = args, sampler
        self.stop_epoch, self.deadline_s = stop_epoch, deadline_s
        self.updates, self.epoch_lines, self.kept = [], {}, []
        self.stopped_by = "schedule end"
        self.step_fn = self.state = self.schedule = None
        self.upe = 4  # updates an epoch: the driver's 4 x agg microbatches, agg a step
        self.start_epoch = None

    def _should_stop(self, epoch: int) -> str | None:
        if self.stop_epoch is not None and epoch >= self.stop_epoch:
            return f"stop epoch {self.stop_epoch}"
        if self.sampler == "grid" and epoch - self.start_epoch == 10:
            first = [u for u in self.updates if u["epoch"] > self.start_epoch]
            if sum(math.isfinite(u["grad_norm"]) for u in first) < len(first) / 2:
                return "grad norms not finite on the grid sampler"
        if self.deadline_s is not None and epoch % self.args.checkpoint_every == 0 and self.updates:
            recent = [u["seconds"] for u in self.updates[-40:]]
            need = 1.1 * sum(recent) / len(recent) * self.upe * self.args.checkpoint_every + 10.0
            if time.perf_counter() - T_START + need > self.deadline_s:
                return f"deadline {self.deadline_s:.0f} s"
        return None

    def make_train_step(self, original):
        def make(prior, criterion, cfg, schedule):
            step = original(prior, criterion, cfg, schedule)
            self.schedule = schedule

            def recorded(state):
                self.step_fn, self.state = step, state
                if state.step % self.upe == 0:  # an epoch begins; its predecessor is saved
                    done = state.step // self.upe
                    if self.start_epoch is None:
                        self.start_epoch = done
                    self._keep(done)
                    why = self._should_stop(done) if done > self.start_epoch else None
                    if why:
                        self.stopped_by = why
                        raise StopSlot(why)
                t0 = time.perf_counter()
                m = step(state)
                grad_norm, loss = float(m["grad_norm"]), float(m["loss"])
                self.updates.append({"step": state.step, "epoch": (state.step - 1) // self.upe + 1, "loss": loss,
                                     "grad_norm": grad_norm, "seconds": time.perf_counter() - t0})
                return m

            return recorded

        return make

    def _keep(self, epoch: int) -> None:
        src = Path(self.args.out) / "ck" / f"epoch_{epoch}"
        if epoch in self.args.keep_epochs and src.exists():
            dst = Path(self.args.out) / f"keep_{epoch}" / f"epoch_{epoch}"
            if not dst.exists():
                shutil.copytree(src, dst)
                self.kept.append(epoch)

    def print_hook(self, *parts, **kw):
        text = " ".join(str(p) for p in parts)
        if text.startswith("| epoch"):
            fields = [f.strip() for f in text.strip("| ").split("|")]
            epoch = int(fields[0].split()[1])
            self.epoch_lines[epoch] = float(fields[1].split()[1].rstrip("s"))
            if epoch % 20 and epoch != 1:
                return  # keep the terminal short; every epoch is in run_log.json
        print(text, **kw, flush=True)

    def epochs(self) -> list:
        by_epoch = {}
        for u in self.updates:
            by_epoch.setdefault(u["epoch"], []).append(u)
        out = []
        for epoch, ups in sorted(by_epoch.items()):
            if len(ups) != self.upe:
                continue  # an epoch cut by the stop
            out.append({"epoch": epoch, "mean_loss": sum(u["loss"] for u in ups) / len(ups),
                        "lr": float(self.schedule((epoch - 1) * self.upe)),
                        "epoch_time": self.epoch_lines.get(epoch),
                        "update_seconds": sum(u["seconds"] for u in ups),
                        "grad_norm": sum(u["grad_norm"] for u in ups) / len(ups),
                        "grad_norm_max": max(u["grad_norm"] for u in ups)})
        return out


def recipe(args) -> list:
    return (["--epochs", str(args.epochs), "--bptt", str(args.bptt), "--eval_pos_sampler", "mixture",
             "--num_buckets", str(args.num_buckets), "--bucket_seq_cap", str(args.bucket_seq_cap),
             "--batch_size", str(args.batch_size), "--agg", str(args.agg),
             "--checkpoint_every", str(args.checkpoint_every), "--out", args.out]
            + (["--device", args.device] if args.device else []))


def train_slot(args, sampler: str, stop_epoch: int | None, deadline_s: float | None, profile: bool) -> dict:
    import torch

    from pfn_tpu_torch.experiments import fig3a_longrun
    from pfn_tpu_torch.experiments.common import resolve_device
    from pfn_tpu_torch.ops import _ext
    from pfn_tpu_torch.train import loop

    rec = SlotRecorder(args, sampler, stop_epoch, deadline_s)
    argv = recipe(args) + (["--grid", str(args.grid)] if sampler == "grid" else [])
    first_epoch = latest_epoch(os.path.join(args.out, "ck")) + 1
    original_step = loop.make_train_step
    loop.make_train_step = rec.make_train_step(original_step)
    loop.print = rec.print_hook
    cuda = resolve_device(args.device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        summary = fig3a_longrun.main(argv)
        done = summary["done"]
    except StopSlot:
        done = False
    finally:
        loop.make_train_step = original_step
        del loop.print
    seconds = time.perf_counter() - t0
    launches = dict(_ext.launch_counts)
    epochs = rec.epochs()
    loop_times = [e["epoch_time"] for e in epochs[1:] if e["epoch_time"] is not None]
    slot = {
        "sampler": sampler, "args": argv, "first_epoch": first_epoch,
        "last_checkpoint": latest_epoch(os.path.join(args.out, "ck")), "done": done,
        "stopped_by": rec.stopped_by if not done else "schedule end", "seconds": seconds,
        "s_per_epoch_median": sorted(loop_times)[len(loop_times) // 2] if loop_times else None,
        "s_per_epoch_mean": sum(loop_times) / len(loop_times) if loop_times else None,
        "updates": len(rec.updates), "nonfinite_grad_norms": sum(not math.isfinite(u["grad_norm"])
                                                                 for u in rec.updates),
        "first_updates": rec.updates[:40], "launches": launches,
        "launches_per_update": {k: v / max(1, len(rec.updates)) for k, v in launches.items() if v},
        "kept": rec.kept, "epochs": epochs,
    }
    if cuda:
        slot["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if profile and rec.step_fn is not None:
            import chip_smoke

            step, state = rec.step_fn, rec.state
            slot["update_profile"] = chip_smoke.device_profile(lambda: float(step(state)["loss"]), top=10)
    if done and os.path.exists(os.path.join(args.out, "curves.json")):
        shutil.copy(os.path.join(args.out, "curves.json"), os.path.join(args.log, "curves.json"))
    return slot


def border_shift(args) -> tuple:
    """The exact and the grid sampler's borders, as each slot's
    ``fig3a_longrun`` builds its criterion: (their largest and mean shift,
    the grid's borders)."""
    import numpy as np

    from pfn_tpu_torch.experiments.common import GP_HP, bucket_criterion, resolve_device
    from pfn_tpu_torch.priors import GPPrior

    device = resolve_device(args.device)
    b = {g: bucket_criterion(GPPrior(num_features=1, grid=g, **GP_HP), args.num_buckets, args.bptt, device, seed=7,
                             max_seq_len=args.bucket_seq_cap).bar.borders.cpu().numpy().astype(np.float64)
         for g in (0, args.grid)}
    d = np.abs(b[0] - b[args.grid])
    inner = d[1:-1]
    return {"max_abs_shift": float(d.max()), "argmax": int(d.argmax()), "mean_abs_shift": float(d.mean()),
            "max_abs_shift_inner": float(inner.max()), "span_exact": [float(b[0][0]), float(b[0][-1])],
            "span_grid": [float(b[args.grid][0]), float(b[args.grid][-1])]}, b[args.grid]


def ci_check(reference: dict, port: dict) -> dict:
    """Per ctx >= 400: do the two 95 % CIs of kl_mean_nominal overlap, and
    does the port's mean fall inside the reference's CI."""
    rows = []
    for i, ctx in enumerate(port["positions"]):
        if ctx < 400 or ctx not in reference["positions"]:
            continue
        j = reference["positions"].index(ctx)
        (rlo, rhi), (plo, phi) = reference["kl_ci95_nominal"][j], port["kl_ci95_nominal"][i]
        mean = port["kl_mean_nominal"][i]
        rows.append({"ctx": ctx, "reference_mean": reference["kl_mean_nominal"][j], "reference_ci95": [rlo, rhi],
                     "port_mean": mean, "port_ci95": [plo, phi], "port_median": port["kl_median_nominal"][i],
                     "ci_overlap": bool(plo <= rhi and rlo <= phi), "mean_inside_reference_ci": bool(rlo <= mean <= rhi)})
    return {"rows": rows, "overlap_at_every_ctx_ge_400": bool(rows) and all(r["ci_overlap"] for r in rows)}


def score(args, run_log: dict) -> dict:
    import numpy as np
    import torch

    from pfn_tpu_torch.experiments import analytic_gap_decompose, bar_resolution_floor, fig3a_analytic_gap
    from pfn_tpu_torch.experiments.common import resolve_device

    dev = ["--device", args.device] if args.device else []
    device = resolve_device(args.device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    targets = [(latest_epoch(os.path.join(args.out, "ck")), os.path.join(args.out, "ck"))]
    targets += [(e, os.path.join(args.out, f"keep_{e}")) for e in args.keep_epochs
                if os.path.isdir(os.path.join(args.out, f"keep_{e}")) and e != targets[0][0]]
    exact = run_log.get("exact_epochs", args.exact_epochs)
    with open(REFERENCE) as f:
        reference = json.load(f)
    shift, grid_borders = border_shift(args)
    scores = {}
    for epoch, ck in targets:
        buckets = f"{args.num_buckets // 1000}k" if args.num_buckets % 1000 == 0 else str(args.num_buckets)
        label = (f"pfn_tpu_torch {kind} grid{args.grid} mixture {buckets}buckets "
                 f"cap{args.bucket_seq_cap} exact{exact} epoch{epoch}/of{args.epochs} (one {args.epochs}-epoch "
                 "cosine from epoch 1)")
        agap = os.path.join(args.out, f"agap_epoch{epoch}")
        t0 = time.perf_counter()
        gap = fig3a_analytic_gap.main(dev + [
            "--ck", ck, "--out", agap, "--grid", str(args.grid), "--num_buckets", str(args.num_buckets),
            "--bucket_seq_cap", str(args.bucket_seq_cap), "--bptt", str(args.bptt), "--chunks", str(args.chunks),
            "--chunk_batch", str(args.chunk_batch), "--label", label])
        agap_s = time.perf_counter() - t0
        gap_json = os.path.join(args.log, f"analytic_gap_epoch{epoch}.json")
        shutil.copy(os.path.join(agap, "analytic_gap.json"), gap_json)
        t0 = time.perf_counter()
        floor = bar_resolution_floor.main(dev + [
            "--moments", os.path.join(agap, "oracle_moments.npz"), "--analytic", os.path.join(agap, "analytic_gap.json"),
            "--check_borders", os.path.join(agap, "borders.npy"), "--bptt", str(args.bptt),
            "--seq_cap", str(args.bucket_seq_cap), "--out", os.path.join(args.log, f"bar_resolution_floor_epoch{epoch}.json")])
        floor_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        decomp = analytic_gap_decompose.main(dev + [
            "--dir", agap, "--label", label, "--out", os.path.join(args.log, f"analytic_gap_decompose_epoch{epoch}.json")])
        decomp_s = time.perf_counter() - t0
        table = subprocess.run([sys.executable, str(ROOT / "experiments" / "compare_analytic_gaps.py"), str(REFERENCE),
                                gap_json, "--labels", "jax_tpu", "torch"], capture_output=True, text=True).stdout
        print(table, flush=True)
        scores[str(epoch)] = {
            "label": label, "seconds": {"analytic_gap": agap_s, "floor": floor_s, "decompose": decomp_s},
            "borders_equal_grid_criterion": bool(np.array_equal(np.load(os.path.join(agap, "borders.npy")),
                                                                grid_borders.astype(np.float32))),
            "check": ci_check(reference, gap), "compare_table": table,
            "kl_mean_nominal": gap["kl_mean_nominal"], "kl_median_nominal": gap["kl_median_nominal"],
            "floor_mean_10000b": floor.get("floor_mean_10000b"),
            "out_of_support_mass_mean_10000b": floor.get("out_of_support_mass_mean_10000b"),
            "tail_share": [t / max(tot, 1e-300) for t, tot in zip(decomp["kl_tail_mean"], decomp["kl_total_mean"])],
        }
    return {"border_shift": shift, "scores": scores}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card; 'cpu' runs on the host)")
    ap.add_argument("--out", default="build/dev/fig3a_matched")
    ap.add_argument("--log", default="results/fig3a_matched")
    ap.add_argument("--stages", nargs="+", default=["exact", "grid", "score"], choices=["exact", "grid", "score"])
    ap.add_argument("--train_deadline_s", type=float, default=None)
    args = ap.parse_args(argv)
    vars(args).update(RECIPE)
    if args.exact_epochs % args.checkpoint_every:
        raise SystemExit("RECIPE: exact_epochs must be a multiple of checkpoint_every (a slot ends on a checkpoint)")
    from pfn_tpu_torch.experiments.common import resolve_device

    resolve_device(args.device)  # the card unless told otherwise
    os.makedirs(args.log, exist_ok=True)
    log_path = os.path.join(args.log, "run_log.json")
    run_log = {"calls": [], "slots": []}
    if os.path.exists(log_path):
        with open(log_path) as f:
            run_log = json.load(f)
    run_log.setdefault("exact_epochs", args.exact_epochs)
    call = {"card": card_line(), "stages": args.stages}
    import torch

    call["torch"] = [torch.__version__, torch.version.cuda]
    run_log["calls"].append(call)

    def save():
        with open(log_path, "w") as f:
            json.dump(run_log, f, indent=1)

    training = [s for s in args.stages if s != "score"]
    for i, stage in enumerate(training):
        last = i == len(training) - 1
        if stage == "exact":
            if latest_epoch(os.path.join(args.out, "ck")) >= args.exact_epochs:
                continue
            slot = train_slot(args, "exact", args.exact_epochs, args.train_deadline_s, profile=last)
        else:
            slot = train_slot(args, "grid", None, args.train_deadline_s, profile=last)
        slot["call"] = len(run_log["calls"])
        run_log["slots"].append(slot)
        save()
        print(json.dumps({k: slot[k] for k in ("sampler", "first_epoch", "last_checkpoint", "stopped_by",
                                               "s_per_epoch_median", "updates", "nonfinite_grad_norms",
                                               "launches")}), flush=True)
        if slot["stopped_by"].startswith("grad norms") or slot["last_checkpoint"] < args.exact_epochs:
            break  # a grid lineage that does not train, or one without its exact epochs
    if "score" in args.stages:
        result = score(args, run_log)
        run_log["border_shift"] = result["border_shift"]
        run_log.setdefault("scores", {}).update(result["scores"])
        save()
        for epoch, s in result["scores"].items():
            print(json.dumps({"epoch": epoch, **s["check"]}), flush=True)
    call["seconds"] = time.perf_counter() - T_START
    save()
    return run_log


if __name__ == "__main__":
    main()
