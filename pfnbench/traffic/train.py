"""Training traffic: the port's training step, ``make_train_step``, on one
``TrainState``, as ``train()`` drives it.

Set-up builds the one state (the benchmark's weights, the port's Adam, the
training generator seeded from ``--seed``) and drives it through its first
three updates, each ``aggregate_k_gradients`` microbatches drawn on the
card by the port's prior, with one host sync as the loop reads the loss.
Those updates warm every shape and give what the reference checks: the
microbatches, each update's loss and sep histogram, the first clipped
gradient (Adam's first moment after one step) and the change after three.
One more update at sep 0 (the port's ``fixed`` sampler) decodes every row:
the largest shapes an update has, so that the caching allocator has grown
to them before the window, as it has early in a long training run. The
same state then runs the window: whole updates back to back until
``seconds`` have passed, its generator seeded anew with ``WINDOW_DATA``,
the same for every seed, so that every run's window draws the same seps
and does the same work. The traced run adds a profiled stretch of about a
second of further updates.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import torch

from pfnbench import borders, check, flops, program, spec, trace, weights
from pfnbench.reference import part
from pfnbench.reference import train as ref_train
from pfnbench.seeds import DATA, WEIGHTS, WINDOW_DATA, derive

END_TO_END = ("train_datasets_per_s", "setup_s")
SETUP_UPDATES = 3
PROFILE_S = 1.0


class _KeepingPrior:
    """The port's prior, keeping a copy of each microbatch while ``kept`` is
    a list (the set-up updates only)."""

    def __init__(self, prior):
        self.prior = prior
        self.num_features, self.num_outputs = prior.num_features, prior.num_outputs
        self.kept = []

    def sample(self, *args, **kwargs):
        x, y, target_y = self.prior.sample(*args, **kwargs)
        if self.kept is not None:
            self.kept.append({"x": x.detach().clone(), "y": target_y.detach().clone()})
        return x, y, target_y


def _seps(counts) -> list[int]:
    """The seps, with repeats, of summed sep histograms."""
    total = torch.stack([c.float() for c in counts]).sum(0).cpu().round().long()
    return [s for s in range(total.numel()) for _ in range(int(total[s]))]


def run(cell) -> dict:
    from pfn_tpu_torch.train import TrainState
    from pfn_tpu_torch.train.loop import _make_optimizer, make_train_step

    wl, cfg, dev = cell.workload, cell.config, torch.device(cell.device)
    m, t = cfg["model"], cfg["train"]
    B, k, T = wl["batch_size"], wl["aggregate_k_gradients"], t["bptt"]
    nf, n_out = cfg["prior"]["num_features"], program.n_out(cfg)
    net = spec.program_model(spec.model_kind(cfg), cell.root)
    cuda = dev.type == "cuda"

    cell.mark("imports")
    bucket_borders = borders.make(cfg["criterion"], cfg["prior"], dev)
    cell.mark("borders")
    shapes = net.parameter_shapes(m, nf, n_out)
    drawn = weights.make(shapes, derive(cell.seed, WEIGHTS), dev)
    cell.mark("weights")
    prior, criterion, tcfg, model = net.build(cfg, dev, drawn, bucket_borders, batch_size=B, aggregate_k_gradients=k)
    del drawn
    optimizer, _, _ = _make_optimizer(tcfg, model)
    cell.mark("model")
    state = TrainState(model, optimizer, torch.Generator(device=dev).manual_seed(derive(cell.seed, DATA)))
    keeping = _KeepingPrior(prior)
    step = make_train_step(keeping, criterion, tcfg, lambda count: t["lr"])

    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    losses, counts = [], []
    for i in range(SETUP_UPDATES):
        out = step(state)
        losses.append(float(out["loss"]))
        counts.append(out["pos_cnt"].detach().cpu())
        cell.mark(f"update {i + 1}")
        if i == 0:
            # An optimizer that took no step holds no moment: its gradient reads 0.
            grads = check.leaf_norms({n: optimizer.state[p]["exp_avg"].double() / (1 - ref_train.BETA1)
                                      if "exp_avg" in optimizer.state[p] else torch.zeros_like(p)
                                      for n, p in params.items()})
    changes = check.leaf_norms({n: p.detach().double() - start[n].double() for n, p in params.items()})
    del start
    seen = {"losses": losses, "pos_cnt": counts, "grad_leaf_norms": grads, "change_leaf_norms": changes,
            "batches": keeping.kept}
    keeping.kept = None
    # Sep 0 decodes every row: the allocator grows to the largest update before the window.
    largest = make_train_step(prior, criterion, dataclasses.replace(tcfg, eval_pos_sampler="fixed", fixed_eval_pos=0),
                              lambda count: t["lr"])
    float(largest(state)["loss"])
    cell.mark("update at sep 0")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    # The window.
    state.generator.manual_seed(WINDOW_DATA)
    program.synchronize(dev)
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start
    enqueue, ends, window_counts, failed = [], [t0], [], 0
    while True:
        a = time.perf_counter()
        out = step(state)
        enqueue.append(time.perf_counter() - a)
        failed += not math.isfinite(float(out["loss"]))
        ends.append(time.perf_counter())
        window_counts.append(out["pos_cnt"])
        if ends[-1] - t0 >= cell.seconds:
            break
    window_s = ends[-1] - t0
    updates = len(enqueue)
    result = {"metrics": {"train_datasets_per_s": updates * B * k / window_s, "setup_s": setup_s},
              "attempted": updates, "failed": failed,
              "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0}

    if cell.trace:
        def one():
            out = step(state)
            float(out["loss"])
            return out["pos_cnt"]

        prof = trace.profile(one, max(2, math.ceil(PROFILE_S * updates / window_s)))
        result["trace"] = {
            "kind": "train", "enqueue_s": enqueue, "window_s": window_s,
            "required_flops": net.train_flops(m, nf, n_out, B, T, _seps(window_counts)),
            "peak_flops": flops.PEAK_FLOPS[m["dtype"]], "profile": prof,
            "attention_calls": net.attention_calls(m, B, T, _seps(prof["results"]), "train")}

    del state, optimizer, model, step, largest, params, keeping, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    # The reference: the same seeds, the first three updates.
    steps = ref_train.replay(torch.Generator(device=dev).manual_seed(derive(cell.seed, DATA)), t, cfg["prior"], B, k,
                             SETUP_UPDATES)
    taken = check.adopt_ambiguous_labels(seen["batches"], [mb for update in steps for mb in update])
    ref = ref_train.follow(part("model", spec.model_kind(cfg), cell.root),
                           weights.make(shapes, derive(cell.seed, WEIGHTS), dev), m, n_out, cfg["criterion"]["kind"],
                           bucket_borders, steps, t["lr"])
    ref["batches"] = [mb for update in steps for mb in update]
    ref["seps"] = [[mb["sep"] for mb in update] for update in steps]
    result["numbers"] = check.train_numbers(seen, ref, T)
    result["detail"] = dict(check.worst_leaves(seen, ref), labels_taken=taken,
                            step_s=[b - a for a, b in zip(ends, ends[1:])])
    result["reference_s"] = time.perf_counter() - t_ref
    return result
