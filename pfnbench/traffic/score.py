"""Scoring traffic: ``evals.harness.eval_positional_logits_per_dataset`` on
the model in eval mode, as a trained Fig-3a checkpoint is scored.

Set-up draws a pool of ``pool_chunks`` chunks of ``datasets`` datasets from
``--seed`` (the benchmark's own draw of the configuration's prior), and
warms the pass on one chunk. The window cycles through the pool: each pass
returns the logits of the scored positions of every dataset, copied to the
host. The reference then scores the last copy of each chunk again.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from pfnbench import borders, check, flops, program, spec, trace, weights
from pfnbench.reference import part
from pfnbench.reference import score as ref_score
from pfnbench.seeds import SCORE, WEIGHTS, derive

END_TO_END = ("score_positions_per_s", "setup_s")
PROFILE_S = 1.0


def run(cell) -> dict:
    from pfn_tpu_torch.evals.harness import eval_positional_logits_per_dataset

    wl, cfg, dev = cell.workload, cell.config, torch.device(cell.device)
    m, T = cfg["model"], cfg["train"]["bptt"]
    B, P, positions = wl["datasets"], wl["pool_chunks"], wl["positions"]
    nf, n_out = cfg["prior"]["num_features"], program.n_out(cfg)
    net = spec.program_model(spec.model_kind(cfg), cell.root)
    cuda = dev.type == "cuda"

    cell.mark("imports")
    bucket_borders = borders.make(cfg["criterion"], cfg["prior"], dev)
    cell.mark("borders")
    shapes = net.parameter_shapes(m, nf, n_out)
    _, _, _, model = net.build(cfg, dev, weights.make(shapes, derive(cell.seed, WEIGHTS), dev), bucket_borders,
                               batch_size=B)
    model.eval()
    g = torch.Generator(device=dev).manual_seed(derive(cell.seed, SCORE))
    draw = part("prior", cfg["prior"]["kind"]).draw
    pool = [{k: v.float() for k, v in draw(g, B, T, cfg["prior"]).items() if k in ("x", "y")} for _ in range(P)]
    cell.mark("model and pool")

    def chunk(i):
        return eval_positional_logits_per_dataset(model, pool[i]["x"], pool[i]["y"], positions)

    chunk(0).cpu()
    cell.mark("pass 1")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    program.synchronize(dev)
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start
    enqueue, ends, last, failed, n = [], [t0], {}, 0, 0
    while True:
        a = time.perf_counter()
        logits = chunk(n % P)
        enqueue.append(time.perf_counter() - a)
        last[n % P] = logits.cpu()
        ends.append(time.perf_counter())
        failed += not bool(torch.isfinite(last[n % P]).all())
        n += 1
        if ends[-1] - t0 >= cell.seconds:
            break
    window_s = ends[-1] - t0
    result = {"metrics": {"score_positions_per_s": n * B * len(positions) / window_s, "setup_s": setup_s},
              "attempted": n, "failed": failed,
              "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0}

    if cell.trace:
        def one():
            return chunk(0).cpu()

        calls = max(2, math.ceil(PROFILE_S * n / window_s))
        prof = trace.profile(one, calls)
        result["trace"] = {
            "kind": "score", "enqueue_s": enqueue, "window_s": window_s,
            "required_flops": n * net.score_flops(m, nf, n_out, B, positions),
            "peak_flops": flops.PEAK_FLOPS[m["dtype"]], "profile": prof,
            "attention_calls": [dict(c, count=c["count"] * calls)
                                for c in net.attention_calls(m, B, T, positions, "score")]}

    del model, logits
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    params = weights.make(shapes, derive(cell.seed, WEIGHTS), dev)
    ref_net = part("model", spec.model_kind(cfg), cell.root)
    result["numbers"] = {"logit_tv": max(
        check.logit_tv(last[i], ref_score.logits_at(ref_net, params, m, pool[i]["x"], pool[i]["y"], positions).cpu())
        for i in sorted(last))}
    result["reference_s"] = time.perf_counter() - t_ref
    result["detail"] = {"step_s": [b - a for a, b in zip(ends, ends[1:])]}
    return result
