"""Run one cell of the benchmark once and print its result line.

    python3 -m pfnbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``workloads/<cell>.json`` (``spec``). The run sets the cell up
from the seed (that time is ``setup_s``, counted from the start of this
module), measures for ``--seconds``, and with ``--trace 1`` adds a profiled
stretch for the per-layer metrics. Once the window has closed and the peak
memory is read, the program's state is freed and the plain reference
(``reference/``) decides ``correct``. The last lines on standard error
give each number compared beside its limit; the last line on standard
output is the result's JSON object. Without a CUDA card, with fewer cards
than the cell asks for, or with ``jax``, ``jaxlib``, ``flax``, ``optax`` or
the JAX package loaded, the run prints no result and exits with 2 or 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

from pfnbench import check, spec  # noqa: E402
from pfnbench import trace as tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pfn_tpu")
CHECKOUT = spec.ROOT.parent


def loaded_forbidden() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _cache_dirs() -> None:
    """Keep any kernel cache the program's libraries use inside the checkout,
    at fixed paths (the port's own nvcc builds go to build/pfn_tpu_torch/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(CHECKOUT / "build" / "pfnbench" / sub))


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", bench: dict | None = None,
        workload_spec: dict | None = None, config: dict | None = None, t_start: float | None = None,
        root: Path = spec.ROOT) -> dict:
    """One run of ``workload``: the result object, without the device
    check. ``workload_spec`` and ``config`` replace the cell's files (the
    tests run small copies on the CPU); the config's model kind is found
    under ``root``."""
    bench = spec.benchmark() if bench is None else bench
    wl = spec.workload(workload) if workload_spec is None else workload_spec
    cfg = spec.config(wl["config"]) if config is None else config
    t_start = T_START if t_start is None else t_start
    marks = []
    cell = types.SimpleNamespace(name=workload, workload=wl, config=cfg, seed=int(seed), seconds=float(seconds),
                                 trace=bool(trace), device=device, t_start=t_start, root=root,
                                 mark=lambda phase: marks.append((phase, time.perf_counter() - t_start)))
    traffic = spec.traffic(wl["kind"])
    e2e, per_layer = spec.cell_metrics(bench, workload)
    out = traffic.run(cell)
    correct, checks = check.judge(out["numbers"], wl["limits"])
    if trace:
        metrics = {}
        for m in per_layer:
            value = spec.metric_reader(m["name"]).read(out["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]} for m in e2e}
    import torch

    on_card = torch.device(device).type == "cuda"
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": wl["chips"], "memory_peak_bytes": int(out["memory_peak_bytes"])}}
    if trace and out["trace"]["profile"]["window"]:
        prof = out["trace"]["profile"]
        result["device"]["busy_s"] = tracing.busy_us(prof) * 1e-6
        result["device"]["window_s"] = tracing.window_us(prof) * 1e-6
        result["breakdown"] = tracing.breakdown(prof)
    result["timing"] = {"setup_s": out["metrics"]["setup_s"], "reference_s": out["reference_s"], "marks": marks,
                        "detail": out["detail"]}
    result["checks"] = checks
    result["numbers"] = out["numbers"]
    return result


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = spec.benchmark()
    wl = spec.workload(args.workload)
    if args.workload not in {w["name"] for w in bench["workloads"]}:
        print(f"pfnbench: {args.workload} is not a cell of {spec.BENCHMARK.name}", file=sys.stderr)
        return 2
    _cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"pfnbench: the cell needs {wl['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # one process, few threads: the host's share of a run steadier
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", bench, wl)
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"pfnbench: modules of {', '.join(forbidden)} were loaded; no result", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    numbers = result.pop("numbers")
    timing = result.pop("timing")
    result["card"] = card()
    detail = timing["detail"]
    steps = sorted(detail.pop("step_s"))
    print(f"timing setup_s {timing['setup_s']!r} reference_s {timing['reference_s']!r} set-up marks "
          + " ".join(f"{phase}={t:.2f}" for phase, t in timing["marks"]), file=sys.stderr)
    print(f"window steps {len(steps)} min {steps[0]!r} median {steps[len(steps) // 2]!r} max {steps[-1]!r}; "
          f"worst leaves {detail}; numbers {numbers}", file=sys.stderr)
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    print(f"card {result['card']}", file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
