"""Where the harness finds its parts, by the names in ``BENCHMARK.json``.

A cell is ``workloads/<cell>.json``, its configuration
``configs/<config>.json``, its traffic ``traffic/<kind>.py``, the program's
prior ``priors/<kind>.py`` and criterion ``criteria/<kind>.py``, its model
``models/<kind>.py`` (the program side) and ``reference/model_<kind>.py``
(the reference side) for the configuration's ``model.kind`` (absent:
``pfn``), and a per-layer metric ``metrics/<name>.py``, or
``metrics/<stem>.py`` for the part of its name before the first dot
(``mfu.train`` and ``mfu.score`` share ``metrics/mfu.py``). Adding a cell, a
configuration, a model kind or a metric adds files and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Path = BENCHMARK) -> dict:
    return load_json(path)


def workload(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "workloads" / f"{_checked(name)}.json")


def config(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "configs" / f"{_checked(name)}.json")


def traffic(kind: str):
    return importlib.import_module(f"pfnbench.traffic.{_checked(kind)}")


def program_prior(kind: str):
    return importlib.import_module(f"pfnbench.priors.{_checked(kind)}")


def program_criterion(kind: str):
    return importlib.import_module(f"pfnbench.criteria.{_checked(kind)}")


def load(sub: str, name: str, root: Path = ROOT):
    """The module of file ``<root>/<sub>/<name>.py``, executed afresh from
    its file, so that a test can add one under another ``root``."""
    path = root / sub / f"{_checked(name)}.py"
    spec = importlib.util.spec_from_file_location(f"pfnbench.{sub}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def model_kind(cfg: dict) -> str:
    """The model kind of configuration ``cfg``: ``model.kind``, absent ``pfn``."""
    return cfg["model"].get("kind", "pfn")


def program_model(kind: str, root: Path = ROOT):
    """The program side of model ``kind``: ``models/<kind>.py``."""
    return load("models", kind, root)


def metric_reader(name: str, root: Path = ROOT):
    """The module of metric ``name``: its own file, else its stem's."""
    _checked(name)
    stem = name if (root / "metrics" / f"{name}.py").exists() else name.split(".")[0]
    return load("metrics", stem, root)


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports: an
    end-to-end metric where its ``workloads`` names the cell or it has none;
    a per-layer metric where its ``workloads`` names the cell or, without
    that key, where it moves one of the cell's end-to-end metrics."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer
