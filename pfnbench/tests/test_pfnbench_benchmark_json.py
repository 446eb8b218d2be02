"""``BENCHMARK.json`` against the benchmark's contract: keys, names,
lengths, files, and what every cell reports."""

import re

from pfnbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_lengths():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["pfnbench"] and 1 <= b["run_seconds"] <= 51
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert _line(c["source"]) and _line(c["why"]) and c["file"].startswith("pfnbench/")
        assert spec.config(c["name"])["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == spec.workload(w["name"])["chips"] == 1 and _line(w["why"])
        assert w["config"] == spec.workload(w["name"])["config"]
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"} and _line(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_every_cell_reports_set_up_another_end_to_end_and_a_per_layer_metric():
    b = spec.benchmark()
    used = set()
    for w in b["workloads"]:
        e2e, per_layer = spec.cell_metrics(b, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per_layer
        traffic = spec.traffic(spec.workload(w["name"])["kind"])
        assert names <= set(traffic.END_TO_END)
        assert all(m["moves"] in names for m in per_layer)
        used.add(w["config"])
    assert used == {c["name"] for c in b["configs"]}
