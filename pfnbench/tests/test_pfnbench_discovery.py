"""A new configuration, cell or per-layer metric is found by its name as a
new file, with no edit to any file already there."""

import json
import shutil

import pytest

from pfnbench import run, spec
from pfnbench.tests.conftest import tiny


def test_new_files_are_found_by_name(tmp_path):
    for sub in ("configs", "workloads", "metrics"):
        (tmp_path / sub).mkdir()
    cfg = tiny("bnn_ref")
    cfg["name"] = "bnn_wide"
    cfg["model"]["emsize"] = 48
    (tmp_path / "configs" / "bnn_wide.json").write_text(json.dumps(cfg))
    wl = dict(spec.workload("bnn_ref_b256"), config="bnn_wide", batch_size=16)
    (tmp_path / "workloads" / "bnn_wide_b16.json").write_text(json.dumps(wl))
    (tmp_path / "metrics" / "updates_per_window.py").write_text(
        "def read(t):\n    return float(len(t['enqueue_s']))\n")

    bench = spec.benchmark()
    bench["workloads"].append({"name": "bnn_wide_b16", "config": "bnn_wide", "traffic": "bnn_wide_b16", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_datasets_per_s":
            m["workloads"].append("bnn_wide_b16")
    bench["per_layer"].append({"name": "updates_per_window.train", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "train loop", "moves": "train_datasets_per_s"})
    e2e, per_layer = spec.cell_metrics(bench, "bnn_wide_b16")
    assert {m["name"] for m in e2e} == {"train_datasets_per_s", "setup_s"}
    assert "updates_per_window.train" in {m["name"] for m in per_layer}

    found = spec.workload("bnn_wide_b16", root=tmp_path)
    reader = spec.metric_reader("updates_per_window.train", root=tmp_path)
    assert reader.read({"enqueue_s": [0.1, 0.2]}) == 2.0
    result = run.run("bnn_wide_b16", 7, 0.2, False, "cpu", bench, found, spec.config(found["config"], root=tmp_path))
    assert result["correct"], result["checks"]
    assert result["metrics"]["train_datasets_per_s"]["value"] > 0


def test_a_metric_file_of_its_own_comes_before_its_stem(tmp_path):
    (tmp_path / "metrics").mkdir()
    shutil.copy(spec.ROOT / "metrics" / "mfu.py", tmp_path / "metrics" / "mfu.py")
    (tmp_path / "metrics" / "mfu.serve.py").write_text("def read(t):\n    return 1.5\n")
    assert spec.metric_reader("mfu.serve", root=tmp_path).read({}) == 1.5
    assert spec.metric_reader("mfu.train", root=tmp_path).read({}) is None


@pytest.mark.parametrize("name", ["../x", "a b", "", "a/b"])
def test_names_are_checked(name):
    with pytest.raises(ValueError):
        spec.workload(name)
