"""A new configuration, cell, model kind or per-layer metric is found by its
name as a new file, with no edit to any file already there."""

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


# The ``pfn`` kind with the exact (erf) GELU, as new files: the program side
# turns on the port's ``exact_gelu``; the reference side is a fresh copy of
# the ``pfn`` reference whose GELU is written from erf.
ERF_PROGRAM = """from pfnbench.models import pfn
from pfnbench.models.pfn import attention_calls, parameter_shapes, score_flops, train_flops  # noqa: F401


def build(cfg, device, weights, borders, **train):
    return pfn.build(cfg, device, weights, borders, exact_gelu=True, **train)
"""
ERF_REFERENCE = """import math

import torch

from pfnbench import spec

_pfn = spec.load("reference", "model_pfn")
_pfn.gelu_tanh = lambda x: 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
forward, block_rows, F32, control = _pfn.forward, _pfn.block_rows, _pfn.F32, _pfn.control
"""
# The tanh reference under the erf kind's name: a program and a reference
# that disagree.
TANH_REFERENCE = "from pfnbench.reference.model_pfn import F32, block_rows, control, forward  # noqa: F401\n"


def _erf_kind(root, reference):
    """The ``pfn_erf`` kind, a float32 Fig-3a config of it, a train cell
    (with the float32 cell's limits) and a score cell, under ``root``."""
    for sub in ("models", "reference", "configs", "workloads"):
        (root / sub).mkdir(parents=True)
    (root / "models" / "pfn_erf.py").write_text(ERF_PROGRAM)
    (root / "reference" / "model_pfn_erf.py").write_text(reference)
    cfg = tiny("gp_fig3a")
    cfg["name"] = "gp_erf"
    cfg["model"].update(kind="pfn_erf", dtype="float32")
    (root / "configs" / "gp_erf.json").write_text(json.dumps(cfg))
    train = dict(spec.workload("fig3a_b100x1"), config="gp_erf", batch_size=4,
                 limits=spec.workload("bnn_ref_b256")["limits"])
    (root / "workloads" / "gp_erf_b4.json").write_text(json.dumps(train))
    score = dict(spec.workload("fig3a_score_b32"), config="gp_erf", datasets=3, pool_chunks=2, positions=[1, 5, 20, 39])
    (root / "workloads" / "gp_erf_score_b3.json").write_text(json.dumps(score))


def _run_erf(cell, root):
    wl = spec.workload(cell, root=root)
    return run.run(cell, 2**31 + 77, 0.2, False, "cpu", workload_spec=wl, config=spec.config(wl["config"], root=root),
                   root=root)


@pytest.mark.parametrize("cell", ["gp_erf_b4", "gp_erf_score_b3"])
def test_a_model_kind_added_as_new_files(cell, tmp_path):
    _erf_kind(tmp_path, ERF_REFERENCE)
    assert spec.model_kind(spec.config("gp_erf", root=tmp_path)) == "pfn_erf"
    result = _run_erf(cell, tmp_path)
    assert result["correct"], result["checks"]


def test_the_kind_reaches_both_sides(tmp_path):
    """The erf program against the tanh reference fails the check: each
    side is the one the kind's files give."""
    _erf_kind(tmp_path, TANH_REFERENCE)
    result = _run_erf("gp_erf_b4", tmp_path)
    assert not result["correct"], result["checks"]


def test_an_absent_model_kind_is_pfn():
    for c in spec.benchmark()["configs"]:
        cfg = spec.config(c["name"])
        assert "kind" not in cfg["model"] and spec.model_kind(cfg) == "pfn"


@pytest.mark.parametrize("name", ["../x", "a b", "", "a/b"])
def test_names_are_checked(name):
    with pytest.raises(ValueError):
        spec.workload(name)
    with pytest.raises(ValueError):
        spec.program_model(name)
