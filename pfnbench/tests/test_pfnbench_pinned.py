"""The ``pfn`` model kind's readings at the cells' own sizes, reached
through the config's model kind, pinned: the leaves the weights are drawn
into (names, shapes, order), the operations an update or a scoring pass
requires (``mfu.*``) and the attention passes (``attn_roofline.*``). A
change to the model kind's files that moves one of them moves what the
benchmark reads. The shared harness files name no part of the model."""

import hashlib
import json
import math
import re

import pytest

from pfnbench import program, spec

# The shared files of the harness: what they hold serves every model kind.
SHARED = ["program.py", "weights.py", "flops.py", "run.py", "check.py", "calibrate.py", "traffic/train.py",
          "traffic/score.py", "reference/train.py", "reference/score.py"]
MODEL_NAMES = re.compile(r"transformer_encoder\.layers|decoder\.0\.|decoder\.2\.|nlayers|emsize // |reference\.model\b"
                         r"|from pfnbench\.reference import model\b")


def _net(config):
    cfg = spec.config(config)
    return cfg, spec.program_model(spec.model_kind(cfg))


@pytest.mark.parametrize("config,leaves,parameters,digest", [
    ("gp_fig3a", 80, 23_394_064, "d6806e3f2bee1358899b9bff61f2019744291960063438c9f8de726733d92455"),
    ("bnn_ref", 68, 2_769_153, "cb676598140b1a7244b64d6b0f50ad4f1efa8f180eb18d7f2a0a3eac599cc736"),
])
def test_the_leaves_the_weights_are_drawn_into(config, leaves, parameters, digest):
    cfg, net = _net(config)
    shapes = net.parameter_shapes(cfg["model"], cfg["prior"]["num_features"], program.n_out(cfg))
    assert len(shapes) == leaves and sum(math.prod(s) for s in shapes.values()) == parameters
    ordered = json.dumps([[name, list(shape)] for name, shape in shapes.items()])
    assert hashlib.sha256(ordered.encode()).hexdigest() == digest


def test_required_operations_at_the_cells_sizes():
    cfg, net = _net("gp_fig3a")
    assert program.n_out(cfg) == 10_000 and cfg["prior"]["num_features"] == 1
    assert net.train_flops(cfg["model"], 1, 10_000, 100, 2010, [1000]) == 29112772608000.0
    positions = spec.workload("fig3a_score_b32")["positions"]
    assert len(positions) == 14
    assert net.score_flops(cfg["model"], 1, 10_000, 32, positions) == 10502893600768.0
    cfg, net = _net("bnn_ref")
    assert program.n_out(cfg) == 1 and cfg["prior"]["num_features"] == 3
    assert net.train_flops(cfg["model"], 3, 1, 256, 300, [150]) == 1416285388800.0


@pytest.mark.parametrize("config,batch,T", [("gp_fig3a", 100, 2010), ("bnn_ref", 256, 300)])
def test_the_attention_passes_of_an_update(config, batch, T):
    cfg, net = _net(config)
    m, seps = cfg["model"], [1000 % T, 7, 7]
    H = m["nhead"]
    want = [{"BH": batch * H, "T": T, "D": m["emsize"] // H, "sep": s, "dtype": m["dtype"], "backward": backward,
             "count": m["nlayers"]} for s in seps for backward in (False, True)]
    assert net.attention_calls(m, batch, T, seps, "train") == want


def test_the_attention_passes_of_a_scoring_pass():
    cfg, net = _net("gp_fig3a")
    m, calls = cfg["model"], 3
    wl = spec.workload("fig3a_score_b32")
    B, positions, H = wl["datasets"], wl["positions"], m["nhead"]
    want = [{"BH": B * H, "T": p + 1, "D": m["emsize"] // H, "sep": p, "dtype": m["dtype"], "backward": False,
             "count": m["nlayers"] * calls} for p in positions]
    got = [dict(c, count=c["count"] * calls) for c in net.attention_calls(m, B, 2010, positions, "score")]
    assert got == want


@pytest.mark.parametrize("path", SHARED)
def test_the_shared_files_name_no_part_of_the_model(path):
    text = (spec.ROOT / path).read_text()
    assert not MODEL_NAMES.search(text), MODEL_NAMES.search(text)
