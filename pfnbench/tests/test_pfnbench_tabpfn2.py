"""The ``tabpfn2`` model kind: its counts pinned at the cell's sizes, a tiny
train cell of it ``correct`` on the CPU, the program with half of each
microbatch left out or with its state left unchanged, and a reference
without its multi-query test rows, failing the check; the ``bnn_classes``
prior at 2 classes equal to ``bnn``, and the cell's labels over the head's
10 classes; a config whose group size or codes' seed is not the port's
refused; the new files loading no JAX, and
(``card``) the flash kernels' two item-attention calls at head dim 32 in
bf16 against the port's dense path, and the control at the cell's size."""

import copy
import json
import math
import subprocess
import sys

import pytest
import torch

from pfnbench import run, spec
from pfnbench.tests.conftest import ROOT

CELL = "tabpfn2_b6_t1024_f100"
NET = spec.program_model("tabpfn2")
MODEL = spec.config("tabpfn2_clf")["model"]
SEED = 2**31 + 77


def tiny_cell():
    """(workload, config) of the cell at a CPU test's size: emsize 24, 3
    heads of 8, 2 layers, 5 features (3 groups, one padded), T 20, B 3."""
    wl = dict(spec.workload(CELL), batch_size=3)
    cfg = copy.deepcopy(spec.config("tabpfn2_clf"))
    cfg["model"].update(emsize=24, nhid=48, nlayers=2, nhead=3, num_features=5, dtype="float32")
    cfg["prior"]["num_features"] = 5
    cfg["train"]["bptt"] = 20
    return wl, cfg


def test_parameter_shapes_at_the_published_widths():
    shapes = NET.parameter_shapes(MODEL, 100, 10)
    assert len(shapes) == 5 + 12 * 8 + 4
    # 12 layers of 2 x 4 x 192^2 + 2 x 192 x 768 + 768 + 192, the embeddings, the decoder.
    layer = 8 * 192**2 + 2 * 192 * 768 + 768 + 192
    want = 12 * layer + (192 * 2 + 192 * 48 + 192 + 192 * 2 + 192) + (768 * 192 + 768 + 10 * 768 + 10)
    assert sum(math.prod(s) for s in shapes.values()) == want == 7_255_690


def test_train_flops_at_the_cells_size():
    # B 6, T 1024, sep 512: 51 tokens a row.
    tokens, D = 6 * 1024 * 51, 192
    products = 2.0 * tokens * 12 * (8 * D * D + 2 * D * 768)
    embed = 2.0 * 6 * 1024 * (50 * 2 * D + 2 * D) + 2.0 * 50 * 48 * D
    features = 2.0 * 2 * 12 * D * 6 * 1024 * 51 * 51
    items = 2.0 * 2 * 12 * D * 6 * 51 * 512 * 1024
    decoder = 2.0 * 6 * 512 * (D * 768 + 768 * 10)
    want = 3 * (products + embed + features + items + decoder)
    assert NET.train_flops(MODEL, 100, 10, 6, 1024, [512]) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(1.8e13, rel=0.02)  # the issue's estimate of an update


def test_attention_calls_and_their_bound():
    calls = NET.attention_calls(MODEL, 6, 1024, [512, 0], "train")
    assert [(c["BH"], c["Tq"], c["keys"], c["backward"]) for c in calls] == [
        (6 * 51 * 6, 512, 512, False), (6 * 51, 6 * 512, 512, False),
        (6 * 51 * 6, 512, 512, True), (6 * 51, 6 * 512, 512, True),
        (6 * 51, 6 * 1024, 0, False), (6 * 51, 6 * 1024, 0, True)]
    assert all(c["D"] == 32 and c["count"] == 12 and c["dtype"] == "bfloat16" for c in calls)
    one = calls[0]
    ops = 2.0 * 2 * 32 * one["BH"] * 512 * 512
    nbytes = 2 * one["BH"] * 512 * 32 * 2 * 2 + one["BH"] * 512 * 4
    assert NET.attention_bound_s(one) == max(ops / 989e12, nbytes / 3.35e12)
    # Each call's pairs add up to the counting rule's item pairs: sep * T a column and head.
    pairs = sum(c["BH"] * c["Tq"] * c["keys"] for c in calls[:2])
    assert pairs == 6 * 51 * 6 * 512 * 1024
    assert NET.attention_calls(MODEL, 2, 8, [3], "score") == [
        dict(c, count=12) for c in NET._item_calls(MODEL, 2, 51, 4, 3, False)]


def test_a_tiny_train_cell_is_correct():
    wl, cfg = tiny_cell()
    result = run.run(CELL, SEED, 0.2, False, "cpu", workload_spec=wl, config=cfg)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("key, value", [("features_per_group", 3), ("embed_seed", 7)])
def test_a_config_other_than_the_ports_constants_is_refused(key, value):
    """The reference reads the group size and the codes' seed from the
    config, the port holds the published ones: a config stating others is
    refused when the program is built."""
    from pfnbench import weights

    wl, cfg = tiny_cell()
    cfg["model"][key] = value
    shapes = NET.parameter_shapes(cfg["model"], 5, 10)
    with pytest.raises(ValueError, match=key):
        NET.build(cfg, "cpu", weights.make(shapes, 1, "cpu"), None, batch_size=3, aggregate_k_gradients=1)


def test_half_the_batch_left_out_fails(monkeypatch):
    """The program taking the loss over the first half of each microbatch's
    datasets alone is not correct."""
    from pfn_tpu_torch.train import loop

    whole = loop._loss_terms

    def half(criterion, out, target_y, sep, mesh):
        n = out.shape[0] // 2
        return whole(criterion, out[:n], target_y[:n], sep, mesh)

    monkeypatch.setattr(loop, "_loss_terms", half)
    wl, cfg = tiny_cell()
    result = run.run(CELL, SEED, 0.2, False, "cpu", workload_spec=dict(wl, batch_size=4), config=cfg)
    assert not result["correct"], result["checks"]


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    from pfn_tpu_torch.train import loop

    monkeypatch.setattr(loop, "_clip_and_step", lambda state, schedule: torch.tensor(1.0))
    wl, cfg = tiny_cell()
    result = run.run(CELL, SEED, 0.2, False, "cpu", workload_spec=wl, config=cfg)
    assert not result["correct"], result["checks"]


def test_the_prior_of_two_classes_is_the_bnn_prior():
    """``bnn_classes`` at 2 classes draws what ``bnn`` draws, on both sides."""
    from pfnbench.reference import part

    cfg = {"num_features": 4, "embed": 3, "num_classes": 2}
    two = part("prior", "bnn_classes").draw(torch.Generator().manual_seed(8), 32, 40, cfg)
    bnn = part("prior", "bnn").draw(torch.Generator().manual_seed(8), 32, 40, cfg)
    assert torch.equal(two["x"], bnn["x"]) and torch.equal(two["y"], bnn["y"])
    torch.testing.assert_close(two["margin"], bnn["margin"], rtol=0, atol=1e-12)
    sides = [spec.program_prior(k).program(cfg).sample(32, 40, generator=torch.Generator().manual_seed(8))
             for k in ("bnn_classes", "bnn")]
    assert all(torch.equal(a, b) for a, b in zip(*sides))


def test_the_cells_labels_span_the_heads_classes():
    """The cell's prior draws labels over all 10 classes of the head."""
    prior = spec.config("tabpfn2_clf")["prior"]
    from pfnbench.reference import part

    y = part("prior", prior["kind"]).draw(torch.Generator().manual_seed(9), 6, 1024, prior)["y"]
    assert set(y.unique().long().tolist()) == set(range(10))


def test_a_reference_without_multi_query_fails(tmp_path):
    """The program paired with a reference whose test rows use their own
    head's keys and values fails the check."""
    (tmp_path / "reference").mkdir()
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "tabpfn2.py").write_text((spec.ROOT / "models" / "tabpfn2.py").read_text())
    source = (spec.ROOT / "reference" / "model_tabpfn2.py").read_text()
    shared = "kt[:, :, :1].expand(shared), vt[:, :, :1].expand(shared)"
    assert shared in source
    (tmp_path / "reference" / "model_tabpfn2.py").write_text(source.replace(shared, "kt, vt"))
    wl, cfg = tiny_cell()
    result = run.run(CELL, SEED, 0.2, False, "cpu", workload_spec=wl, config=cfg, root=tmp_path)
    assert not result["correct"], result["checks"]


def test_the_new_files_load_no_jax_and_the_reference_none_of_the_port():
    code = ("import sys\nfrom pfnbench import spec\nfrom pfnbench.reference import part\n"
            "part('model', 'tabpfn2'); part('criterion', 'ce'); part('prior', 'bnn_classes')\n"
            "ref = sorted({n.split('.')[0] for n in sys.modules})\n"
            "spec.program_model('tabpfn2'); spec.program_criterion('ce'); spec.program_prior('bnn_classes')\n"
            "import pfn_tpu_torch.train.loop\n"
            "[spec.metric_reader(n) for n in ('attn_features_pct.train', 'attn_items_pct.train',"
            " 'attn_items_roofline.train')]\n"
            "print(json.dumps([ref, sorted({n.split('.')[0] for n in sys.modules})]))")
    out = subprocess.run([sys.executable, "-c", "import json\n" + code], cwd=ROOT, capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    ref, program = json.loads(out.stdout)
    assert "pfn_tpu_torch" not in ref and not set(ref) & set(run.FORBIDDEN)
    assert "pfn_tpu_torch" in program and not set(program) & set(run.FORBIDDEN)


def explicit_item_attention(q, k, v, sep):
    """Head by head, through the port's dense prefix path: each head's train
    rows against its own keys, its test rows against head 0's."""
    from pfn_tpu_torch.ops.attention import pfn_prefix_attention_reference

    out = []
    for h in range(q.shape[1]):
        train = pfn_prefix_attention_reference(q[:, h:h + 1, :sep], k[:, h:h + 1], v[:, h:h + 1], sep)[0]
        test = pfn_prefix_attention_reference(q[:, h:h + 1, sep:], k[:, :1], v[:, :1], sep)[0]
        out.append(torch.cat([train, test], dim=2))
    return torch.cat(out, dim=1)


def _errors(got: dict, gold: dict) -> dict:
    """Each tensor's largest error over the gold's largest magnitude, or
    over 1e-3 of the largest gold tensor's where that is larger: dq and dk
    vanish exactly at sep 1 (one key), where both sides leave rounding."""
    floor = 1e-3 * max(float(g.abs().max()) for g in gold.values())
    return {n: float((got[n].float() - g).abs().max()) / max(float(g.abs().max()), floor, 1e-30)
            for n, g in gold.items()}


@pytest.mark.card
@pytest.mark.parametrize("sep", [0, 1, 511, 1023])
def test_the_item_attention_kernels_at_head_dim_32(sep, card):
    """Both flash calls of a layer's item attention (the train rows; the
    test rows folded against head 0), bf16, forward and backward, at T 1024
    and 24 token columns of 6 heads of 32. Each output's and gradient's
    error against the float32 result for the same bf16 inputs is held to 3x
    the port's dense bf16 path's own error, or 2e-2 (the flash kernels' bf16
    gradient floor), whichever is larger."""
    from pfn_tpu_torch.models.per_feature import item_attention

    g = torch.Generator(device=card).manual_seed(sep)
    q, k, v, do = (torch.randn(24, 6, 1024, 32, generator=g, device=card).to(torch.bfloat16) for _ in range(4))

    def run_(fn, inputs):
        inputs = [t.detach().requires_grad_(True) for t in inputs]
        o = fn(*inputs, sep)
        grads = torch.autograd.grad(o, inputs, do.to(o.dtype))
        return dict(zip(("o", "dq", "dk", "dv"), (o.detach(), *grads)))

    kernel = run_(item_attention, (q, k, v))
    gold = run_(explicit_item_attention, (q.float(), k.float(), v.float()))
    dense = run_(explicit_item_attention, (q, k, v))
    errs, dense_errs = _errors(kernel, gold), _errors(dense, gold)
    for n in gold:
        assert errs[n] <= max(2e-2, 3 * dense_errs[n]), (n, errs, dense_errs)
    if sep == 0:
        assert not kernel["o"].any() and not kernel["dk"].any() and not kernel["dv"].any()


@pytest.mark.card
def test_the_control_at_the_cells_size(card):
    """The reference one precision below the configuration's (fp8 layers,
    TF32 embeddings, decoder and prior) in the program's place is not
    correct at the cell's size, on three seeds."""
    from pfnbench import calibrate, check

    wl = spec.workload(CELL)
    cfg = spec.config(wl["config"])
    for seed in (SEED, SEED + 1, SEED + 2):
        upper = calibrate.train_upper(cfg, wl, seed, card)
        assert not check.judge(upper["control"], wl["limits"])[0], upper["control"]
