"""The plain reference against the port's dense float32 path, on the CPU at
a tiny size (this test imports both; the reference imports nothing of the
port)."""

import dataclasses

import pytest
import torch

from pfnbench import borders, program, run, spec, weights
from pfnbench.reference import part
from pfnbench.reference import train as ref_train
from pfnbench.tests.conftest import tiny


def _port_model(cfg, params, bucket_borders):
    cfg = dict(cfg, model=dict(cfg["model"], dtype="float32"))
    return spec.program_model("pfn").build(cfg, "cpu", params, bucket_borders, batch_size=2)


@pytest.mark.parametrize("config", ["gp_fig3a", "bnn_ref"])
def test_forward_matches_the_port(config):
    cfg = tiny(config)
    bucket_borders = borders.make(cfg["criterion"], cfg["prior"], "cpu")
    shapes = spec.program_model("pfn").parameter_shapes(cfg["model"], cfg["prior"]["num_features"], program.n_out(cfg))
    params = weights.make(shapes, 3, "cpu")
    prior, criterion, _, model = _port_model(cfg, params, bucket_borders)
    g = torch.Generator().manual_seed(0)
    x, y, target = prior.sample(3, cfg["train"]["bptt"], generator=g)
    for sep in (0, 1, 7, cfg["train"]["bptt"] - 1):
        port = model(x, y, torch.tensor([sep], dtype=torch.int32))
        ref = part("model", "pfn").forward(params, cfg["model"], x, y, sep)
        torch.testing.assert_close(ref, port, rtol=1e-5, atol=1e-5)
        nll = part("criterion", cfg["criterion"]["kind"]).nll(ref, target, bucket_borders)
        torch.testing.assert_close(nll, criterion.per_position(ref, target), rtol=1e-6, atol=1e-6)


def test_bar_nll_at_and_beyond_the_borders():
    from pfn_tpu_torch.train import full_support_bar_criterion

    b = torch.tensor([-2.0, -1.0, -0.2, 0.5, 1.5, 3.0])
    y = torch.tensor([-5.0, -2.0, -1.5, -1.0, 0.0, 0.5, 1.5, 2.9, 3.0, 7.0])
    logits = torch.randn(y.numel(), 5, generator=torch.Generator().manual_seed(1))
    want = full_support_bar_criterion(b).per_position(logits, y)
    torch.testing.assert_close(part("criterion", "full_bar").nll(logits, y, b), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("config,batch", [("gp_fig3a", 5), ("bnn_ref", 32)])
def test_replayed_batches_and_seps_match_the_sampler(config, batch):
    from pfn_tpu_torch.train.loop import _eval_pos_weights, _sample_eval_pos

    cfg = tiny(config)
    net = spec.program_model("pfn")
    prior = net.build(cfg, "cpu", weights.make(net.parameter_shapes(
        cfg["model"], cfg["prior"]["num_features"], program.n_out(cfg)), 1, "cpu"),
        borders.make(cfg["criterion"], cfg["prior"], "cpu"), batch_size=batch)[0]
    t = cfg["train"]
    tcfg = dataclasses.make_dataclass("C", ["eval_pos_sampler", "eval_pos_max", "bptt", "fixed_eval_pos"])(
        t["eval_pos_sampler"], t.get("eval_pos_max"), t["bptt"], None)
    g = torch.Generator().manual_seed(11)
    port = []
    for _ in range(2):
        x, _, y = prior.sample(batch, t["bptt"], generator=g)
        port.append((x, y, int(_sample_eval_pos(g, tcfg, _eval_pos_weights(tcfg, "cpu")))))
    ref = ref_train.replay(torch.Generator().manual_seed(11), t, cfg["prior"], batch, 2, 1)[0]
    for (x, y, sep), r in zip(port, ref):
        torch.testing.assert_close(x.double(), r["x"], rtol=0, atol=1e-5)
        if "margin" in r:  # labels: equal, but where u lies within 1e-5 of p
            assert not bool(((y.double() != r["y"]) & (r["margin"] > 1e-5)).any())
        else:
            torch.testing.assert_close(y.double(), r["y"], rtol=0, atol=1e-5)
        assert sep == r["sep"]


def test_three_f32_updates_match_the_reference(tiny_cell):
    """The bnn cell (f32) run on the CPU: the port's updates against the
    reference's, far inside the cell's limits."""
    wl, cfg = tiny_cell("bnn_ref_b256")
    result = run.run("bnn_ref_b256", 2**31 + 5, 0.2, False, "cpu", workload_spec=wl, config=cfg)
    numbers = {name: value for name, value, _ in result["checks"]}
    assert result["correct"]
    assert numbers["sep_gap"] == 0
    assert max(numbers["loss_gap"], numbers["grad_gap"], numbers["change_gap"]) < 1e-4
