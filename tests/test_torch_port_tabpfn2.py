"""TabPFN v2's per-feature model (``models/per_feature.py``) against the
benchmark's plain reference (``pfnbench/reference/model_tabpfn2.py``,
written from the equations and importing nothing of the port), on the CPU
at emsize 24, 3 heads of 8, 2 layers, 5 features (3 groups, the last padded)
and T 20, on seeded random weights: the logits, the cross-entropy loss
over the test rows and the gradient of every leaf at seps 0, 1, 7, 19, 20;
a rounding of any one part's products to bf16 fails a tolerance. Also
``rows=``, the folded multi-query call against a head-by-head loop, the
spans, the loop's host copy of sep read by the forward, ``train()``
through the normal path, the configurations the model refuses, and the default ``TrainConfig``
building the PFN as before.
"""

import dataclasses
import math

import pytest
import torch

from pfn_tpu_torch.models import per_feature
from pfn_tpu_torch.models.per_feature import PerFeatureTransformer, item_attention
from pfn_tpu_torch.models.transformer import PFNTransformer, TransformerConfig
from pfn_tpu_torch.train import TrainConfig, build_model, ce_criterion, train
from pfn_tpu_torch.utils.profiling import clear, recorded, recording
from pfnbench import weights
from pfnbench.models import tabpfn2
from pfnbench.reference import part

MODEL = {"kind": "tabpfn2", "emsize": 24, "nhid": 48, "nlayers": 2, "nhead": 3, "features_per_group": 2,
         "embed_seed": 42, "num_features": 5, "dtype": "float32"}
B, T, NF, N_OUT = 3, 20, 5, 10
SEPS = [0, 1, 7, 19, 20]
# Both sides compute in float32 on the CPU, in other orders of summation
# (the z-score, the softmax sums, LayerNorm), through two layers. Measured:
# logits within 1.1e-6, the loss within 1e-7 relative, the gradients within
# 7e-7 of a leaf's largest entry, but 4.5e-5 for encoder.x_proj at sep 1,
# whose one train row has sigma 0, so the test rows' inputs sit at the
# +-100 clip. Rounding any one part's products to bf16 moves the logits by
# 8e-3 to 1.3e-2, the loss by 1e-4 to 5e-4 and a gradient by 4e-3 or more.
LOGIT_TOL = dict(rtol=1e-4, atol=2e-5)
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4  # of each leaf's largest reference entry


@pytest.fixture(autouse=True)
def _one_thread_and_an_empty_buffer():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    clear()
    yield
    clear()
    torch.set_num_threads(threads)


class _Prior:
    """Tables of NF standard-normal features with 0/1 labels."""

    num_features, num_outputs = NF, 1

    def sample(self, batch_size, seq_len, generator=None, device=None):
        x = torch.randn(batch_size, seq_len, NF, generator=generator, device=device)
        y = (torch.rand(batch_size, seq_len, generator=generator, device=device) < 0.5).float()
        return x, y, y


def _config(**kw) -> TrainConfig:
    return TrainConfig(emsize=24, nhid=48, nlayers=2, nhead=3, bptt=T, batch_size=B, lr=1e-3, device="cpu",
                       verbose=False, model_kind="tabpfn2", **kw)


def _setup(seed: int = 3):
    """(port model holding the weights drawn for the benchmark's shapes of
    its state_dict, the weights, x, y)."""
    params = weights.make(tabpfn2.parameter_shapes(MODEL, NF, N_OUT), seed, "cpu")
    model = build_model(_Prior(), ce_criterion(N_OUT), _config())
    model.load_state_dict(params, strict=True)
    g = torch.Generator().manual_seed(seed)
    x, y, _ = _Prior().sample(B, T, generator=g)
    return model, params, x, y


def _ref_side(params, x, y, sep, prec=None):
    """(logits, mean CE over rows >= sep, {leaf: gradient}) of the reference."""
    net, crit = part("model", "tabpfn2"), part("criterion", "ce")
    leaves = {n: p.clone().requires_grad_(True) for n, p in params.items()}
    logits = net.forward(leaves, MODEL, x, y, sep, net.F32 if prec is None else prec)
    if sep == T:
        return logits.detach(), None, None
    loss = crit.nll(logits[:, sep:], y[:, sep:]).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)  # sep 0: no item attention
    return logits.detach(), loss.detach(), {n: torch.zeros_like(leaves[n]) if g is None else g
                                            for n, g in zip(leaves, grads)}


def _port_side(model, x, y, sep):
    logits = model(x, y, torch.tensor([sep], dtype=torch.int32))
    if sep == T:
        return logits.detach(), None, None
    loss = ce_criterion(N_OUT).per_position(logits[:, sep:], y[:, sep:]).mean()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return logits.detach(), loss.detach(), dict(zip(names, grads))


def _mismatches(port, ref) -> list[str]:
    """The tolerances that ``port`` misses against ``ref``."""
    (pl, ploss, pg), (rl, rloss, rg) = port, ref
    out = []
    if not torch.allclose(pl, rl, **LOGIT_TOL):
        out.append("logits")
    if rloss is not None:
        if abs(float(ploss) - float(rloss)) > LOSS_RTOL * abs(float(rloss)):
            out.append("loss")
        for n, g in rg.items():
            if float((pg[n] - g).abs().max()) > GRAD_TOL * float(g.abs().max()):
                out.append(n)
    return out


@pytest.mark.parametrize("sep", SEPS)
def test_logits_loss_and_gradients_match_the_reference(sep):
    model, params, x, y = _setup()
    port, ref = _port_side(model, x, y, sep), _ref_side(params, x, y, sep)
    assert _mismatches(port, ref) == []
    assert set(port[2] or ()) == set(ref[2] or ())


@pytest.mark.parametrize("rounded", ["enc", "feat", "item", "mlp", "dec"])
def test_a_bf16_rounded_part_fails_a_tolerance(rounded):
    """The reference with one part's products rounded to bf16, in the port's
    place, misses at least one tolerance at sep 7."""
    _, params, x, y = _setup()
    prec = dict(part("model", "tabpfn2").F32, **{rounded: "bf16"})
    assert _mismatches(_ref_side(params, x, y, 7, prec), _ref_side(params, x, y, 7))


@pytest.mark.parametrize("sep", SEPS)
def test_rows_equal_the_full_decode(sep):
    model, _, x, y = _setup()
    with torch.no_grad():
        full = model(x, y, sep)
        for start, stop in [(sep, T), (0, T), (min(sep, T - 1), T), (0, 0)]:
            torch.testing.assert_close(model(x, y, torch.tensor([sep]), rows=(start, stop)), full[:, start:stop],
                                       rtol=0, atol=0)


def _per_head(q, k, v, sep):
    """The item attention head by head: each head's train rows against its
    own train rows, its test rows against head 0's train rows."""
    scale = q.shape[-1] ** -0.5
    out = []
    for h in range(q.shape[1]):
        rows = []
        for lo, hi, kh in ((0, sep, h), (sep, q.shape[2], 0)):
            s = q[:, h, lo:hi] @ k[:, kh, :sep].transpose(-1, -2) * scale
            rows.append(torch.softmax(s, dim=-1) @ v[:, kh, :sep])  # no key (sep 0): an empty sum, 0
        out.append(torch.cat(rows, dim=1))
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("sep", SEPS)
def test_the_folded_multi_query_call_equals_a_loop_over_heads(sep):
    g = torch.Generator().manual_seed(sep)
    q, k, v, do = (torch.randn(4, 3, T, 8, generator=g) for _ in range(4))
    sides = []
    for fn in (item_attention, _per_head):
        inputs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*inputs, sep)
        sides.append((o.detach(), *torch.autograd.grad(o, inputs, do)))
    # float32 both; at sep 1 dq and dk vanish exactly (one key), where the
    # kernel's plain backward forms p (dp - delta) and leaves ~1e-6.
    for a, b in zip(*sides):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_the_forward_reads_the_loops_copy_of_sep(monkeypatch):
    """Given ``rows`` that start with the loop's host copy of this sep
    tensor, the forward makes no copy of its own; given none, it makes one."""
    made = []

    class Counting(per_feature.HostSep):
        def __init__(self, sep):
            made.append(sep)
            super().__init__(sep)

    monkeypatch.setattr(per_feature, "HostSep", Counting)
    model, _, x, y = _setup()
    sep = torch.tensor([7])
    copy = Counting(sep)
    made.clear()
    with torch.no_grad():
        reused = model(x, y, sep, rows=(copy, T))
        assert made == []
        torch.testing.assert_close(model(x, y, sep, rows=(7, T)), reused, rtol=0, atol=0)
    assert len(made) == 1


def test_spans_of_the_two_attentions_and_the_decoder_counter():
    model, _, x, y = _setup()
    with recording():
        model(x, y, 7, rows=(7, T))
    names = [s.name for s in recorded()]
    assert names.count("model.attn_features") == names.count("model.attn_items") == MODEL["nlayers"]
    decoder = [s for s in recorded() if s.name == "model.decoder"]
    assert [s.rows for s in decoder] == [(B * (T - 7), B * T)]


def test_train_runs_the_model_through_the_normal_path():
    cfg = _config(epochs=2, steps_per_epoch=2, warmup_epochs=1)
    result = train(_Prior(), ce_criterion(N_OUT), cfg)
    assert isinstance(result.model, PerFeatureTransformer)
    assert all(math.isfinite(s["mean_loss"]) for s in result.epoch_stats)


@pytest.mark.parametrize("change", [dict(attention_impl="fused"), dict(dropout=0.1), dict(num_experts=2),
                                    dict(input_normalization=True), dict(model_kind="nope")])
def test_what_the_model_refuses(change):
    with pytest.raises(ValueError):
        build_model(_Prior(), ce_criterion(N_OUT), dataclasses.replace(_config(), **change))


def test_a_mesh_is_refused():
    with pytest.raises(ValueError, match="mesh"):
        build_model(_Prior(), ce_criterion(N_OUT), _config(), mesh=object())


def test_the_default_config_builds_the_pfn_as_before():
    """``TrainConfig()`` without ``model_kind`` builds the PFN that
    ``build_model`` built before the field existed: the same weights from
    the seed and the same outputs."""
    kw = dict(emsize=24, nhid=48, nlayers=2, nhead=3, bptt=T, device="cpu", seed=5)
    default = build_model(_Prior(), ce_criterion(N_OUT), TrainConfig(**kw))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        before = PFNTransformer(TransformerConfig(num_features=NF, n_out=N_OUT, emsize=24, nhead=3, nhid=48,
                                                  nlayers=2, max_len=2 * T))
    assert isinstance(default, PFNTransformer) and TrainConfig().model_kind == "pfn"
    assert default.state_dict().keys() == before.state_dict().keys()
    for n, t in before.state_dict().items():
        assert torch.equal(default.state_dict()[n], t), n
    x, y, _ = _Prior().sample(B, T, generator=torch.Generator().manual_seed(0))
    assert torch.equal(default(x, y, 7), before(x, y, 7))
