"""Decoding only the rows that are read (``PFNTransformer.forward(...,
rows=)``), on the CPU: a row range equals the same rows of the whole output
for each decoder head at f32 and bf16; one update of ``make_train_step``
(and of the host-fed step), which decodes the eval rows sep .. T-1 alone,
equals the update with every row decoded and the loss masked, computed here,
for each criterion; the harness's three functions equal their values from
the whole output; the mesh and fused paths still decode every row; the
``model.decoder`` span's counter of rows decoded over rows produced.
"""

import operator

import pytest
import torch

from pfn_tpu_torch.evals.harness import (
    eval_positional_logits_per_dataset,
    eval_positional_loss_per_dataset,
    mean_mse,
)
from pfn_tpu_torch.models.decoders import FixedScaledDecoder, MLPDecoder, ScaledDecoder
from pfn_tpu_torch.models.transformer import PFNTransformer, TransformerConfig
from pfn_tpu_torch.parallel.mesh import Mesh
from pfn_tpu_torch.train import TrainConfig, TrainState, build_model
from pfn_tpu_torch.train.loop import (
    _eval_pos_weights,
    _HostSep,
    _loss_parts,
    _make_optimizer,
    _sample_eval_pos,
    make_train_step,
    make_train_step_from_batch,
)
from pfn_tpu_torch.train.losses import (
    bar_criterion,
    bce_criterion,
    ce_criterion,
    full_support_bar_criterion,
    gaussian_nll_criterion,
)
from pfn_tpu_torch.utils.profiling import clear, recorded, recording

T, B, NF = 16, 3, 2
BORDERS = torch.linspace(-3.0, 3.0, 21)
CRITERIA = {"full_bar": lambda: full_support_bar_criterion(BORDERS), "bar": lambda: bar_criterion(BORDERS),
            "bce": bce_criterion, "gaussian": gaussian_nll_criterion, "ce": lambda: ce_criterion(3)}


@pytest.fixture(autouse=True)
def _one_thread_and_an_empty_buffer():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    clear()
    yield
    clear()
    torch.set_num_threads(threads)


class _Prior:
    """Datasets whose targets suit the criterion ``kind``: 0/1 for BCE,
    classes 0-2 with some -100 (ignored) for CE, normal draws otherwise."""

    num_features, num_outputs = NF, 1

    def __init__(self, kind: str):
        self.kind = kind

    def sample(self, batch, seq_len, generator=None, device=None):
        x = torch.randn(batch, seq_len, NF, generator=generator, device=device)
        y = torch.randn(batch, seq_len, generator=generator, device=device)
        if self.kind == "bce":
            y = (y > 0).float()
        elif self.kind == "ce":
            labels = torch.randint(0, 3, (batch, seq_len), generator=generator, device=device).float()
            ignored = torch.rand(batch, seq_len, generator=generator, device=device) < 0.25
            y = torch.where(ignored, torch.full_like(labels, -100.0), labels)
        return x, y, y


def _cfg(**kw):
    base = dict(emsize=16, nhid=32, nlayers=2, nhead=2, batch_size=B, bptt=T, lr=1e-3, warmup_epochs=1, epochs=2,
                steps_per_epoch=2, aggregate_k_gradients=2, eval_pos_sampler="uniform", device="cpu", verbose=False)
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decoder", [None, ScaledDecoder, FixedScaledDecoder], ids=["mlp", "scaled", "fixed_scaled"])
def test_a_row_range_equals_those_rows_of_the_whole_output(decoder, dtype):
    torch.manual_seed(0)
    model = PFNTransformer(TransformerConfig(num_features=NF, n_out=7, emsize=16, nhid=32, nlayers=2, nhead=2,
                                             dtype=dtype, decoder=decoder)).eval()
    for p in model.parameters():  # every weight nonzero, so the zero-initialised projections take part
        p.data.add_(0.05 * torch.randn_like(p))
    assert isinstance(model.decoder, decoder or MLPDecoder)
    x, y = torch.randn(B, T, NF), torch.randn(B, T)
    sep = torch.tensor([5], dtype=torch.int32)
    with torch.no_grad():
        whole = model(x, y, sep)
        for start in (0, 1, T // 2, T - 1):
            for stop in (start, start + 1, T):
                part = model(x, y, sep, rows=(start, stop))
                assert part.shape == (B, stop - start, 7)
                torch.testing.assert_close(part, whole[:, start:stop], rtol=1e-5, atol=1e-6)
        with pytest.raises(ValueError, match="outside"):
            model(x, y, sep, rows=(3, T + 1))


def _draws(prior, cfg, seed, data=True):
    """The k microbatches (x, y, target_y, sep) as ``make_train_step`` draws
    them from ``seed``: each one's datasets, then its sep; with ``data``
    False the seps alone from ``seed`` (the host-fed step's draws) and the
    datasets from another generator."""
    g, other = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed + 1)
    weights = _eval_pos_weights(cfg, "cpu")
    out = []
    for _ in range(cfg.aggregate_k_gradients):
        x, y, target_y = prior.sample(cfg.batch_size, T, generator=g if data else other)
        out.append((x, y, target_y, _sample_eval_pos(g, cfg, weights)))
    return out


def _masked_update(model, criterion, microbatches):
    """The update with every row decoded and the loss masked to rows >= sep:
    (mean loss, pos_loss, pos_cnt, the summed gradients)."""
    model.train()
    model.zero_grad(set_to_none=True)
    losses, pos_loss, pos_cnt = [], torch.zeros(T), torch.zeros(T)
    positions = torch.arange(T)
    for x, y, target_y, sep in microbatches:
        out = model(x, y, sep)
        assert out.shape[1] == T
        mask = (positions >= sep).float().expand(x.shape[0], T) * criterion.valid_weight(target_y)
        num, den = (criterion.per_position(out, target_y) * mask).sum(), mask.sum().clamp_min(1.0)
        (num / den).backward()
        losses.append((num / den).detach())
        pos_loss += (positions == sep).float() * losses[-1]
        pos_cnt += (positions == sep).float()
    return torch.stack(losses).mean(), pos_loss, pos_cnt, {n: p.grad.clone() for n, p in model.named_parameters()}


def _assert_update_matches(metrics, model, want):
    loss, pos_loss, pos_cnt, grads = want
    torch.testing.assert_close(metrics["loss"], loss, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(metrics["pos_loss"], pos_loss, rtol=1e-5, atol=1e-6)
    assert torch.equal(metrics["pos_cnt"], pos_cnt)
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
    torch.testing.assert_close(metrics["grad_norm"], norm, rtol=1e-4, atol=1e-7)
    for name, p in model.named_parameters():  # .grad holds the clipped gradient after the step
        want_grad = grads[name] / max(1.0, float(norm))
        error = float((p.grad - want_grad).abs().max())
        assert error <= 1e-4 * float(want_grad.abs().max()), (name, error)  # of the leaf's largest entry


def _state(prior, criterion, cfg, seed):
    model = build_model(prior, criterion, cfg)
    optimizer, _, schedule = _make_optimizer(cfg, model)
    return TrainState(model, optimizer, torch.Generator().manual_seed(seed)), schedule


@pytest.mark.parametrize("kind", list(CRITERIA))
def test_an_update_equals_the_masked_update(kind):
    criterion, prior, cfg, seed = CRITERIA[kind](), _Prior(kind), _cfg(), 11
    microbatches = _draws(prior, cfg, seed)
    seps = [int(mb[3]) for mb in microbatches]
    assert len(set(seps)) == 2, seps  # two microbatches at different seps
    want = _masked_update(build_model(prior, criterion, cfg), criterion, microbatches)

    state, schedule = _state(prior, criterion, cfg, seed)
    with recording():
        metrics = make_train_step(prior, criterion, cfg, schedule)(state)
    _assert_update_matches(metrics, state.model, want)
    decoded = [s.rows for s in recorded() if s.name == "model.decoder"]
    assert decoded == [(B * (T - sep), B * T) for sep in seps]  # (T - sep) / T of a microbatch's rows


def test_the_host_fed_update_equals_the_masked_update():
    criterion, prior, cfg, seed = CRITERIA["full_bar"](), _Prior("full_bar"), _cfg(), 11
    microbatches = _draws(prior, cfg, seed, data=False)
    want = _masked_update(build_model(prior, criterion, cfg), criterion, microbatches)
    xs, ys, tys = (torch.stack([mb[i] for mb in microbatches]) for i in range(3))
    state, schedule = _state(prior, criterion, cfg, seed)
    _assert_update_matches(make_train_step_from_batch(criterion, cfg, schedule)(state, xs, ys, tys), state.model,
                           want)


def _scoring_model(criterion, n_out):
    torch.manual_seed(1)
    model = PFNTransformer(TransformerConfig(num_features=NF, n_out=n_out, emsize=16, nhid=32, nlayers=2,
                                             nhead=2)).eval()
    for p in model.parameters():
        p.data.add_(0.05 * torch.randn_like(p))
    return model


def test_the_harness_gives_the_values_of_the_whole_output():
    criterion = full_support_bar_criterion(BORDERS)
    model = _scoring_model(criterion, 20)
    x, y, target_y = _Prior("full_bar").sample(B, T, generator=torch.Generator().manual_seed(4))
    positions = [1, 2, 7, T - 1]
    with torch.no_grad():
        whole = {p: model(x, torch.where(torch.arange(T) < p, y, torch.zeros_like(y)), p) for p in range(1, T)}

        with recording():
            logits = eval_positional_logits_per_dataset(model, x, y, positions)
        torch.testing.assert_close(logits, torch.stack([whole[p][:, p] for p in positions]), rtol=1e-5, atol=1e-6)
        decoded = [s.rows for s in recorded() if s.name == "model.decoder"]
        assert decoded == [(B, B * T)] * len(positions)  # 1/T of the rows a pass

        losses = eval_positional_loss_per_dataset(model, criterion, x, y, target_y, positions)
        torch.testing.assert_close(
            losses, torch.stack([criterion.per_position(whole[p], target_y)[:, p] for p in positions]),
            rtol=1e-5, atol=1e-6)

        rows = torch.arange(T)[None, :]
        want = []
        for p in range(1, T, max(1, T // 10)):
            mask = (rows >= p).float()
            want.append(((criterion.mean(whole[p]) - target_y) ** 2 * mask).sum() / mask.sum())
        torch.testing.assert_close(mean_mse(model, criterion, x, y, target_y), torch.stack(want).mean(),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("path", ["mesh", "fused"])
def test_the_mesh_and_fused_paths_decode_every_row(path):
    criterion, prior = full_support_bar_criterion(BORDERS), _Prior("full_bar")
    cfg = _cfg(emsize=32, nhid=64, attention_impl="fused" if path == "fused" else "auto")
    mesh = None
    if path == "mesh":  # a one-rank mesh: no process group needed, every axis of size 1
        mesh = Mesh(shape={"dp": 1, "sp": 1, "tp": 1, "ep": 1}, coords={}, groups={}, device=torch.device("cpu"))
    model = build_model(prior, criterion, cfg, mesh=mesh)
    x, y, target_y = prior.sample(B, T, generator=torch.Generator().manual_seed(5))
    sep = torch.tensor([6], dtype=torch.int32)
    with recording():
        objective, loss = _loss_parts(model, criterion, cfg, x, y, target_y, sep)
    assert [s.rows for s in recorded() if s.name == "model.decoder"] == [(B * T, B * T)]
    with torch.no_grad():
        out = model(x, y, sep)
    losses = criterion.per_position(out, target_y)[:, 6:]
    torch.testing.assert_close(loss, losses.mean(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(objective.detach(), losses.mean(), rtol=1e-5, atol=1e-6)


def test_the_decoder_counter_is_rows_decoded_over_rows_produced():
    model = _scoring_model(None, 5)
    x, y = torch.randn(B, T, NF), torch.randn(B, T)
    with torch.no_grad():
        model(x, y, 4)  # recording off: no span, no counter
        assert recorded() == []
        with recording():
            model(x, y, 4)
            model(x, y, 4, rows=(4, T))
            model(x, y, 4, rows=(9, 10))
    spans = [s for s in recorded() if s.name == "model.decoder"]
    assert [s.rows for s in spans] == [(B * T, B * T), (B * (T - 4), B * T), (B, B * T)]
    assert [s.rows for s in recorded() if s.name != "model.decoder"] == [None] * 3


def test_sep_reaches_the_host_as_an_index():
    host = _HostSep(torch.tensor([12], dtype=torch.int32))
    assert operator.index(host) == 12 and list(range(20))[host:] == list(range(12, 20))
