"""The port's spans (``pfn_tpu_torch.utils.profiling``) on the CPU: off they
record nothing; on (``recording()``, or a ``torch.profiler`` session's
active phase) they keep their names, parents and host times; the training
step gives bitwise the same result with them on, and records each span the
benchmark's per-layer metrics read; scoring records a forward and a decoder
per position; ``train()`` still reports its step time.
"""

import pytest
import torch

from pfn_tpu_torch.distributions import get_bucket_limits
from pfn_tpu_torch.evals.harness import eval_positional_logits_per_dataset
from pfn_tpu_torch.priors import GPPrior, sample_y_for_buckets
from pfn_tpu_torch.train import TrainConfig, TrainState, bar_criterion, build_model, train
from pfn_tpu_torch.train.loop import _make_optimizer, make_train_step
from pfn_tpu_torch.utils import profiling
from pfn_tpu_torch.utils.profiling import clear, recorded, recording, recording_on, span

PRIOR = GPPrior(num_features=1, noise=1e-4, outputscale=1.0, lengthscale=0.6)
TRAIN_SPANS = {"train.update", "prior.sample", "model.forward", "model.decoder", "train.loss", "train.backward",
               "train.backward.head", "train.backward.encoder", "train.optimizer"}


@pytest.fixture(autouse=True)
def _empty_buffer():
    clear()
    yield
    clear()


@pytest.fixture(scope="module")
def criterion():
    return bar_criterion(get_bucket_limits(20, ys=sample_y_for_buckets(PRIOR, 2000, 20, seed=1)))


def _cfg(**kw):
    base = dict(emsize=32, nhid=64, nlayers=2, nhead=2, epochs=2, steps_per_epoch=4, batch_size=4, bptt=16,
                lr=3e-3, warmup_epochs=1, eval_pos_sampler="mixture", device="cpu", verbose=False)
    base.update(kw)
    return TrainConfig(**base)


def test_spans_record_nothing_while_off():
    assert not recording_on()
    first, second = span("a"), span("b")
    assert first is second  # one shared do-nothing object
    with first:
        with second:
            torch.ones(3).sum()
    assert recorded() == []


def test_nested_spans_record_their_parents():
    with recording():
        assert recording_on()
        with span("outer"):
            with span("inner"):
                torch.ones(3).sum()
            with span("sibling"):
                pass
        with span("next"):
            pass
    assert not recording_on()
    spans = recorded()
    assert [s.name for s in spans] == ["outer", "inner", "sibling", "next"]
    assert [s.parent for s in spans] == [None, 0, 0, None]
    outer, inner, sibling, after = spans
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= sibling.start_ns <= sibling.end_ns <= outer.end_ns
    assert outer.end_ns <= after.start_ns
    assert all(s.records is None and s.device_ms is None for s in spans)  # no CUDA here: host times only
    clear()
    assert recorded() == []


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with recording(), pytest.warns(RuntimeWarning, match="dropped"):
        for i in range(5):
            with span(f"s{i}"):
                pass
    assert [s.name for s in recorded()] == ["s0", "s1", "s2"]


def test_recording_follows_a_profilers_active_phase():
    from torch.profiler import ProfilerActivity, profile, schedule

    seen = []
    with profile(activities=[ProfilerActivity.CPU], schedule=schedule(wait=1, warmup=1, active=1, repeat=1)) as prof:
        for phase in ("wait", "warmup", "active", "done"):
            seen.append(recording_on())
            with span(phase):
                torch.ones(4).sum()
            prof.step()
    assert seen == [False, False, True, False]
    assert not recording_on()
    assert [s.name for s in recorded()] == ["active"]


def _two_updates(criterion, record: bool, **kw):
    cfg = _cfg(aggregate_k_gradients=2, **kw)
    model = build_model(PRIOR, criterion, cfg)
    optimizer, _, schedule = _make_optimizer(cfg, model)
    state = TrainState(model, optimizer, torch.Generator().manual_seed(3))
    step = make_train_step(PRIOR, criterion, cfg, schedule)
    outs = []
    for _ in range(2):
        if record:
            with recording():
                outs.append(step(state))
        else:
            outs.append(step(state))
    return outs, {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_the_step_is_bitwise_the_same_with_spans_and_records_each(criterion, impl):
    off, off_params = _two_updates(criterion, False, attention_impl=impl)
    assert recorded() == []
    on, on_params = _two_updates(criterion, True, attention_impl=impl)
    for a, b in zip(off, on):
        for key in ("loss", "pos_loss", "pos_cnt", "grad_norm"):
            assert torch.equal(a[key], b[key]), key
    assert off_params.keys() == on_params.keys()
    assert all(torch.equal(off_params[n], on_params[n]) for n in off_params)

    spans = recorded()
    names = [s.name for s in spans]
    assert set(names) == TRAIN_SPANS
    assert names.count("train.update") == 2 and names.count("train.optimizer") == 2
    for name in TRAIN_SPANS - {"train.update", "train.optimizer"}:
        assert names.count(name) == 4, name  # 2 updates x 2 microbatches
    parent = {i: spans[s.parent].name if s.parent is not None else None for i, s in enumerate(spans)}
    want = {"train.update": None, "prior.sample": "train.update", "model.forward": "train.update",
            "model.decoder": "model.forward", "train.loss": "train.update", "train.backward": "train.update",
            "train.backward.head": "train.backward", "train.backward.encoder": "train.backward",
            "train.optimizer": "train.update"}
    assert all(parent[i] == want[s.name] for i, s in enumerate(spans))
    for i, s in enumerate(spans):
        if s.name == "train.backward.head":  # the cut: head then encoder, tiling the backward
            whole, rest = spans[s.parent], spans[i + 1]
            assert rest.name == "train.backward.encoder" and rest.parent == s.parent
            assert whole.start_ns == s.start_ns and s.end_ns <= rest.start_ns and rest.end_ns == whole.end_ns


def test_scoring_records_a_forward_and_a_decoder_per_position(criterion):
    model = build_model(PRIOR, criterion, _cfg()).eval()
    x, y, _ = PRIOR.sample(3, 16, generator=torch.Generator().manual_seed(0))
    positions = [1, 5, 9, 15]
    with recording():
        logits = eval_positional_logits_per_dataset(model, x, y, positions)
    assert torch.equal(logits, eval_positional_logits_per_dataset(model, x, y, positions))
    spans = recorded()
    assert [s.name for s in spans] == ["model.forward", "model.decoder"] * len(positions)
    assert [s.parent for s in spans] == [p for i in range(len(positions)) for p in (None, 2 * i)]


def test_train_reports_step_time(criterion):
    result = train(PRIOR, criterion, _cfg())
    for stats in result.epoch_stats:
        assert 0 < stats["step_time"] * 2 <= stats["epoch_time"]  # two updates an epoch, each timed
    assert recorded() == []  # off: train() records nothing
