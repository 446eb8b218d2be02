"""The port's training loop on its own, at a tiny GP configuration on the CPU:
train() runs and learns, its bookkeeping, chunked updates, checkpoints and
bitwise resume, the host-fed path, the inference constructors, the options
that are not ported, and the attention dispatch rule the training path runs
on the card.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pfn_tpu_torch.distributions import get_bucket_limits
from pfn_tpu_torch.inference import PFNRegressor
from pfn_tpu_torch.ops import attention as tattn
from pfn_tpu_torch.ops.flash_attention import flash_supported, flash_supported_on
from pfn_tpu_torch.priors import GPPrior, sample_y_for_buckets
from pfn_tpu_torch.train import TrainConfig, TrainState, bar_criterion, build_model, train
from pfn_tpu_torch.train.loop import _make_optimizer, make_train_step

PRIOR = GPPrior(num_features=1, noise=1e-4, outputscale=1.0, lengthscale=0.6)
JAX_STATS_KEYS = {"epoch", "mean_loss", "lr", "epoch_time", "step_time", "val_score"}


@pytest.fixture(scope="module")
def criterion():
    return bar_criterion(get_bucket_limits(20, ys=sample_y_for_buckets(PRIOR, 2000, 20, seed=1)))


def _cfg(**kw):
    base = dict(emsize=32, nhid=64, nlayers=2, nhead=2, epochs=4, steps_per_epoch=8, batch_size=8, bptt=16,
                lr=3e-3, warmup_epochs=1, eval_pos_sampler="mixture", device="cpu", verbose=False)
    base.update(kw)
    return TrainConfig(**base)


def _params(model):
    return {name: t.clone() for name, t in model.state_dict().items()}


def _assert_same_params(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_train_runs_and_loss_falls(criterion):
    result = train(PRIOR, criterion, _cfg())
    losses = [s["mean_loss"] for s in result.epoch_stats]
    assert [s["epoch"] for s in result.epoch_stats] == [1, 2, 3, 4]
    assert all(JAX_STATS_KEYS <= set(s) and np.isfinite(s["grad_norm"]) for s in result.epoch_stats)
    assert result.epoch_stats[0]["lr"] == 0.0 and result.epoch_stats[1]["lr"] == 3e-3
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert result.final_loss == losses[-1]
    assert len(result.positional_losses) == 16


def test_positional_bookkeeping(criterion):
    """pos_cnt is the one-hot count of the drawn seps, pos_loss the loss of
    each microbatch at its sep; loss is the mean over the k microbatches."""
    cfg = _cfg(aggregate_k_gradients=4)
    model = build_model(PRIOR, criterion, cfg)
    optimizer, _, schedule = _make_optimizer(cfg, model)
    state = TrainState(model, optimizer, torch.Generator().manual_seed(0))
    m = make_train_step(PRIOR, criterion, cfg, schedule)(state)
    assert state.step == 1
    assert m["pos_cnt"].shape == (16,) and float(m["pos_cnt"].sum()) == 4.0
    assert bool(((m["pos_loss"] != 0) <= (m["pos_cnt"] > 0)).all())
    assert float(m["pos_loss"].sum()) == pytest.approx(4 * float(m["loss"]), rel=1e-6)
    assert float(m["grad_norm"]) > 0


def test_fixed_sampler_and_positional_losses(criterion):
    result = train(PRIOR, criterion, _cfg(epochs=1, eval_pos_sampler="fixed", fixed_eval_pos=5))
    pos = np.asarray(result.positional_losses)
    assert np.isfinite(pos[5]) and pos[5] > 0
    assert (np.delete(pos, 5) == 0).all()


def test_updates_per_call_gives_the_same_params(criterion):
    one = train(PRIOR, criterion, _cfg(epochs=2))
    two = train(PRIOR, criterion, _cfg(epochs=2, updates_per_call=4))
    _assert_same_params(_params(one.model), _params(two.model))
    for a, b in zip(one.epoch_stats, two.epoch_stats):
        assert a["mean_loss"] == pytest.approx(b["mean_loss"], rel=1e-6)
    with pytest.raises(ValueError, match="updates_per_call"):
        train(PRIOR, criterion, _cfg(updates_per_call=3))


def test_resume_is_bitwise_equal_to_an_uninterrupted_run(criterion, tmp_path, capsys):
    """Stopped after epoch 2 and resumed to epoch 4: model, optimizer state,
    step and generator are restored, so every bit matches. With one warmup
    epoch, epochs 1-2 have the same LR whatever the total."""
    full = train(PRIOR, criterion, _cfg())
    ckdir = str(tmp_path / "ck")
    train(PRIOR, criterion, _cfg(epochs=2, checkpoint_dir=ckdir, checkpoint_every=1))
    resumed = train(PRIOR, criterion, _cfg(checkpoint_dir=ckdir, checkpoint_every=1, verbose=True))
    assert f"resumed from {ckdir}/epoch_2 (epoch 2)" in capsys.readouterr().out
    assert [s["epoch"] for s in resumed.epoch_stats] == [3, 4]
    assert resumed.final_loss == full.final_loss
    _assert_same_params(_params(full.model), _params(resumed.model))


def test_retention_and_completed_run(criterion, tmp_path):
    ckdir = str(tmp_path / "ck")
    cfg = _cfg(epochs=5, steps_per_epoch=2, checkpoint_dir=ckdir, checkpoint_every=1, checkpoint_keep=2)
    train(PRIOR, criterion, cfg)
    assert sorted(os.listdir(ckdir)) == ["epoch_4", "epoch_5"]
    assert train(PRIOR, criterion, cfg).epoch_stats == []  # nothing left to do


def test_host_fed_data_iter(criterion):
    """data_iter switches to the host-fed step: numpy batches in, the prior
    only gives the feature count."""
    rng = np.random.default_rng(0)

    def batches():
        while True:
            x = rng.uniform(size=(8, 16, 1)).astype(np.float32)
            y = np.sin(6 * x[..., 0]).astype(np.float32) + 0.1 * rng.standard_normal((8, 16)).astype(np.float32)
            yield x, y, y

    result = train(PRIOR, criterion, _cfg(epochs=2, aggregate_k_gradients=2), data_iter=batches())
    assert len(result.epoch_stats) == 2 and np.isfinite(result.final_loss)
    with pytest.raises(ValueError, match="updates_per_call"):
        train(PRIOR, criterion, _cfg(updates_per_call=2), data_iter=batches())


def test_regressor_from_train_result_and_checkpoint(criterion, tmp_path):
    ckdir = str(tmp_path / "ck")
    cfg = _cfg(epochs=2, checkpoint_dir=ckdir, checkpoint_every=1)
    result = train(PRIOR, criterion, cfg)
    x = np.linspace(0.0, 1.0, 16, dtype=np.float32)[:, None]
    y = np.sin(4 * x[:, 0])
    mean, std = PFNRegressor.from_train_result(result).fit(x[:8], y[:8]).predict(x[8:], return_std=True)
    assert mean.shape == std.shape == (8,)
    assert np.isfinite(mean).all() and np.isfinite(std).all() and (std > 0).all()
    again = PFNRegressor.from_checkpoint(ckdir, PRIOR, criterion, cfg).fit(x[:8], y[:8]).predict(x[8:])
    np.testing.assert_array_equal(again, mean)
    with pytest.raises(FileNotFoundError):
        PFNRegressor.from_checkpoint(str(tmp_path / "none"), PRIOR, criterion, cfg)


@pytest.mark.parametrize("over,kwargs", [
    ({"fsdp": True}, {}),
    ({"num_experts": 2}, {}),
    ({"dropout": 0.1}, {}),
    ({"encoder": lambda emsize: None}, {}),
    ({"decoder": lambda nhid, n_out: None}, {}),
    ({"eval_pos_sampler": "custom"}, {}),
    ({}, {"mesh": object()}),
], ids=["fsdp", "experts", "dropout", "encoder", "decoder", "sampler", "mesh"])
def test_unported_options_raise_naming_their_roadmap_item(criterion, over, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train(PRIOR, criterion, _cfg(**over), **kwargs)


def test_flash_supported_is_the_auto_dispatch_rule():
    """The kernels serve CUDA tensors with head dims 32, 64 or 128. With the
    TrainConfig defaults (emsize 200, 2 heads: head dim 100) training on the
    card takes the dense path, as the JAX package does; the Fig-3a width
    (emsize 512, 4 heads) takes the kernels."""
    defaults = TrainConfig()
    assert not flash_supported_on("cuda", defaults.emsize // defaults.nhead)
    assert flash_supported_on("cuda", 512 // 4)
    assert all(flash_supported_on("cuda", d) for d in (32, 64, 128))
    assert not flash_supported_on("cpu", 128)
    assert not flash_supported(torch.zeros(1, 2, 8, 64))


def test_device_default_needs_a_card(monkeypatch, criterion):
    """TrainConfig.device=None means the current CUDA device: without a card
    training raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(PRIOR, criterion, _cfg(device=None))
    with pytest.raises(RuntimeError, match="CUDA"):
        train(PRIOR, criterion, _cfg(device=None, epochs=1))
    assert next(build_model(PRIOR, criterion, _cfg()).parameters()).device.type == "cpu"


@pytest.mark.parametrize("supported", [True, False])
def test_auto_and_prefix_follow_flash_supported(monkeypatch, supported):
    """impl='auto' and the prefix pass of impl='prefix' take the kernel path
    exactly where flash_supported holds; 'flash' ignores the rule (and raises
    where the kernel cannot run)."""
    calls = []
    q = torch.randn(1, 2, 12, 16)
    monkeypatch.setattr(tattn, "flash_supported", lambda t: supported)
    for name in ("pfn_flash_attention", "pfn_attention_reference", "pfn_flash_prefix_attention",
                 "pfn_prefix_attention_reference"):
        real = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _n=name, _f=real, **k: calls.append(_n) or _f(*a, **k))
    tattn.pfn_attention(q, q, q, 5, impl="auto")
    tattn.pfn_attention(q, q, q, 5, impl="prefix")
    if supported:
        assert calls == ["pfn_flash_attention", "pfn_flash_prefix_attention"]
    else:
        assert calls == ["pfn_attention_reference", "pfn_prefix_attention_reference"]
    with pytest.raises(RuntimeError, match="CUDA"):
        tattn.pfn_attention(q, q, q, 5, impl="flash")


def test_build_model_is_seeded_and_leaves_the_global_rng(criterion):
    state = torch.random.get_rng_state()
    a = build_model(PRIOR, criterion, _cfg(seed=3))
    assert torch.equal(torch.random.get_rng_state(), state)
    b = build_model(PRIOR, criterion, dataclasses.replace(_cfg(), seed=3))
    _assert_same_params(_params(a), _params(b))
