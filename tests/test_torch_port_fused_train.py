"""Training through the port's fused layers, on the CPU (the plain forward
and backward of pfn_tpu_torch.ops.fused_layer on CPU tensors).

  * fused_forward's parameter gradients against jax.grad of the JAX
    package's fused_forward (its Pallas kernels in interpret mode), in f32
    and in bf16. In bf16 the weight gradients are f32 sums, as in JAX, not
    values rounded to bf16 through a bf16 copy of the weights.
  * One update of TrainConfig(attention_impl="fused") against the port's
    unfused update from the same params, batch and sep, in f32.
  * train() with attention_impl="fused", and the configs the fused path does
    not take raising ValueError before anything runs; the kernels' width
    rule only for a CUDA device, as the CPU's plain version takes any width.

Tolerances: f32 gradients 5e-4 (atol and rtol), tests/test_fused_apply.py's;
bf16 gradients 1e-2 of each leaf's largest entry (one flipped bf16 rounding,
see tests/test_torch_port_fused_bwd.py); the f32 update 5e-4: loss and grad
norm relative, the new params absolute (the first Adam step moves an entry
by about lr * sign(g), so at lr 1e-4 an entry whose gradient is at roundoff
level may differ by up to 2e-4).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.models.fused_apply import fused_forward as jax_fused_forward
from pfn_tpu.models.transformer import TransformerConfig as JaxConfig
from pfn_tpu_torch.distributions import get_bucket_limits
from pfn_tpu_torch.models import PFNTransformer, TransformerConfig
from pfn_tpu_torch.models.fused_apply import fused_forward, fused_supported
from pfn_tpu_torch.priors import GPPrior
from pfn_tpu_torch.train import (
    TrainConfig,
    TrainState,
    bar_criterion,
    build_model,
    seeded_flax_params,
    state_dict_from_flax_params,
    train,
)
from pfn_tpu_torch.train.loop import _make_optimizer, make_train_step, make_train_step_from_batch

SIZES = dict(num_features=2, n_out=10, emsize=32, nhead=2, nhid=48, nlayers=2)  # tests/test_fused_apply.py:20-26
B, T = 2, 16
GRAD_TOL, BF16_REL_TOL, UPDATE_TOL = 5e-4, 1e-2, 5e-4
WEIGHTS = ("self_attn.in_proj_weight", "self_attn.out_proj.weight", "linear1.weight", "linear2.weight")


def _weights(seed):
    return seeded_flax_params(SIZES["num_features"], SIZES["emsize"], SIZES["nhid"], SIZES["nlayers"],
                              SIZES["n_out"], seed=seed)


def _data(seed, shape=(B, T)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape + (SIZES["num_features"],)).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _jax_grads(params, x, y, w, sep, dtype):
    cfg = JaxConfig(**SIZES, attention_impl="fused", dtype=dtype)

    def loss(p):
        out = jax_fused_forward(cfg, p, jnp.asarray(x), jnp.asarray(y), jnp.asarray(sep), interpret=True)
        return jnp.sum(jnp.asarray(w) * out)

    grads = jax.grad(loss)(jax.tree.map(jnp.asarray, params))
    return {k: v.numpy() for k, v in state_dict_from_flax_params(jax.device_get(grads), SIZES["nlayers"]).items()}


def _port_grads(params, x, y, w, sep, dtype):
    model = PFNTransformer(TransformerConfig(**SIZES, attention_impl="fused", dtype=dtype))
    model.load_state_dict(state_dict_from_flax_params(params, SIZES["nlayers"]), strict=True)
    (torch.from_numpy(w) * fused_forward(model, torch.from_numpy(x), torch.from_numpy(y), sep)).sum().backward()
    return {name: p.grad for name, p in model.named_parameters()}


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_fused_forward_gradients_match_jax(dtype_name):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype_name]
    params, (x, y) = _weights(4), _data(seed=5)
    w = np.random.default_rng(6).standard_normal((B, T, SIZES["n_out"])).astype(np.float32)
    want = _jax_grads(params, x, y, w, 7, jdt)
    got = _port_grads(params, x, y, w, 7, tdt)
    assert set(got) == set(want)
    for name, g in got.items():
        assert g.dtype == torch.float32, name
        if dtype_name == "f32":
            np.testing.assert_allclose(g.numpy(), want[name], atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)
        else:
            err, scale = float(np.abs(g.numpy() - want[name]).max()), float(np.abs(want[name]).max())
            assert err <= BF16_REL_TOL * scale, (name, err, scale)
    if dtype_name == "bf16":
        # f32 sums, as JAX's: a gradient rounded through a bf16 copy of the
        # weight would be exactly representable in bf16.
        for i in range(SIZES["nlayers"]):
            for name in WEIGHTS:
                g = got[f"transformer_encoder.layers.{i}.{name}"]
                assert not torch.equal(g, g.to(torch.bfloat16).float()), name


PRIOR = types.SimpleNamespace(num_features=2, num_outputs=1)
BORDERS = torch.linspace(-3.0, 3.0, 11)


def _cfg(**kw):
    base = dict(emsize=32, nhid=48, nlayers=2, nhead=2, bptt=T, batch_size=B, aggregate_k_gradients=2, epochs=4,
                steps_per_epoch=2, lr=1e-4, warmup_epochs=0, eval_pos_sampler="fixed", fixed_eval_pos=9,
                device="cpu", verbose=False, attention_impl="fused")
    base.update(kw)
    return TrainConfig(**base)


def _state(cfg, params):
    model = build_model(PRIOR, bar_criterion(BORDERS), cfg)
    model.load_state_dict(state_dict_from_flax_params(params, SIZES["nlayers"]), strict=True)
    optimizer, _, schedule = _make_optimizer(cfg, model)
    return TrainState(model, optimizer, torch.Generator().manual_seed(0)), schedule


def test_fused_update_matches_unfused_update():
    """One update (k = 2 microbatches, fixed sep) through the fused layers
    and through the unfused model, from the same params and batch, f32."""
    params = _weights(8)
    x, y = _data(seed=9, shape=(2, B, T))
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    out = {}
    for impl in ("fused", "auto"):
        cfg = _cfg(attention_impl=impl)
        state, schedule = _state(cfg, params)
        m = make_train_step_from_batch(bar_criterion(BORDERS), cfg, schedule)(state, xs, ys, ys.clone())
        out[impl] = (m, {n: (p.detach().clone(), p.grad.clone()) for n, p in state.model.named_parameters()})
    (mf, pf), (mu, pu) = out["fused"], out["auto"]
    assert float(mf["loss"]) == pytest.approx(float(mu["loss"]), rel=UPDATE_TOL)
    assert float(mf["grad_norm"]) == pytest.approx(float(mu["grad_norm"]), rel=UPDATE_TOL)
    assert torch.equal(mf["pos_cnt"], mu["pos_cnt"])
    for name, (p, g) in pf.items():
        np.testing.assert_allclose(p.numpy(), pu[name][0].numpy(), rtol=0, atol=UPDATE_TOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), pu[name][1].numpy(), rtol=0,
                                   atol=UPDATE_TOL * float(pu[name][1].abs().max()), err_msg=name)


def test_train_fused_on_cpu_learns_and_resumes(tmp_path):
    """train() with attention_impl="fused" on a small GP prior: finite losses,
    a checkpoint after epoch 1 and a resume that matches an uninterrupted
    run bit for bit."""
    prior = GPPrior(num_features=1, noise=1e-4, outputscale=1.0, lengthscale=0.6)
    crit = bar_criterion(get_bucket_limits(20, full_range=(-4.0, 4.0)))
    cfg = dataclasses.replace(_cfg(nhid=64, batch_size=8, steps_per_epoch=4, epochs=2, lr=3e-3),
                              eval_pos_sampler="uniform", fixed_eval_pos=None)
    init = state_dict_from_flax_params(seeded_flax_params(1, 32, 64, 2, 20, seed=1), 2)
    full = train(prior, crit, cfg, init_params=init)
    ckdir = str(tmp_path / "ck")
    train(prior, crit, dataclasses.replace(cfg, epochs=1, checkpoint_dir=ckdir, checkpoint_every=1), init_params=init)
    resumed = train(prior, crit, dataclasses.replace(cfg, checkpoint_dir=ckdir, checkpoint_every=1),
                    init_params=init)
    assert [s["epoch"] for s in resumed.epoch_stats] == [2]
    assert all(np.isfinite(s["mean_loss"]) and np.isfinite(s["grad_norm"]) for s in full.epoch_stats)
    assert resumed.final_loss == full.final_loss
    for (name, a), (_, b) in zip(full.model.state_dict().items(), resumed.model.state_dict().items()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("over,match,card_only", [
    ({"emsize": 200, "nhid": 208}, "head dim", True),
    ({"nhid": 40}, "multiples of 16", True),
    ({"bptt": 513, "fixed_eval_pos": 100}, "bptt 513 > 512", False),
], ids=["head_dim", "nhid", "bptt"])
def test_unsupported_fused_config_raises_before_anything_runs(over, match, card_only):
    """A config the fused path does not take raises before anything runs.
    The kernels' width rule (head dim 16/32/64/128, D and F multiples of 16)
    holds only where a model meets the kernels: the gate names it for a CUDA
    device, and on the CPU, where the plain version runs and the JAX package's
    fused path takes these widths too, the config trains."""
    cfg = _cfg(**over)
    if card_only:
        model = build_model(PRIOR, bar_criterion(BORDERS), cfg)
        assert match in fused_supported(model.config, "cuda")
        assert fused_supported(model.config, "cpu") is None and fused_supported(model.config) is None
        prior = GPPrior(num_features=2, noise=1e-4, outputscale=1.0, lengthscale=0.6)
        result = train(prior, bar_criterion(BORDERS), dataclasses.replace(cfg, epochs=1, warmup_epochs=1))
        assert all(np.isfinite(s["mean_loss"]) and np.isfinite(s["grad_norm"]) for s in result.epoch_stats)
        return
    with pytest.raises(ValueError, match=match):
        train(PRIOR, bar_criterion(BORDERS), cfg)
    # The device-fed step raises before it draws a microbatch.
    state, schedule = _state(_cfg(), _weights(10))
    state.model = build_model(PRIOR, bar_criterion(BORDERS), cfg)
    before = state.generator.get_state()
    prior = GPPrior(num_features=2, noise=1e-4, outputscale=1.0, lengthscale=0.6)
    with pytest.raises(ValueError, match=match):
        make_train_step(prior, bar_criterion(BORDERS), cfg, schedule)(state)
    assert torch.equal(state.generator.get_state(), before) and state.step == 0
