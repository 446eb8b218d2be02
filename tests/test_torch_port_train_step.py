"""Parity of the port's training step with the JAX package's.

Schedules, samplers and the parameter count against the JAX functions;
gradients through the whole model; and two optimizer updates of
``make_train_step_from_batch`` from identical params and batches.

Inputs and weights come from numpy seeds (``seeded_flax_params``: out_proj and
linear2 nonzero, so attention reaches the loss) and cross through the weight
bridge. Both sides run the dense attention path on the CPU, in f32 unless
stated. Tolerances:
  * schedules: 1e-5 relative plus 1e-9 absolute (JAX computes in f32, the
    port in Python floats; the cosine tail near 0 loses f32 digits);
  * sampler weights: 1e-6 relative (both f32);
  * gradients: 1e-5 of each leaf's largest entry; bf16: the port's error
    against JAX-f32 at most twice JAX-bf16's own (the rule of
    tests/test_torch_port_model.py);
  * two updates: loss and grad norm 1e-5 relative; params see
    test_two_updates_match_optax.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.models.transformer import PFNTransformer as JaxPFN
from pfn_tpu.models.transformer import TransformerConfig as JaxConfig
from pfn_tpu.models.transformer import num_params as jax_num_params
from pfn_tpu.train import bar_criterion as jax_bar_criterion
from pfn_tpu.train.loop import TrainConfig as JaxTrainConfig
from pfn_tpu.train.loop import TrainState as JaxTrainState
from pfn_tpu.train.loop import _make_optimizer as jax_make_optimizer
from pfn_tpu.train.loop import make_train_step_from_batch as jax_step_from_batch
from pfn_tpu.utils import samplers as jsamplers
from pfn_tpu.utils import schedules as jschedules
from pfn_tpu_torch.models import PFNTransformer, TransformerConfig, num_params
from pfn_tpu_torch.train import TrainConfig, TrainState, bar_criterion, build_model, seeded_flax_params
from pfn_tpu_torch.train import state_dict_from_flax_params
from pfn_tpu_torch.train.loop import _make_optimizer, _masked_loss, make_train_step_from_batch
from pfn_tpu_torch.utils import samplers, schedules

NFEAT, EMSIZE, NHEAD, NHID, NLAYERS, BUCKETS = 2, 32, 2, 64, 2, 20
B, T, SEP, K = 3, 24, 11, 2
BORDERS = np.linspace(-3.0, 3.0, BUCKETS + 1).astype(np.float32)
PRIOR = types.SimpleNamespace(num_features=NFEAT, num_outputs=1)


def _data(seed, k=None):
    rng = np.random.default_rng(seed)
    shape = (B, T) if k is None else (k, B, T)
    x = rng.standard_normal(shape + (NFEAT,)).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32)
    return x, y, y.copy()


def _close_rel(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=0)


@pytest.mark.parametrize("factory", ["cosine_schedule_with_warmup", "linear_schedule_with_warmup"])
def test_schedules_match_jax(factory):
    port, ref = getattr(schedules, factory)(3e-3, 4, 20), getattr(jschedules, factory)(3e-3, 4, 20)
    got = [port(c) for c in range(25)]
    want = [float(ref(c)) for c in range(25)]
    assert got[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


def test_openai_lr_and_num_params_match_jax():
    params = seeded_flax_params(NFEAT, EMSIZE, NHID, NLAYERS, BUCKETS, seed=0)
    model = PFNTransformer(TransformerConfig(num_features=NFEAT, n_out=BUCKETS, emsize=EMSIZE, nhead=NHEAD,
                                             nhid=NHID, nlayers=NLAYERS))
    n = num_params(model)
    assert n == jax_num_params(params)
    assert schedules.get_openai_lr(n) == pytest.approx(jschedules.get_openai_lr(n), rel=1e-12)


@pytest.mark.parametrize("kind", ["weighted", "uniform", "mixture"])
def test_eval_pos_weights_match_jax(kind):
    for max_len in (7, 300, 2000):
        _close_rel(samplers.make_eval_pos_weights(max_len, kind), jsamplers.make_eval_pos_weights(max_len, kind),
                   1e-6)


def test_eval_pos_draws_stay_on_device_and_in_range():
    """Draws are one-element int32 tensors in [0, max_len), with the weights'
    preference: the weighted sampler favours long contexts."""
    g = torch.Generator().manual_seed(0)
    w = [samplers.weighted_single_eval_pos(g, 50) for _ in range(400)]
    u = [samplers.uniform_single_eval_pos(g, 50) for _ in range(400)]
    for draws in (w, u):
        assert all(d.shape == (1,) and d.dtype == torch.int32 and 0 <= int(d) < 50 for d in draws)
    assert np.mean([int(d) for d in w]) > np.mean([int(d) for d in u]) + 5


def test_lr_per_update_matches_jax():
    """The LR of update n is the epoch schedule at n // updates_per_epoch,
    including the zero-LR first warmup epoch."""
    kw = dict(epochs=5, warmup_epochs=2, steps_per_epoch=6, aggregate_k_gradients=2, lr=1e-3)
    model = PFNTransformer(TransformerConfig(num_features=1, n_out=4, emsize=8, nhead=2, nhid=8, nlayers=1))
    _, base, port = _make_optimizer(TrainConfig(**kw), model)
    _, jbase, ref = jax_make_optimizer(JaxTrainConfig(**kw), num_params(model))
    assert base == jbase == 1e-3
    got = [port(n) for n in range(15)]
    np.testing.assert_allclose(got, [float(ref(n)) for n in range(15)], rtol=1e-5, atol=1e-9)
    assert got[:3] == [0.0] * 3 and got[3] > 0


def _jax_model(dtype=jnp.float32):
    cfg = JaxConfig(num_features=NFEAT, n_out=BUCKETS, emsize=EMSIZE, nhead=NHEAD, nhid=NHID, nlayers=NLAYERS,
                    attention_impl="dense", dtype=dtype)
    return JaxPFN(cfg)


def _jax_grads(params, x, y, ty, dtype=jnp.float32):
    model, crit = _jax_model(dtype), jax_bar_criterion(jnp.asarray(BORDERS))

    def loss_fn(p):
        losses = crit.per_position(model.apply(p, jnp.asarray(x), jnp.asarray(y), SEP), jnp.asarray(ty))
        mask = jnp.broadcast_to(jnp.arange(T)[None, :] >= SEP, losses.shape).astype(losses.dtype)
        return jnp.sum(losses * mask) / jnp.sum(mask)

    loss, grads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params))
    return float(loss), {k: v.numpy() for k, v in state_dict_from_flax_params(jax.device_get(grads), NLAYERS).items()}


def _port_cfg(**kw):
    base = dict(emsize=EMSIZE, nhid=NHID, nlayers=NLAYERS, nhead=NHEAD, bptt=T, batch_size=B, device="cpu",
                attention_impl="dense", verbose=False)
    base.update(kw)
    return TrainConfig(**base)


def _port_model(params, dtype=torch.float32):
    model = build_model(PRIOR, bar_criterion(torch.from_numpy(BORDERS)), _port_cfg(dtype=dtype))
    model.load_state_dict(state_dict_from_flax_params(params, NLAYERS), strict=True)
    return model


def _port_grads(params, x, y, ty, dtype=torch.float32):
    cfg = _port_cfg(dtype=dtype)
    model = _port_model(params, dtype)
    crit = bar_criterion(torch.from_numpy(BORDERS))
    sep = torch.tensor([SEP], dtype=torch.int32)
    loss = _masked_loss(model, crit, cfg, *(torch.from_numpy(a) for a in (x, y, ty)), sep)
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy() for n, p in model.named_parameters()}


def _max_rel_err(got, want):
    return max(float(np.abs(got[n] - want[n]).max() / np.abs(want[n]).max()) for n in want)


def test_f32_gradients_match_jax():
    params = seeded_flax_params(NFEAT, EMSIZE, NHID, NLAYERS, BUCKETS, seed=1)
    x, y, ty = _data(seed=2)
    jloss, jgrads = _jax_grads(params, x, y, ty)
    ploss, pgrads = _port_grads(params, x, y, ty)
    assert set(pgrads) == set(jgrads)
    assert ploss == pytest.approx(jloss, rel=1e-5)
    for name, want in jgrads.items():
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(pgrads[name], want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=name)


def test_bf16_gradients_within_twice_jax_bf16_error():
    params = seeded_flax_params(NFEAT, EMSIZE, NHID, NLAYERS, BUCKETS, seed=3)
    x, y, ty = _data(seed=4)
    _, gold = _jax_grads(params, x, y, ty)
    _, jax_bf16 = _jax_grads(params, x, y, ty, dtype=jnp.bfloat16)
    _, port_bf16 = _port_grads(params, x, y, ty, dtype=torch.bfloat16)
    jax_err, port_err = _max_rel_err(jax_bf16, gold), _max_rel_err(port_bf16, gold)
    assert 0 < jax_err
    assert port_err <= 2 * jax_err, (port_err, jax_err)


def test_two_updates_match_optax():
    """Two updates of the host-fed step, k = 2 microbatches, fixed sep, from
    the same params and batch, against the JAX step (optax clip + adam).

    warmup_epochs = 0 makes the LR of both updates nonzero (the first
    warmup epoch has LR 0). Loss and grad norm: 1e-5 relative. Params:
    Adam moves each entry by about lr * g / (|g| + 1e-8), so an entry whose
    summed gradient is at roundoff level may move by up to ~lr in either
    direction in either package (the key bias, whose gradient is zero in
    exact arithmetic, is such a case). Entries with |g| above 1e-4 of their
    leaf's largest |g| (at both updates) must agree to 1e-6 absolute + 1e-5
    relative, the rest within 4 lr, and they must be under 1 % of all
    entries.
    """
    params = seeded_flax_params(NFEAT, EMSIZE, NHID, NLAYERS, BUCKETS, seed=5)
    xs, ys, tys = _data(seed=6, k=K)
    lr = 1e-3
    kw = dict(emsize=EMSIZE, nhid=NHID, nlayers=NLAYERS, nhead=NHEAD, bptt=T, batch_size=B, aggregate_k_gradients=K,
              epochs=4, steps_per_epoch=K, lr=lr, warmup_epochs=0, eval_pos_sampler="fixed", fixed_eval_pos=SEP,
              attention_impl="dense", verbose=False)

    jcfg = JaxTrainConfig(**kw)
    jmodel, jcrit = _jax_model(), jax_bar_criterion(jnp.asarray(BORDERS))
    jparams = jax.tree.map(jnp.asarray, params)
    tx, _, _ = jax_make_optimizer(jcfg, jax_num_params(jparams))
    jstate = JaxTrainState(params=jparams, opt_state=tx.init(jparams), step=jnp.zeros((), jnp.int32))
    jstep = jax_step_from_batch(jmodel, jcrit, jcfg, tx)

    cfg = TrainConfig(**kw, device="cpu")
    model = _port_model(params)
    optimizer, _, schedule = _make_optimizer(cfg, model)
    state = TrainState(model, optimizer, torch.Generator().manual_seed(0))
    step = make_train_step_from_batch(bar_criterion(torch.from_numpy(BORDERS)), cfg, schedule)

    tiny = {}
    for _ in range(2):
        jstate, jm = jstep(jstate, jax.random.PRNGKey(0), *(jnp.asarray(a) for a in (xs, ys, tys)))
        m = step(state, *(torch.from_numpy(a) for a in (xs, ys, tys)))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        np.testing.assert_array_equal(m["pos_cnt"].numpy(), np.asarray(jm["pos_cnt"]))
        for n, p in model.named_parameters():
            g = np.abs(p.grad.numpy())
            tiny[n] = tiny.get(n, False) | (g <= 1e-4 * g.max())
    assert state.step == 2 and int(jstate.step) == 2
    want = state_dict_from_flax_params(jax.device_get(jstate.params), NLAYERS)
    assert sum(t.sum() for t in tiny.values()) < 0.01 * sum(t.size for t in tiny.values())
    for n, p in model.named_parameters():
        got, ref, t = p.detach().numpy(), want[n].numpy(), tiny[n]
        np.testing.assert_allclose(got[~t], ref[~t], rtol=1e-5, atol=1e-6, err_msg=n)
        assert np.abs(got[t] - ref[t]).max(initial=0.0) <= 4 * lr, n
