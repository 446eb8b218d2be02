"""One training update of the port on a device mesh, against the port's
one-rank update and the JAX package's single-device update.

Four gloo ranks on the CPU (``torch_port_mesh_ranks``, one spawn for every
layout), each drawing nothing: the global batch and the weights (seeded flax
params through the weight bridge) come from the parent, and every rank keeps
its rows and positions. Layouts: dp2 (on dp2 x ep2 with a dense model,
whose ep pairs hold and compute the same), dp2 x tp2, dp2 x sp2 (the
sharded attention on its dense prefix pass, as on the CPU), fsdp over dp4,
num_experts=4 over dp4, dp2 x ep2 and sp2 x ep2 (capacity 7 of T 24, so
tokens drop), and SeqBN (input_normalization) on dp2 x sp2. Each
update is held against
  * the port's one-rank update of the same weights and batch: the whole
    parameter vector and the whole clipped gradient vector within 1e-5
    relative L2, loss and grad norm 1e-5 relative;
  * the JAX package's single-device ``make_train_step_from_batch``: the
    loss within 1e-5, the clipped gradient tensor by tensor within GRAD_RTOL
    relative L2 (and GRAD_ATOL) (the gradient JAX takes, captured by an optimizer that keeps
    it, under optax's clip), and the parameters within 2e-4 absolute
    (tests/test_sharding.py:76). Adam's first step moves an entry by about
    lr times the sign of its gradient whatever the gradient's size, so at
    lr 5e-5 the parameter check sees little: the gradient check is what
    holds the backward, the MoE one's router, experts and aux term included,
    to JAX's. Each gradient tensor is also held to the one-rank update's at
    GRAD_RTOL. The SeqBN layout against the one-rank update only.
Deviations held here: SeqBN under dp and sp takes its statistics over the
global batch, as GSPMD does (the one-rank update is the check), and dropout
under a mesh raises ValueError (its masks would need the global shape).
Then a checkpoint written on dp2 x sp2, fsdp dp4, dp2 x tp2 and MoE on
dp2 x ep2, after an epoch at a nonzero lr, resumes on the same mesh bitwise
equal to an uninterrupted run, and on one rank (the loaded state, Adam's
moments included, is the gathered one) within 1e-5; and
``_active_param_count`` against JAX's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_mesh_ranks as R
from pfn_tpu.models.transformer import PFNTransformer as JaxPFN
from pfn_tpu.models.transformer import TransformerConfig as JaxConfig
from pfn_tpu.train import bar_criterion as jax_bar_criterion
from pfn_tpu.train.loop import TrainConfig as JaxTrainConfig
from pfn_tpu.train.loop import TrainState as JaxTrainState
from pfn_tpu.train.loop import _active_param_count as jax_active_param_count
from pfn_tpu.train.loop import _make_optimizer as jax_make_optimizer
from pfn_tpu.train.loop import make_train_step_from_batch as jax_step_from_batch
from pfn_tpu_torch.priors import RidgePrior
from pfn_tpu_torch.train import TrainConfig, bar_criterion, build_model, mse_criterion, seeded_flax_params, train
from pfn_tpu_torch.train import state_dict_from_flax_params
from pfn_tpu_torch.train.loop import _active_param_count

NFEAT, EMSIZE, NHEAD, NHID, NLAYERS, BUCKETS = 2, 32, 4, 64, 2, 20
B, T, SEP, K, LR = 4, 24, 9, 2, 5e-5
# A gradient tensor within GRAD_RTOL relative L2 plus GRAD_ATOL an entry:
# float reassociation moves one by at most about 2e-6 relative, and the
# atol covers a gradient that is exactly 0 (encoder.bias under SeqBN, whose
# mean removes it), where both sides hold f32 noise of about 1e-8.
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
BORDERS = np.linspace(-3.0, 3.0, BUCKETS + 1).astype(np.float32)
# name: (layout, extra TrainConfig fields). "dp2" runs on dp2 x ep2 with a
# dense model, where the two ranks of an ep pair hold and compute the same.
CASES = {
    "dp2": ({"dp": 2, "ep": 2}, {}),
    "dp2_tp2": ({"dp": 2, "tp": 2}, {}),
    "dp2_sp2": ({"dp": 2, "sp": 2}, {}),
    "fsdp_dp4": ({"dp": 4}, {"fsdp": True}),
    "moe4_dp4": ({"dp": 4}, {"num_experts": 4}),
    "moe4_dp2_ep2": ({"dp": 2, "ep": 2}, {"num_experts": 4}),
    "moe4_sp2_ep2": ({"sp": 2, "ep": 2}, {"num_experts": 4}),
    "seqbn_dp2_sp2": ({"dp": 2, "sp": 2}, {"input_normalization": True}),
}
JAX_CASES = [name for name in CASES if name != "seqbn_dp2_sp2"]


def _cfg(**kw):
    return dict(emsize=EMSIZE, nhid=NHID, nlayers=NLAYERS, nhead=NHEAD, bptt=T, batch_size=B, aggregate_k_gradients=K,
                epochs=4, steps_per_epoch=K, lr=LR, warmup_epochs=0, eval_pos_sampler="fixed", fixed_eval_pos=SEP,
                attention_impl="auto", verbose=False, **kw)


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, B, T, NFEAT)).astype(np.float32)
    y = rng.standard_normal((K, B, T)).astype(np.float32)
    return x, y, y.copy()


def _weights(num_experts=0, input_normalization=False):
    return seeded_flax_params(NFEAT, EMSIZE, NHID, NLAYERS, BUCKETS, seed=7, num_experts=num_experts,
                              input_normalization=input_normalization)


def _case(name, layout, extra, flax):
    cfg = _cfg(device="cpu", **extra)
    weights = {n: t.numpy() for n, t in state_dict_from_flax_params(flax, NLAYERS).items()}
    return {"name": name, "layout": layout, "cfg": cfg, "weights": weights, "batch": _batch(3),
            "borders": BORDERS}


def _jax_update(flax, num_experts=0):
    """JAX's single-device update of ``flax`` on the batch: the new
    parameters, the loss and the clipped gradient, in the port's names.
    ``make_train_step_from_batch`` runs with an optimizer that applies
    nothing and keeps the summed gradient as its state; the train config's
    optimizer then takes that gradient as the step itself would
    (``tx.update``, ``optax.apply_updates``)."""
    jcfg = JaxTrainConfig(**{k: v for k, v in _cfg(num_experts=num_experts).items()})
    model = JaxPFN(JaxConfig(num_features=NFEAT, n_out=BUCKETS, emsize=EMSIZE, nhead=NHEAD, nhid=NHID,
                             nlayers=NLAYERS, attention_impl="dense", num_experts=num_experts))
    params = jax.tree.map(jnp.asarray, flax)
    keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    state = JaxTrainState(params=params, opt_state=keep.init(params), step=jnp.zeros((), jnp.int32))
    step = jax.jit(jax_step_from_batch(model, jax_bar_criterion(jnp.asarray(BORDERS)), jcfg, keep))
    kept, metrics = step(state, jax.random.PRNGKey(0), *(jnp.asarray(a) for a in _batch(3)))
    tx, _, _ = jax_make_optimizer(jcfg, 1)
    new = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(kept.opt_state, params)
    norm = float(metrics["grad_norm"])
    grads = state_dict_from_flax_params(jax.device_get(kept.opt_state), NLAYERS)
    clipped = {n: g.numpy() / (norm if norm >= 1.0 else 1.0) for n, g in grads.items()}
    return state_dict_from_flax_params(jax.device_get(new), NLAYERS), float(metrics["loss"]), clipped


def _vec(tensors: dict, names) -> np.ndarray:
    return np.concatenate([np.asarray(tensors[n], np.float64).ravel() for n in names])


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_grads_close(got: dict, want: dict):
    """Each gradient tensor of ``got`` within GRAD_RTOL relative L2 of
    ``want``'s, plus GRAD_ATOL an entry (in L2: times the root of its size)."""
    assert set(got) == set(want)
    bad = {}
    for n, w in want.items():
        w, d = np.asarray(w, np.float64), np.asarray(got[n], np.float64) - np.asarray(w, np.float64)
        if not np.linalg.norm(d) <= GRAD_RTOL * np.linalg.norm(w) + GRAD_ATOL * np.sqrt(w.size):
            bad[n] = (float(np.linalg.norm(d)), float(np.linalg.norm(w)))
    assert not bad, f"(|error|, |gradient|) of the tensors out of bounds: {bad}"


@pytest.fixture(scope="module")
def updates():
    flax = {"dense": _weights(), "moe": _weights(4), "seqbn": _weights(input_normalization=True)}
    cases = [_case(name, layout, extra, flax["moe" if extra.get("num_experts") else
                                              "seqbn" if extra.get("input_normalization") else "dense"])
             for name, (layout, extra) in CASES.items()]
    ranks = R.run_ranks(R.mesh_update_cases, 4, {"cases": cases})
    torch.set_num_threads(1)
    one = {c["name"]: R.one_update(c, None) for c in cases}
    jax_ref = {"dense": _jax_update(flax["dense"]), "moe": _jax_update(flax["moe"], 4)}
    return ranks, one, jax_ref


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_update_matches_the_one_rank_update(updates, name):
    ranks, one, _ = updates
    got, want = ranks[0][name], one[name]
    names = list(want["params"])
    for r in ranks[1:]:  # every rank holds the same gathered state
        for n in names:
            np.testing.assert_array_equal(r[name]["params"][n], got["params"][n], err_msg=n)
    assert _rel_l2(_vec(got["params"], names), _vec(want["params"], names)) <= 1e-5
    assert _rel_l2(_vec(got["grads"], names), _vec(want["grads"], names)) <= 1e-5
    _assert_grads_close(got["grads"], want["grads"])
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)


@pytest.mark.parametrize("name", JAX_CASES)
def test_mesh_update_matches_jax_single_device(updates, name):
    ranks, _, jax_ref = updates
    want, jloss, jgrads = jax_ref["moe" if CASES[name][1].get("num_experts") else "dense"]
    got = ranks[0][name]
    assert got["loss"] == pytest.approx(jloss, rel=1e-5)
    _assert_grads_close(got["grads"], jgrads)
    assert set(got["params"]) == set(want)
    for n, ref in want.items():
        np.testing.assert_allclose(got["params"][n], ref.numpy(), rtol=0, atol=2e-4, err_msg=n)


# name: (layout, extra TrainConfig fields) of a checkpointed run.
RESUME_CASES = {
    "dp2_sp2": ({"dp": 2, "sp": 2}, {}),
    "fsdp_dp4": ({"dp": 4}, {"fsdp": True}),
    "dp2_tp2": ({"dp": 2, "tp": 2}, {}),
    "moe4_dp2_ep2": ({"dp": 2, "ep": 2}, {"num_experts": 4}),
}


def _resume_cfg(extra):
    # warmup_epochs=0: the first epoch trains at a nonzero lr, so the
    # checkpointed weights and Adam moments have moved from the init.
    return dict(emsize=EMSIZE, nhid=NHID, nlayers=NLAYERS, nhead=NHEAD, bptt=T, batch_size=B, steps_per_epoch=2,
                lr=1e-3, warmup_epochs=0, verbose=False, device="cpu", attention_impl="auto", **extra)


@pytest.fixture(scope="module")
def resumes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("resume"))
    cases = [{"name": n, "layout": layout, "cfg": _resume_cfg(extra)} for n, (layout, extra) in RESUME_CASES.items()]
    return R.run_ranks(R.resume_cases, 4, {"cases": cases, "dir": root}), root


def _check_resume(resumes, name):
    ranks, root = resumes
    straight, resumed = ranks[0][(name, "straight")], ranks[0][(name, "resumed")]
    init = build_model(RidgePrior(num_features=2), mse_criterion(),
                       TrainConfig(**_resume_cfg(RESUME_CASES[name][1]))).state_dict()
    names = list(straight)
    assert _rel_l2(_vec(straight, names), _vec({n: t.numpy() for n, t in init.items()}, names)) > 1e-4
    for n in straight:
        np.testing.assert_array_equal(resumed[n], straight[n], err_msg=n)
    assert ranks[0][(name, "straight_loss")] == ranks[0][(name, "resumed_loss")]
    # The checkpoint holds the one-device state: one rank resumes from it.
    torch.set_num_threads(1)
    one = train(RidgePrior(num_features=2), mse_criterion(),
                TrainConfig(**_resume_cfg(RESUME_CASES[name][1]), epochs=2,
                            checkpoint_dir=os.path.join(root, name, "epoch1"), checkpoint_every=0))
    assert _rel_l2(_vec({n: t.numpy() for n, t in one.model.state_dict().items()}, names),
                   _vec(straight, names)) <= 1e-5


def test_checkpoint_on_dp2_sp2_resumes_on_the_mesh_and_on_one_rank(resumes):
    _check_resume(resumes, "dp2_sp2")


@pytest.mark.parametrize("name", [n for n in RESUME_CASES if n != "dp2_sp2"])
def test_checkpoint_on_a_sharded_mesh_resumes_on_the_mesh_and_on_one_rank(resumes, name):
    _check_resume(resumes, name)


def test_dropout_under_a_mesh_raises():
    mesh = R.types.SimpleNamespace(axis_size=lambda a: 2 if a == "dp" else 1, shape={"dp": 2})
    cfg = TrainConfig(**{**_cfg(device="cpu"), "dropout": 0.1})
    with pytest.raises(ValueError, match="dropout under a device mesh"):
        build_model(R.PRIOR, bar_criterion(torch.from_numpy(BORDERS)), cfg, mesh=mesh)


def test_active_param_count_matches_jax():
    """Expert weights count at 1/E in the automatic LR, as in the JAX
    package; a dense model counts every entry."""
    for experts in (0, 4):
        flax = _weights(experts)
        cfg = TrainConfig(**_cfg(device="cpu", num_experts=experts))
        model = build_model(R.PRIOR, bar_criterion(torch.from_numpy(BORDERS)), cfg)
        assert _active_param_count(model, experts) == jax_active_param_count(flax, experts)
