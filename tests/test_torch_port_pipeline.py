"""The port's GPipe pipeline against the JAX package's model.

Four gloo ranks on the CPU (one spawn) run ``PipelinedPFN`` on dp2 x pp2 (2
microbatches a rank) and pp4 (4 microbatches), from the weights of a JAX
``PFNTransformer`` (seeded, through the weight bridge and
``to_pipeline_params``):
  * the forward, assembled from the ranks' rows, against JAX
    ``PFNTransformer.apply`` within 1e-5 (tests/test_pipeline.py:55), also
    with ``attention_impl="prefix"`` (the prefix pass and the self merge the
    stages run on the card) against the dense JAX model;
  * the gradients of a mean squared error, through the reverse schedule and
    the sum over dp, against ``jax.grad`` at atol 1e-5, rtol 1e-4 (:100);
  * one ``make_pp_train_step`` update (bar loss, Adam) equal to the port's
    unpipelined update within 1e-5 relative L2 of the parameter vector.
``to_pipeline_params`` against JAX's, stage by stage, bitwise.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_mesh_ranks as R
from pfn_tpu.models.transformer import PFNTransformer as JaxPFN
from pfn_tpu.models.transformer import TransformerConfig as JaxConfig
from pfn_tpu.parallel.pipeline import PipelinedPFN as JaxPipelinedPFN
from pfn_tpu.parallel.pipeline import make_pp_mesh as jax_make_pp_mesh
from pfn_tpu.parallel.pipeline import to_pipeline_params as jax_to_pipeline_params
from pfn_tpu_torch.models import PFNTransformer, TransformerConfig
from pfn_tpu_torch.parallel import to_pipeline_params
from pfn_tpu_torch.train import bar_criterion, seeded_flax_params, state_dict_from_flax_params
from pfn_tpu_torch.train.checkpoints import state_dict_from_flax_pipeline_params
from pfn_tpu_torch.train.loop import _loss_terms

MODEL = dict(num_features=1, n_out=16, emsize=32, nhead=4, nhid=64, nlayers=4)
B, T, SEP, LR = 8, 12, 6, 1e-3
BORDERS = np.linspace(-3.0, 3.0, MODEL["n_out"] + 1).astype(np.float32)
CASES = {"dp2_pp2": ({"dp": 2, "pp": 2}, "dense", 2), "dp2_pp2_prefix": ({"dp": 2, "pp": 2}, "prefix", 2),
         "pp4": ({"pp": 4}, "dense", 4)}


def _flax():
    return seeded_flax_params(1, MODEL["emsize"], MODEL["nhid"], MODEL["nlayers"], MODEL["n_out"], seed=21)


def _data(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, 1)).astype(np.float32)
    y = rng.standard_normal((B, T)).astype(np.float32)
    target = rng.standard_normal((B, T, MODEL["n_out"])).astype(np.float32)
    return x, y, target


@pytest.fixture(scope="module")
def runs():
    flax = _flax()
    weights = {n: t.numpy() for n, t in state_dict_from_flax_params(flax, MODEL["nlayers"]).items()}
    x, y, target = _data(0)
    batch = _data(1)[:2] + (_data(1)[1].copy(),)
    payload = {"weights": weights, "data": (x, y, target), "sep": SEP, "model": MODEL, "cases": CASES,
               "step": CASES["dp2_pp2"], "lr": LR, "batch": batch, "borders": BORDERS}
    ranks = R.run_ranks(R.pipeline_cases, 4, payload)
    jmodel = JaxPFN(JaxConfig(**MODEL, attention_impl="dense"))
    params = jax.tree.map(jnp.asarray, flax)
    xj, yj, tj = (jnp.asarray(a) for a in (x, y, target))
    out = np.asarray(jmodel.apply(params, xj, yj, SEP))
    grads = jax.grad(lambda p: jnp.mean((jmodel.apply(p, xj, yj, SEP) - tj) ** 2))(params)
    return ranks, out, state_dict_from_flax_params(jax.device_get(grads), MODEL["nlayers"]), weights, batch


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_forward_matches_jax(runs, name):
    ranks, want, _, _, _ = runs
    got = R.assemble(ranks, (name, "out"), want.shape, ("dp", None, None))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_grads_match_jax(runs, name):
    ranks, _, want, _, _ = runs
    got = {}
    for r in ranks:
        coords, grads = r[(name, "grads")]
        for n, g in grads.items():
            if n in got:  # the embedding and decoder: the same on every rank
                np.testing.assert_array_equal(g, got[n], err_msg=n)
            got[n] = g
    assert set(got) == set(want)
    for n, ref in want.items():
        np.testing.assert_allclose(got[n], ref.numpy(), atol=1e-5, rtol=1e-4, err_msg=n)


def test_pp_train_step_equals_the_unpipelined_update(runs):
    ranks, _, _, weights, batch = runs
    model = PFNTransformer(TransformerConfig(**MODEL, attention_impl="dense"))
    model.load_state_dict({n: torch.from_numpy(a) for n, a in weights.items()}, strict=True)
    optimizer = torch.optim.Adam(model.parameters(), lr=LR)
    x, y, ty = (torch.from_numpy(a) for a in batch)
    num, den = _loss_terms(bar_criterion(torch.from_numpy(BORDERS)), model(x, y, SEP), ty, SEP, None)
    (num / den).backward()
    optimizer.step()
    want = {n: p.detach().numpy() for n, p in model.named_parameters()}
    got = {}
    for r in ranks:
        loss, params = r["step"]
        assert loss == pytest.approx(float(num / den), rel=1e-5)
        got.update(params)
    names = list(want)
    a, b = (np.concatenate([np.asarray(t[n], np.float64).ravel() for n in names]) for t in (got, want))
    assert float(np.linalg.norm(a - b) / np.linalg.norm(b)) <= 1e-5


def test_to_pipeline_params_matches_jax(eight_devices):
    flax = _flax()
    jax_pp = JaxPipelinedPFN(JaxConfig(**MODEL), jax_make_pp_mesh(dp=2, pp=4), num_micro=2)
    jax_params = jax_to_pipeline_params(jax.tree.map(jnp.asarray, flax), jax_pp)
    flat = state_dict_from_flax_params(flax, MODEL["nlayers"])
    port = types.SimpleNamespace(layers_per_stage=1, mesh=None)
    for stage in range(4):
        want = state_dict_from_flax_pipeline_params(jax.device_get(jax_params), 1, stage)
        got = to_pipeline_params(flat, port, stage)
        assert set(got) == set(want)
        for n in want:
            assert torch.equal(got[n], want[n]), n
