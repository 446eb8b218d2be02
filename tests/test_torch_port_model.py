"""Parity of the port's PFNTransformer with the JAX package's, through the
weight bridge.

Every weight (out_proj and linear2 included) is a numpy normal, so attention
and the FFN reach the output. Tolerances:
  * f32: 1e-5 (atol and rtol), as tests/test_torch_parity.py holds the
    reference torch model to the flax one.
  * bf16: bf16 rounds at other places in XLA and in PyTorch, so the port is
    not compared to JAX-bf16 directly. Instead the port's bf16 error against
    JAX-f32 must be at most twice JAX-bf16's own error against JAX-f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.models.transformer import PFNTransformer as JaxPFN
from pfn_tpu.models.transformer import TransformerConfig as JaxConfig
from pfn_tpu.train.checkpoints import export_torch_state_dict
from pfn_tpu_torch.models import (
    LearnedPositionalEncoding,
    MLPEncoder,
    PFNTransformer,
    ScaledDecoder,
    TransformerConfig,
)
from pfn_tpu_torch.train import seeded_flax_params, state_dict_from_flax_params

NFEAT, NOUT, EMSIZE, NHEAD, NHID, NLAYERS = 3, 10, 64, 2, 128, 2
B, T, SEP = 2, 40, 17


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T, NFEAT)).astype(np.float32), rng.standard_normal((B, T)).astype(np.float32)


def _params(seed=0):
    return seeded_flax_params(NFEAT, EMSIZE, NHID, NLAYERS, NOUT, seed=seed)


def _jax_logits(params, x, y, dtype=jnp.float32, exact_gelu=False):
    cfg = JaxConfig(num_features=NFEAT, n_out=NOUT, emsize=EMSIZE, nhead=NHEAD, nhid=NHID, nlayers=NLAYERS,
                    attention_impl="dense", dtype=dtype, exact_gelu=exact_gelu)
    jparams = jax.tree.map(jnp.asarray, params)
    return np.asarray(JaxPFN(cfg).apply(jparams, jnp.asarray(x), jnp.asarray(y), SEP), np.float32)


def _port(params, dtype=torch.float32, exact_gelu=False, attention_impl="auto"):
    cfg = TransformerConfig(num_features=NFEAT, n_out=NOUT, emsize=EMSIZE, nhead=NHEAD, nhid=NHID,
                            nlayers=NLAYERS, dtype=dtype, exact_gelu=exact_gelu, attention_impl=attention_impl)
    model = PFNTransformer(cfg).eval()
    model.load_state_dict(state_dict_from_flax_params(params, NLAYERS), strict=True)
    return model


def _port_logits(model, x, y, sep=SEP):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(y), sep).float().numpy()


def test_seeded_params_have_the_jax_tree():
    """The numpy tree has exactly the JAX model's structure and shapes."""
    cfg = JaxConfig(num_features=NFEAT, n_out=NOUT, emsize=EMSIZE, nhead=NHEAD, nhid=NHID, nlayers=NLAYERS)
    init = JaxPFN(cfg).init_params(jax.random.PRNGKey(0), seq_len=T)
    shapes = jax.tree.map(lambda a: tuple(a.shape), init)
    assert jax.tree.map(lambda a: tuple(a.shape), _params()) == shapes


@pytest.mark.parametrize("exact_gelu", [False, True])
def test_f32_forward_matches_jax(exact_gelu):
    params = _params(seed=1)
    x, y = _inputs(seed=2)
    want = _jax_logits(params, x, y, exact_gelu=exact_gelu)
    got = _port_logits(_port(params, exact_gelu=exact_gelu), x, y)
    assert got.shape == (B, T, NOUT)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_bf16_error_within_twice_jax_bf16_error():
    params = _params(seed=3)
    x, y = _inputs(seed=4)
    gold = _jax_logits(params, x, y)
    jax_err = np.abs(_jax_logits(params, x, y, dtype=jnp.bfloat16) - gold).max()
    port_err = np.abs(_port_logits(_port(params, dtype=torch.bfloat16), x, y) - gold).max()
    assert 0 < jax_err
    assert port_err <= 2 * jax_err, (port_err, jax_err)


def test_bridge_equals_jax_export_and_loads_strictly():
    """The bridge gives the keys and values of the JAX package's own torch
    export, and the port's model takes them with strict=True."""
    params = _params(seed=5)
    got = state_dict_from_flax_params(params, NLAYERS)
    want = export_torch_state_dict(jax.tree.map(jnp.asarray, params), NLAYERS)
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value, err_msg=name)
    model = PFNTransformer(TransformerConfig(num_features=NFEAT, n_out=NOUT, emsize=EMSIZE, nhead=NHEAD,
                                             nhid=NHID, nlayers=NLAYERS))
    assert set(model.state_dict()) == set(want)
    model.load_state_dict(got, strict=True)


def test_fresh_model_starts_as_identity_stack():
    """out_proj and linear2 are zero-initialised, as in the JAX package."""
    model = PFNTransformer(TransformerConfig(num_features=NFEAT, n_out=NOUT, emsize=EMSIZE, nhead=NHEAD,
                                             nhid=NHID, nlayers=NLAYERS))
    for layer in model.transformer_encoder.layers:
        for p in (layer.self_attn.out_proj.weight, layer.self_attn.out_proj.bias, layer.linear2.weight):
            assert bool((p == 0).all())
        assert bool((layer.self_attn.in_proj_weight != 0).any())


def test_eval_labels_are_invisible_and_sep_may_be_a_tensor():
    """y at rows >= sep does not reach any output; a tensor sep equals the int."""
    params = _params(seed=6)
    model = _port(params)
    x, y = _inputs(seed=7)
    y2 = y.copy()
    y2[:, SEP:] += 100.0
    base = _port_logits(model, x, y)
    np.testing.assert_array_equal(base, _port_logits(model, x, y2))
    np.testing.assert_array_equal(base, _port_logits(model, x, y, sep=torch.tensor([SEP], dtype=torch.int32)))
    np.testing.assert_allclose(_port_logits(_port(params, attention_impl="prefix"), x, y), base, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("field,value", [
    ("input_normalization", True),
    ("num_experts", 2),
    ("encoder", lambda in_features, emsize: MLPEncoder(in_features, emsize)),
    ("pos_encoder", lambda emsize, max_len: LearnedPositionalEncoding(emsize, max_len)),
    ("decoder", lambda emsize, nhid, n_out: ScaledDecoder(emsize, nhid, n_out)),
])
def test_unported_options_raise(field, value):
    """None of these options raises any more: SeqBN and the encoder,
    positional-encoding and decoder factories (queue 1 item 9) and the MoE
    FFN (item 14) build and run. Their parity with the JAX model is
    tests/test_torch_port_model_options.py's and test_torch_port_moe.py's."""
    cfg = dataclasses.replace(TransformerConfig(num_features=1, n_out=4, emsize=8, nhead=2, nhid=8, nlayers=1),
                              **{field: value})
    out = PFNTransformer(cfg).eval()(torch.rand(2, 5, 1), torch.rand(2, 5), 2)
    assert out.shape == (2, 5, 4) and bool(torch.isfinite(out).all())


def test_dropout_in_training_raises():
    """Dropout in training draws its masks from an explicit generator only:
    without one the forward raises ValueError (no draw from torch's global
    RNG); with one it runs, and eval mode is deterministic without one."""
    model = PFNTransformer(TransformerConfig(num_features=1, n_out=4, emsize=8, nhead=2, nhid=8, nlayers=1,
                                             dropout=0.1))
    x, y = torch.zeros(1, 5, 1), torch.zeros(1, 5)
    with pytest.raises(ValueError, match="generator"):
        model.train()(x, y, 2)
    assert bool(torch.isfinite(model.train()(x, y, 2, generator=torch.Generator().manual_seed(0))).all())
    model.eval()(x, y, 2)
