"""Parity of the port's fused model forward (pfn_tpu_torch.models.fused_apply)
with the JAX package's, at the sizes of tests/test_fused_apply.py. The JAX
fused path runs its Pallas kernels in interpret mode; the port runs its plain
version on CPU tensors. Inputs come from a numpy seed; weights are seeded
draws in the JAX layout, carried to the port by the weight bridge.

Tolerances: f32 3e-5 (atol and rtol), tests/test_fused_apply.py's; bf16
1e-2 (see tests/test_torch_port_fused_layer.py: one flipped bf16 rounding);
gradients 5e-4, tests/test_fused_apply.py's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.models.fused_apply import fused_forward as jax_fused_forward
from pfn_tpu.models.fused_apply import fused_supported as jax_fused_supported
from pfn_tpu.models.transformer import PFNTransformer as JaxPFN
from pfn_tpu.models.transformer import TransformerConfig as JaxConfig
from pfn_tpu_torch.models import PFNTransformer, TransformerConfig
from pfn_tpu_torch.models.fused_apply import fused_forward, fused_supported
from pfn_tpu_torch.train import seeded_flax_params, state_dict_from_flax_params

SIZES = dict(num_features=2, n_out=10, emsize=32, nhead=2, nhid=48, nlayers=2)  # tests/test_fused_apply.py:20-26
B, T = 2, 16
F32_TOL, BF16_TOL, GRAD_TOL = 3e-5, 1e-2, 5e-4


def _cfg(**kw):
    return TransformerConfig(**{**SIZES, "attention_impl": "fused", **kw})


def _jax_cfg(**kw):
    return JaxConfig(**{**SIZES, "attention_impl": "fused", **kw})


def _weights(seed=0):
    return seeded_flax_params(SIZES["num_features"], SIZES["emsize"], SIZES["nhid"], SIZES["nlayers"],
                              SIZES["n_out"], seed=seed)


def _model(params, **kw):
    model = PFNTransformer(_cfg(**kw)).eval()
    model.load_state_dict(state_dict_from_flax_params(params, SIZES["nlayers"]), strict=True)
    return model


def _data(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, SIZES["num_features"])).astype(np.float32),
            rng.standard_normal((B, T)).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("sep", [0, 9, 16])
def test_fused_forward_matches_jax(sep):
    params, (x, y) = _weights(), _data(seed=sep)
    jp = jax.tree.map(jnp.asarray, params)
    want_fused = jax_fused_forward(_jax_cfg(), jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(sep), interpret=True)
    want_model = JaxPFN(_jax_cfg(attention_impl="dense")).apply(jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(sep))
    with torch.no_grad():
        got = fused_forward(_model(params), torch.from_numpy(x), torch.from_numpy(y), sep)
    assert got.shape == (B, T, SIZES["n_out"]) and got.dtype == torch.float32
    _close(got, want_fused, F32_TOL)
    _close(got, want_model, F32_TOL)


def test_fused_forward_bf16_matches_jax():
    params, (x, y) = _weights(1), _data(seed=1)
    jp = jax.tree.map(jnp.asarray, params)
    want = jax_fused_forward(_jax_cfg(dtype=jnp.bfloat16), jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(9),
                             interpret=True)
    with torch.no_grad():
        got = fused_forward(_model(params, dtype=torch.bfloat16), torch.from_numpy(x), torch.from_numpy(y), 9)
    _close(got, want, BF16_TOL)


def test_fused_forward_gradients_match_model():
    """On CPU tensors autograd flows through the plain fused layers into the
    model's own parameters, as through the unfused forward."""
    params, (x, y) = _weights(2), _data(seed=2)
    w = torch.from_numpy(np.random.default_rng(3).standard_normal((B, T, SIZES["n_out"])).astype(np.float32))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    fused, unfused = _model(params), _model(params, attention_impl="dense")
    (w * fused_forward(fused, xt, yt, 5)).sum().backward()
    (w * unfused(xt, yt, 5)).sum().backward()
    for (name, a), (_, b) in zip(fused.named_parameters(), unfused.named_parameters()):
        _close(a.grad, b.grad, GRAD_TOL)


def test_model_configured_fused_runs_the_ordinary_path():
    """attention_impl='fused' on PFNTransformer evaluates as 'auto' (the JAX
    package's rule); only fused_forward takes the fused layers."""
    params, (x, y) = _weights(3), _data(seed=3)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad():
        assert torch.equal(_model(params)(xt, yt, 7), _model(params, attention_impl="auto")(xt, yt, 7))


def test_fused_supported_gates():
    """tests/test_fused_apply.py:79-90, plus the kernels' own width rule,
    which holds only for a CUDA device: the JAX package's gate has none, and
    the plain version on the CPU takes any width."""
    assert fused_supported(_cfg()) is None
    assert "dropout" in fused_supported(_cfg(dropout=0.1))
    assert "MoE" in fused_supported(_cfg(num_experts=2))
    assert "SeqBN" in fused_supported(_cfg(input_normalization=True))
    assert "exact" in fused_supported(_cfg(exact_gelu=True))
    assert "head dim" in fused_supported(_cfg(emsize=200, nhead=2, nhid=208), "cuda")
    assert "multiples of 16" in fused_supported(_cfg(nhid=40), torch.device("cuda"))
    for kw in (dict(emsize=200, nhead=2, nhid=208), dict(nhid=40)):
        assert fused_supported(_cfg(**kw)) is None and fused_supported(_cfg(**kw), "cpu") is None
        assert jax_fused_supported(_jax_cfg(**kw)) is None
    assert "emsize % nhead" in fused_supported(_cfg(emsize=30, nhead=4))
    model = PFNTransformer(_cfg(dropout=0.1))
    with pytest.raises(ValueError, match="dropout"):
        fused_forward(model, torch.zeros(1, 4, 2), torch.zeros(1, 4), 2)


# Widths outside the kernels' rule (head dim 20, nhid 40), which the JAX
# package's fused path runs; on the CPU the port's plain version does too.
ODD = dict(num_features=2, n_out=10, emsize=40, nhead=2, nhid=40, nlayers=2)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_fused_forward_at_widths_outside_the_kernel_rule_matches_jax(dtype_name):
    jdt, tdt, tol = {"f32": (jnp.float32, torch.float32, F32_TOL),
                     "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}[dtype_name]
    params = seeded_flax_params(ODD["num_features"], ODD["emsize"], ODD["nhid"], ODD["nlayers"], ODD["n_out"], seed=5)
    x, y = _data(seed=6)
    want = jax_fused_forward(JaxConfig(**ODD, attention_impl="fused", dtype=jdt), jax.tree.map(jnp.asarray, params),
                             jnp.asarray(x), jnp.asarray(y), jnp.asarray(9), interpret=True)
    model = PFNTransformer(TransformerConfig(**ODD, attention_impl="fused", dtype=tdt)).eval()
    model.load_state_dict(state_dict_from_flax_params(params, ODD["nlayers"]), strict=True)
    with torch.no_grad():
        got = fused_forward(model, torch.from_numpy(x), torch.from_numpy(y), 9)
    assert got.shape == (B, T, ODD["n_out"])
    _close(got, want, tol)


def test_long_sequence_raises():
    model = _model(_weights())
    with pytest.raises(ValueError, match="T <= 512"):
        fused_forward(model, torch.zeros(1, 513, 2), torch.zeros(1, 513), 100)


def test_flagship_config_is_supported():
    """The bench.py flagship (emsize 512, 4 heads, nhid 1024) is a kernel
    width; the Fig-3a shape (T = 2010) is not a fused sequence length."""
    flagship = dataclasses.replace(_cfg(), emsize=512, nhead=4, nhid=1024, nlayers=6, dtype=torch.bfloat16)
    assert fused_supported(flagship) is None
