"""Parity of the port's fused encoder layer (pfn_tpu_torch.ops.fused_layer)
with the JAX package's Pallas kernel, which runs in interpret mode as
tests/test_fused_layer.py runs it. On CPU tensors the port runs its plain
version (the CUDA kernel is held against that plain version on the card by
chip_smoke.py). Inputs and weights come from a numpy seed.

Tolerances: f32 3e-5 (atol and rtol), tests/test_fused_layer.py's: both sides
compute in f32 and differ only in summation order. bf16 1e-2: both sides
round to bf16 at the same places (qkv, p, the head outputs, ao, rc, g), so
they differ where an f32 summation-order difference flips one bf16 rounding
(one ulp is 2^-8 relative, ~4e-3 at the O(1) activations after a
LayerNorm). Gradients 3e-4, tests/test_fused_layer.py's: both backwards
recompute p from the saved lse and differ in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.ops import fused_layer as jfused
from pfn_tpu_torch.models.transformer import PFNEncoderLayer
from pfn_tpu_torch.ops import _ext
from pfn_tpu_torch.ops import fused_layer as tfused

D, H, F = 64, 2, 96
CASES = [(3, 24, 10), (4, 16, 0), (2, 16, 16), (1, 40, 39)]  # tests/test_fused_layer.py:74
SHAPES = _ext.fused_param_shapes(D, F)
F32_TOL, BF16_TOL, GRAD_TOL = 3e-5, 1e-2, 3e-4


def _params(seed=0):
    """Random layer weights in the JAX layout: matrices N(0, 1/fan_in),
    biases N(0, 0.3^2), LayerNorm scales 1 + N(0, 0.3^2); out_proj and
    linear2 nonzero."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in SHAPES.items():
        a = rng.standard_normal(shape)
        if len(shape) == 2:
            out[k] = (a / np.sqrt(shape[0])).astype(np.float32)
        else:
            out[k] = (0.3 * a + (1.0 if k.endswith("_g") else 0.0)).astype(np.float32)
    return out


def _x(B, T, seed):
    return np.random.default_rng(seed).standard_normal((B, T, D)).astype(np.float32)


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,T,sep", CASES)
def test_forward_matches_jax(B, T, sep):
    p, x = _params(), _x(B, T, seed=B + T + sep)
    want = jfused.fused_encoder_layer(jnp.asarray(x), _jax(p), jnp.asarray(sep), H, jnp.float32, True)
    got = tfused.fused_encoder_layer(torch.from_numpy(x), _torch(p), sep, H, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (B, T, D)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("B,T,sep", CASES)
def test_residual_and_lse_match_jax(B, T, sep):
    """r (post-LN1) and lse (B, T, H), which the backward kernels take, as
    the JAX package's ``_fwd_call`` returns them."""
    p, x = _params(1), _x(B, T, seed=2 * T + sep)
    want = jfused._fwd_call(jnp.asarray(x), _jax(p), sep, H, jnp.float32, True)
    got = tfused.fused_layer_fwd(torch.from_numpy(x), _torch(p), sep, H, torch.float32)
    for name, a, b in zip(("y", "r", "lse"), got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        _close(a, b, F32_TOL)


@pytest.mark.parametrize("B,T,sep", CASES)
def test_bf16_matches_jax(B, T, sep):
    p, x = _params(2), _x(B, T, seed=3 * T + sep)
    want = jfused._fwd_call(jnp.asarray(x), _jax(p), sep, H, jnp.bfloat16, True)
    got = tfused.fused_layer_fwd(torch.from_numpy(x), _torch(p), sep, H, torch.bfloat16)
    for a, b in zip(got, want):
        _close(a, b, BF16_TOL)


def test_gradients_match_jax():
    """Autograd on CPU tensors (through the plain version) against jax.grad
    through the JAX kernels' custom VJP."""
    p, x = _params(3), _x(2, 24, seed=4)
    w = np.random.default_rng(5).standard_normal((2, 24, D)).astype(np.float32)
    sep = 11

    def loss(params, xx):
        return jnp.sum(jnp.asarray(w) * jfused.fused_encoder_layer(xx, params, jnp.asarray(sep), H, jnp.float32,
                                                                    True))

    gp_want, gx_want = jax.grad(loss, argnums=(0, 1))(_jax(p), jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in _torch(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    (torch.from_numpy(w) * tfused.fused_encoder_layer(tx, tp, sep, H, torch.float32)).sum().backward()
    _close(tx.grad, gx_want, GRAD_TOL)
    for k in SHAPES:
        _close(tp[k].grad, gp_want[k], GRAD_TOL)


def test_plain_matches_unfused_port_layer():
    """In f32 the fused layer is the port's PFNEncoderLayer (the JAX test's
    check against the flax layer, here against the port's own module)."""
    p = _params(6)
    layer = PFNEncoderLayer(D, H, F)
    with torch.no_grad():
        layer.self_attn.in_proj_weight.copy_(torch.from_numpy(p["wqkv"].T))
        layer.self_attn.in_proj_bias.copy_(torch.from_numpy(p["bqkv"]))
        for name, w, b in (("self_attn.out_proj", "wout", "bout"), ("linear1", "w1", "b1"), ("linear2", "w2", "b2")):
            module = layer.get_submodule(name)
            module.weight.copy_(torch.from_numpy(p[w].T))
            module.bias.copy_(torch.from_numpy(p[b]))
        for i in (1, 2):
            layer.get_submodule(f"norm{i}").weight.copy_(torch.from_numpy(p[f"ln{i}_g"]))
            layer.get_submodule(f"norm{i}").bias.copy_(torch.from_numpy(p[f"ln{i}_b"]))
        x = torch.from_numpy(_x(3, 24, seed=7))
        _close(tfused.fused_encoder_layer(x, _torch(p), 10, H), layer(x, 10), F32_TOL)


def test_sep_as_tensor_matches_int():
    p, x = _torch(_params()), torch.from_numpy(_x(2, 16, seed=8))
    sep_t = torch.tensor([7], dtype=torch.int32)
    assert torch.equal(tfused.fused_encoder_layer(x, p, sep_t, H), tfused.fused_encoder_layer(x, p, 7, H))
