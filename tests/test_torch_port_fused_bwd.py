"""Parity of the port's fused-layer backward (pfn_tpu_torch.ops.fused_layer)
with the JAX package's ``_bwd_call``, whose two Pallas kernels
(``_bwd_ffn_kernel``, ``_bwd_attn_kernel``) run in interpret mode as
tests/test_fused_layer.py runs them. On CPU tensors the port runs
``fused_layer_bwd_plain`` (the CUDA kernels are held against that plain
version on the card by chip_smoke.py). The same numpy x, params and dy go to
both sides, with r and lse from the JAX forward at the same compute dtype.

Tolerances:
  * f32: atol = rtol = 3e-4, tests/test_fused_layer.py's for the fused
    gradients: both sides compute in f32 and differ in summation order (the
    port sums the weight gradients over the whole batch at once, the TPU
    kernel item by item).
  * bf16: each gradient's max error at most 1e-2 of its largest entry. Both
    sides round to bf16 at the same places (qkv, p, the head outputs, ao, rc,
    g, dr2, dh1, the head output gradient, ds, dqkv), so they differ where an
    f32 summation-order difference flips one bf16 rounding, 2^-8 (~4e-3) of
    that value, before the flip's effect is summed into a gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.ops import fused_layer as jfused
from pfn_tpu_torch.ops import _ext
from pfn_tpu_torch.ops import fused_layer as tfused

D, H, F = 64, 2, 96  # tests/test_torch_port_fused_layer.py's width
CASES = [(3, 24, 10), (4, 16, 0), (2, 16, 16), (1, 40, 39)]  # tests/test_fused_layer.py:74
SHAPES = _ext.fused_param_shapes(D, F)
F32_TOL, BF16_REL_TOL = 3e-4, 1e-2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _params(seed):
    """Random layer weights in the JAX layout: matrices N(0, 1/fan_in),
    biases N(0, 0.3^2), LayerNorm scales 1 + N(0, 0.3^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in SHAPES.items():
        a = rng.standard_normal(shape)
        out[k] = (a / np.sqrt(shape[0]) if len(shape) == 2 else 0.3 * a + (1.0 if k.endswith("_g") else 0.0))
        out[k] = out[k].astype(np.float32)
    return out


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _check(got, want, dtype_name, name):
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, name
    if dtype_name == "f32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL, err_msg=name)
    else:
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        assert err <= BF16_REL_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("B,T,sep", CASES)
def test_plain_backward_matches_jax_bwd_call(B, T, sep, dtype_name):
    """dx and all 12 parameter gradients of fused_layer_bwd_plain against
    the JAX package's _bwd_call, from the same x, p, sep, r, lse and dy."""
    jdt, tdt = DTYPES[dtype_name]
    p, x, dy = _params(B + T), _normal((B, T, D), seed=T + sep), _normal((B, T, D), seed=7 * T + sep)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _, r, lse = (np.array(a) for a in jfused._fwd_call(jnp.asarray(x), jp, sep, H, jdt, True))
    jdx, jdp = jfused._bwd_call(jnp.asarray(x), jp, sep, jnp.asarray(r), jnp.asarray(lse), jnp.asarray(dy), H, jdt,
                                True)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    dx, dp = tfused.fused_layer_bwd_plain(torch.from_numpy(x), tp, sep, torch.from_numpy(r), torch.from_numpy(lse),
                                          torch.from_numpy(dy), H, tdt)
    assert dx.dtype == torch.float32 and set(dp) == set(SHAPES)
    _check(dx, jdx, dtype_name, "dx")
    for k in SHAPES:
        assert dp[k].dtype == torch.float32 and tuple(dp[k].shape) == SHAPES[k], k
        _check(dp[k], jdp[k], dtype_name, k)


def test_bf16_autograd_matches_jax_grad():
    """Autograd through fused_encoder_layer in bf16 (the plain forward and
    backward on CPU tensors, f32 parameters cast inside) against jax.grad of
    the JAX fused_encoder_layer in interpret mode."""
    p, x = _params(11), _normal((2, 24, D), seed=12)
    w = _normal((2, 24, D), seed=13)
    sep = 9

    def loss(params, xx):
        y = jfused.fused_encoder_layer(xx, params, jnp.asarray(sep), H, jnp.bfloat16, True)
        return jnp.sum(jnp.asarray(w) * y)

    gp_want, gx_want = jax.grad(loss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (torch.from_numpy(w) * tfused.fused_encoder_layer(tx, tp, sep, H, torch.bfloat16)).sum().backward()
    _check(tx.grad, gx_want, "bf16", "dx")
    for k in SHAPES:
        assert tp[k].grad.dtype == torch.float32, k
        _check(tp[k].grad, gp_want[k], "bf16", k)


def test_backward_dispatch_on_cpu_is_the_plain_version():
    """fused_layer_bwd on CPU tensors returns fused_layer_bwd_plain's result
    bit for bit, and the autograd backward of fused_encoder_layer is it."""
    p = {k: torch.from_numpy(v) for k, v in _params(21).items()}
    x, dy = torch.from_numpy(_normal((2, 16, D), 22)), torch.from_numpy(_normal((2, 16, D), 23))
    _, r, lse = tfused.fused_layer_fwd(x, p, 6, H, torch.bfloat16)
    dx, dp = tfused.fused_layer_bwd(x, p, 6, r, lse, dy, H, torch.bfloat16)
    dx_plain, dp_plain = tfused.fused_layer_bwd_plain(x, p, 6, r, lse, dy, H, torch.bfloat16)
    assert torch.equal(dx, dx_plain) and all(torch.equal(dp[k], dp_plain[k]) for k in SHAPES)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xl = x.clone().requires_grad_()
    tfused.fused_encoder_layer(xl, leaves, 6, H, torch.bfloat16).backward(dy)
    assert torch.equal(xl.grad, dx) and all(torch.equal(leaves[k].grad, dp[k]) for k in SHAPES)
