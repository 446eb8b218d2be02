"""The port's fused-layer backward at the tile edges of its bf16 GEMM.

The backward's bf16 products run on csrc/pfn_gemm_sm90.cuh: 128-row output
tiles, 128 columns (64 for the attention products at head dims up to 64)
and 64-deep K tiles, with the TMA unit's zero fill past every edge. On CPU
tensors the port runs ``fused_layer_bwd_plain``, which chip_smoke.py holds
the kernels against on the card; here that plain version meets the JAX
package's ``_bwd_call`` (its Pallas kernels in interpret mode, as
tests/test_fused_layer.py runs them) at shapes that straddle those edges:
D 64 and F 96 (K and N crossing 64), head dim 16 (D 32, H 2), and T 63, 64
and 65 (the attention products' K tiles), in f32 and bf16. The same numpy
x, params and dy go to both sides, r and lse from the JAX forward.

Tolerances are tests/test_torch_port_fused_bwd.py's: f32 atol = rtol = 3e-4
(summation order); bf16 each gradient's max error at most 1e-2 of its
largest entry (a summation-order difference that flips one bf16 rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.ops import fused_layer as jfused
from pfn_tpu_torch.ops import _ext
from pfn_tpu_torch.ops import fused_layer as tfused

F32_TOL, BF16_REL_TOL = 3e-4, 1e-2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (D, H, F, B, T, sep)
EDGES = [
    (64, 2, 96, 1, 63, 31),
    (64, 2, 96, 2, 64, 0),
    (64, 2, 96, 1, 65, 65),
    (32, 2, 48, 2, 24, 10),
    (32, 2, 48, 1, 65, 64),
]


def _params(D, F, seed):
    """Random layer weights in the JAX layout: matrices N(0, 1/fan_in),
    biases N(0, 0.3^2), LayerNorm scales 1 + N(0, 0.3^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in _ext.fused_param_shapes(D, F).items():
        a = rng.standard_normal(shape)
        out[k] = (a / np.sqrt(shape[0]) if len(shape) == 2 else 0.3 * a + (1.0 if k.endswith("_g") else 0.0))
        out[k] = out[k].astype(np.float32)
    return out


def _check(got, want, dtype_name, name):
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, name
    if dtype_name == "f32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL, err_msg=name)
    else:
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        assert err <= BF16_REL_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("D,H,F,B,T,sep", EDGES)
def test_plain_backward_matches_jax_at_gemm_edges(D, H, F, B, T, sep, dtype_name):
    """dx and all 12 parameter gradients of fused_layer_bwd_plain against
    _bwd_call, from the same x, p, sep, r, lse and dy."""
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(1000 * D + T + sep)
    p = _params(D, F, seed=D + T)
    x, dy = (rng.standard_normal((B, T, D)).astype(np.float32) for _ in range(2))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _, r, lse = (np.array(a) for a in jfused._fwd_call(jnp.asarray(x), jp, sep, H, jdt, True))
    jdx, jdp = jfused._bwd_call(jnp.asarray(x), jp, sep, jnp.asarray(r), jnp.asarray(lse), jnp.asarray(dy), H, jdt,
                                True)
    dx, dp = tfused.fused_layer_bwd_plain(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, sep,
                                          torch.from_numpy(r), torch.from_numpy(lse), torch.from_numpy(dy), H, tdt)
    _check(dx, jdx, dtype_name, "dx")
    for k in p:
        assert dp[k].dtype == torch.float32, k
        _check(dp[k], jdp[k], dtype_name, k)


@pytest.mark.parametrize("Kin,N,splits", [(1024, 512, 4), (512, 1024, 4), (512, 512, 8), (512, 1536, 2)])
def test_weight_grad_splits_fill_one_wave_at_the_flagship(Kin, N, splits):
    """At the bench.py flagship (B 64 x T 100 rows) on 132 SMs each weight
    gradient's 128 x 128 tiles times its chunks fill at most one wave."""
    assert _ext.weight_grad_splits(6400, Kin, N, 132) == splits
    assert -(-Kin // 128) * -(-N // 128) * splits <= 132


def test_weight_grad_splits_small_and_wide():
    """Fewer than 512 rows give one chunk; more tiles than SMs give one."""
    assert _ext.weight_grad_splits(300, 64, 96, 132) == 1
    assert _ext.weight_grad_splits(100_000, 4096, 4096, 132) == 1
    assert _ext.weight_grad_splits(100_000, 64, 64, 132) == 16
