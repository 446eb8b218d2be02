"""The port's fused-layer forward at the tile edges of its bf16 kernels.

The forward's bf16 body runs its four products on csrc/pfn_gemm_sm90.cuh
(128-row output tiles of 128 columns over 64-deep K tiles) and its attention
on attn_fwd_sm90 (csrc/pfn_fused_layer.cuh: 64 query rows a block, 64-key
tiles, the head dim zero-filled up to a 64-column panel), with the TMA
unit's zero fill past every edge. On CPU tensors the port runs
``fused_layer_fwd_plain``, which chip_smoke.py holds the kernels against on
the card; here that plain version meets the JAX package's ``_fwd_call`` (its
Pallas kernel in interpret mode, as tests/test_fused_layer.py runs it) at
shapes that straddle those edges: D 64 and F 96 (K and N crossing 64), head
dim 16 (D 32, H 2), T 63, 64 and 65 (the query and key tiles), B*T = 2 * 128
+- 1 (the GEMM's row tiles), and sep 0, sep = T and sep inside a diagonal key
tile, in f32 and bf16. The same numpy x and params go to both sides.

Tolerances are tests/test_torch_port_fused_layer.py's, on y, r and lse: f32
atol = rtol = 3e-5 (both sides compute in f32 and differ only in summation
order); bf16 atol = rtol = 1e-2 (both round to bf16 at the same places, and
differ where a summation-order difference flips one bf16 rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.ops import fused_layer as jfused
from pfn_tpu_torch.ops import _ext
from pfn_tpu_torch.ops import fused_layer as tfused

TOLS = {"f32": 3e-5, "bf16": 1e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (D, H, F, B, T, sep)
EDGES = [
    (64, 2, 96, 1, 63, 31),  # sep inside the only (diagonal) key tile
    (64, 2, 96, 2, 64, 0),  # one whole tile, the diagonal only
    (64, 2, 96, 1, 65, 65),  # one row past a tile, sep = T
    (64, 2, 96, 3, 85, 70),  # B*T = 255; sep inside the second block's diagonal tile
    (32, 2, 48, 1, 257, 257),  # head dim 16, B*T = 257, sep = T
    (32, 2, 48, 2, 65, 0),  # head dim 16, sep 0
    (32, 2, 48, 1, 63, 40),  # head dim 16, sep inside the diagonal tile
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


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("D,H,F,B,T,sep", EDGES)
def test_plain_forward_matches_jax_at_kernel_edges(D, H, F, B, T, sep, dtype_name):
    """y, r and lse of fused_layer_fwd_plain against _fwd_call, from the
    same x, p and sep."""
    jdt, tdt = DTYPES[dtype_name]
    tol = TOLS[dtype_name]
    p = _params(D, F, seed=D + T)
    x = np.random.default_rng(1000 * D + T + sep).standard_normal((B, T, D)).astype(np.float32)
    want = jfused._fwd_call(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, sep, H, jdt, True)
    got = tfused.fused_layer_fwd_plain(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, sep, H,
                                       tdt)
    for name, a, b in zip(("y", "r", "lse"), got, want):
        b = np.asarray(b, dtype=np.float32)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=tol, rtol=tol, err_msg=name)
