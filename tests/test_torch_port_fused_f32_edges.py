"""The port's fused layer in f32 at the tile edges of its f32 GEMM.

Every f32 product of the fused layer's forward and backward runs on the
register-tiled FMA GEMM of csrc/pfn_fused_common.cuh: 128 x 128 output tiles
over 16-deep K tiles, with zeros past every edge, and column sums over each
128-row tile in the backward. On CPU tensors the port runs
``fused_layer_fwd_plain`` and ``fused_layer_bwd_plain``, which chip_smoke.py
holds the kernels against on the card; here those plain versions meet the
JAX package's ``_fwd_call`` and ``_bwd_call`` (their Pallas kernels in
interpret mode, as tests/test_fused_layer.py runs them) in f32 at shapes
that straddle those edges and that tests/test_torch_port_fused_{fwd,bwd}
_edges.py do not: M = B*T one short of, at and one past 128 rows; N = D, F
and 3D crossing 128 columns (D 144 and F 272, D 112 and F 240), or on them
(D 128, F 128, head dim 128); and T 15, 16 and 17 against the K step of
the attention products (dq = ds K, dk, dv: K = T). The same numpy x, params
and dy go to both sides, r and lse from the JAX forward.

Tolerances are tests/test_fused_layer.py's in f32: the forward's y, r and
lse at atol = rtol = 3e-5, dx and the 12 gradients at 3e-4 (both sides
compute in f32 and differ only in summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.ops import fused_layer as jfused
from pfn_tpu_torch.ops import _ext
from pfn_tpu_torch.ops import fused_layer as tfused

FWD_TOL, BWD_TOL = 3e-5, 3e-4
# (D, H, F, B, T, sep)
EDGES = [
    (144, 9, 272, 1, 127, 100),  # M 127; N 144, 272, 432 past 128-column tiles
    (144, 9, 272, 2, 64, 64),  # M 128; sep = T
    (112, 7, 240, 1, 129, 17),  # M 129; N 112, 240, 336 short of a tile
    (128, 1, 128, 3, 17, 16),  # T 17 past the K step; N = 128; head dim 128
    (128, 1, 128, 1, 16, 0),  # T 16 on the K step; sep 0
    (112, 7, 240, 2, 15, 7),  # T 15 short of the K step
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small torch ops: one intra-op thread, as the other port files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _inputs(D, F, B, T, sep):
    rng = np.random.default_rng(1000 * D + T + sep)
    x, dy = (rng.standard_normal((B, T, D)).astype(np.float32) for _ in range(2))
    return _params(D, F, seed=D + T), x, dy


@pytest.mark.parametrize("D,H,F,B,T,sep", EDGES)
def test_plain_forward_matches_jax_at_f32_gemm_edges(D, H, F, B, T, sep):
    """y, r and lse of fused_layer_fwd_plain in f32 against _fwd_call."""
    p, x, _ = _inputs(D, F, B, T, sep)
    want = jfused._fwd_call(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, sep, H, jnp.float32, True)
    got = tfused.fused_layer_fwd_plain(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, sep, H,
                                       torch.float32)
    for name, a, b in zip(("y", "r", "lse"), got, want):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=FWD_TOL, rtol=FWD_TOL, err_msg=name)


@pytest.mark.parametrize("D,H,F,B,T,sep", EDGES)
def test_plain_backward_matches_jax_at_f32_gemm_edges(D, H, F, B, T, sep):
    """dx and all 12 parameter gradients of fused_layer_bwd_plain in f32
    against _bwd_call, from the same x, p, sep, r, lse and dy."""
    p, x, dy = _inputs(D, F, B, T, sep)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _, r, lse = (np.array(a) for a in jfused._fwd_call(jnp.asarray(x), jp, sep, H, jnp.float32, True))
    jdx, jdp = jfused._bwd_call(jnp.asarray(x), jp, sep, jnp.asarray(r), jnp.asarray(lse), jnp.asarray(dy), H,
                                jnp.float32, True)
    dx, dp = tfused.fused_layer_bwd_plain(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, sep,
                                          torch.from_numpy(r), torch.from_numpy(lse), torch.from_numpy(dy), H,
                                          torch.float32)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=BWD_TOL, rtol=BWD_TOL, err_msg="dx")
    for k in p:
        assert dp[k].dtype == torch.float32, k
        np.testing.assert_allclose(dp[k].numpy(), np.asarray(jdp[k]), atol=BWD_TOL, rtol=BWD_TOL, err_msg=k)


# The f32 GEMM's split counts at the bench.py flagship (B 64 x T 100 rows):
# (Kin, N) of dW2, dW1, dWout, dWqkv and the chunks each gets on 132 SMs.
F32_FLAGSHIP_SPLITS = [(1024, 512, 8), (512, 1024, 8), (512, 512, 16), (512, 1536, 5)]


@pytest.mark.parametrize("Kin,N,splits", F32_FLAGSHIP_SPLITS)
def test_f32_weight_grad_splits_fill_one_wave_at_the_flagship(Kin, N, splits):
    """Each f32 weight gradient's output tiles times its chunks fill at most
    one wave of the f32 GEMM: F32_GEMM_BLOCKS_PER_SM blocks on each of 132
    SMs, and more than half of it."""
    slots = 132 * _ext.F32_GEMM_BLOCKS_PER_SM
    got = _ext.weight_grad_splits(6400, Kin, N, slots)
    assert got == splits
    tiles = -(-Kin // _ext.WGRAD_TILE) * -(-N // _ext.WGRAD_TILE)
    assert slots // 2 < tiles * got <= slots


def test_f32_weight_grad_splits_differ_from_bf16_only_by_slots():
    """Both dtypes' GEMMs have 128 x 128 tiles; the f32 one holds two blocks
    an SM, so at the flagship dW2 gets twice the bf16 count's chunks."""
    assert _ext.weight_grad_splits(6400, 1024, 512, 132) == 4
    assert _ext.weight_grad_splits(6400, 1024, 512, 132 * _ext.F32_GEMM_BLOCKS_PER_SM) == 8
