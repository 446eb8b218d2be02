"""Shared inputs and the JAX side of the flash-attention parity tests
(tests/test_torch_port_flash_bwd*.py, tests/test_torch_port_flash_edges.py,
tests/test_torch_port_flash_dkv_edges.py).
Tolerance: atol = rtol = 1e-4, the gradient tolerance of
tests/test_flash_attention.py."""

import jax.numpy as jnp
import numpy as np
from jax.experimental.pallas import tpu as pltpu

import torch

from pfn_tpu.ops import flash_attention as jflash
from pfn_tpu_torch.ops import flash_attention as tflash

TOL = 1e-4
D = 32
CASES = [(T, sep) for T in (100, 129, 256) for sep in sorted({0, 1, T // 2, T - 1})]
# The edges of the sm_90a kernels' 128-row query tiles and 128-key (forward)
# or 64-key (dq) KV tiles: one row or key past a tile, one short of it.
EDGE_CASES = [(T, sep) for T in (255, 257) for sep in (127, 128, 129)]


def close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=TOL, err_msg=name)


def pad(x, t):
    return np.pad(x, [(0, 0), (0, t - x.shape[1])] + [(0, 0)] * (x.ndim - 2))


def inputs(BH, Tq, Tk, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((BH, Tq, D)) / np.sqrt(D)).astype(np.float32)  # already scaled
    k, v = (rng.standard_normal((BH, Tk, D)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((BH, Tq, D)).astype(np.float32)
    dlse = rng.standard_normal((BH, Tq)).astype(np.float32)
    return q, k, v, do, dlse


def jax_fwd_bwd(q, k, v, do, dlse, sep, include_diag):
    """The JAX forward and backward implementations on their padded layout,
    sliced back: (o, lse, dq, dk, dv)."""
    BH, Tq, _ = q.shape
    Tk = k.shape[1]
    block = jflash._choose_block(BH, max(Tq, Tk))
    Tqp, Tkp = -(-Tq // block) * block, -(-Tk // block) * block
    qp, dop = jnp.asarray(pad(q, Tqp)), jnp.asarray(pad(do, Tqp))
    kp, vp = jnp.asarray(pad(k, Tkp)), jnp.asarray(pad(v, Tkp))
    dlse_p = None if dlse is None else jnp.asarray(pad(dlse[..., None], Tqp))
    with pltpu.force_tpu_interpret_mode():
        o, lse = jflash._fwd_impl(qp, kp, vp, sep, Tk, include_diag=include_diag)
        dq, dk, dv = jflash._bwd_impl(qp, kp, vp, o, lse, sep, Tk, dop, dlse_p, include_diag)
    o, lse, dq, dk, dv = (np.asarray(a) for a in (o, lse, dq, dk, dv))
    return o[:, :Tq], lse[:, :Tq, 0], dq[:, :Tq], dk[:, :Tk], dv[:, :Tk]


def check_plain_backward(T, sep, include_diag, Tq=None):
    """The port's plain backward against the JAX ``_bwd_impl`` on the same
    inputs and the same forward o and lse; the prefix variant with Tq != Tk
    (T // 2 + 1 unless given) and a nonzero dlse. A row or key with nothing
    allowed gets exactly 0."""
    seed = 10 * T + sep + include_diag + (0 if Tq is None else 1000 * Tq)
    Tq = T if include_diag else Tq or T // 2 + 1
    q, k, v, do, dlse = inputs(2, Tq, T, seed=seed)
    dlse = None if include_diag else dlse
    o, lse, *want = jax_fwd_bwd(q, k, v, do, dlse, sep, include_diag)
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do)]
    got = tflash._flash_bwd_plain(*t, None if dlse is None else torch.from_numpy(dlse), sep, T, include_diag)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        close(g, w, name)
    if sep == 0 and not include_diag:
        assert all(bool((g == 0).all()) for g in got)
    # The port's own forward gives the same o and lse.
    o_t, lse_t = tflash._flash_fwd_plain(*t[:3], sep, T, include_diag)
    close(o_t, o, "o")
    if sep > 0 or include_diag:
        close(lse_t, lse, "lse")


def qkv4(B, H, Tq, Tk, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Tq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, Tk, D)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal((B, H, Tq, D)).astype(np.float32)
    return q, k, v, w
