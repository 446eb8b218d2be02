"""Parity of the port's PFN attention (pfn_tpu_torch.ops) with the JAX package.

Inputs come from a numpy seed and go to both packages. The JAX Pallas flash
kernel runs in interpret mode, as tests/test_flash_attention.py runs it; the
port's flash wrappers run their plain version on CPU tensors (the CUDA kernel
itself is checked against that plain version on the card by chip_smoke.py).

Tolerance: 2e-5 (atol and rtol) everywhere, the f32 tolerance of
tests/test_flash_attention.py: both sides compute in f32 and differ only in
summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pfn_tpu.ops import attention as jattn
from pfn_tpu.ops import flash_attention as jflash
from pfn_tpu_torch.ops import attention as tattn
from pfn_tpu_torch.ops import flash_attention as tflash

TOL = 2e-5
CASES = [(T, sep) for T in (100, 129, 256) for sep in sorted({0, 1, T // 2, T - 1})]


def _qkv(T, B=1, H=2, D=128, Tq=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Tq or T, D)).astype(np.float32)
    k = rng.standard_normal((B, H, T, D)).astype(np.float32)
    v = rng.standard_normal((B, H, T, D)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("T,sep", CASES)
def test_dense_reference_matches_jax(T, sep):
    q, k, v = _qkv(T, seed=T + sep)
    want = jattn.pfn_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sep)
    _close(tattn.pfn_attention_reference(*_t(q, k, v), sep), want)
    np.testing.assert_array_equal(tattn.pfn_mask(T, sep).numpy(), np.asarray(jattn.pfn_mask(T, sep)))


@pytest.mark.parametrize("T,sep", CASES)
def test_flash_matches_jax_pallas_interpret(T, sep):
    """Diagonal variant: o from the public wrappers, lse from the forward
    implementations (the JAX side on the padded layout it uses)."""
    q, k, v = _qkv(T, seed=2 * T + sep)
    qj, kj, vj = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    with pltpu.force_tpu_interpret_mode():
        want_o = jflash.pfn_flash_attention(qj, kj, vj, jnp.asarray(sep))
        block = jflash._choose_block(2, T)
        Tp = -(-T // block) * block
        scale = 1.0 / np.sqrt(q.shape[-1])
        _, want_lse = jflash._fwd_impl(
            jflash._pad((qj * scale).reshape(2, T, 128), Tp),
            jflash._pad(kj.reshape(2, T, 128), Tp),
            jflash._pad(vj.reshape(2, T, 128), Tp),
            sep, T, include_diag=True,
        )
    qt, kt, vt = _t(q, k, v)
    _close(tflash.pfn_flash_attention(qt, kt, vt, sep), want_o)
    _, lse = tflash._flash_fwd((qt * scale).reshape(2, T, 128), kt.reshape(2, T, 128), vt.reshape(2, T, 128),
                               sep, include_diag=True)
    _close(lse, np.asarray(want_lse)[:, :T, 0])


@pytest.mark.parametrize("T,sep", CASES)
def test_prefix_flash_matches_jax_pallas_interpret(T, sep):
    """Prefix variant, with Tq != Tk: o and lse, including o = 0 and
    lse ~ -1e30 for sep = 0."""
    Tq = T // 2 + 1
    q, k, v = _qkv(T, Tq=Tq, seed=3 * T + sep)
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jflash.pfn_flash_prefix_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sep)
        )
    o, lse = tflash.pfn_flash_prefix_attention(*_t(q, k, v), sep)
    _close(o, want_o)
    _close(lse, want_lse)
    ref_o, ref_lse = tattn.pfn_prefix_attention_reference(*_t(q, k, v), sep)
    _close(ref_o, want_o)
    _close(ref_lse, want_lse)
    if sep == 0:
        assert bool((o == 0).all()) and bool((lse <= -1e29).all())


@pytest.mark.parametrize("sep", [0, 1, 37, 99])
def test_prefix_merge_equals_pfn_rule(sep):
    """The exact logsumexp self-merge gives the dense PFN rule, as the JAX
    merge does."""
    q, k, v = _qkv(100, B=2, D=32, seed=sep)
    qt, kt, vt = _t(q, k, v)
    merged = tattn.pfn_attention_prefix_merge(qt, kt, vt, kt, vt, sep, 0)
    _close(merged, tattn.pfn_attention_reference(qt, kt, vt, sep))
    want = jattn.pfn_attention_prefix_merge(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(k), jnp.asarray(v), sep, 0
    )
    _close(merged, want)
    _close(tattn.pfn_attention(qt, kt, vt, sep, impl="prefix"), want)


def test_dispatch_on_cpu():
    """auto runs the dense path on a CPU tensor; flash raises; fused is auto,
    as pfn_tpu/ops/attention.py:246-250 makes it."""
    q, k, v = _t(*_qkv(40, D=32))
    _close(tattn.pfn_attention(q, k, v, 17), tattn.pfn_attention_reference(q, k, v, 17))
    _close(tattn.pfn_attention(q, k, v, 17, impl="dense"), tattn.pfn_attention_reference(q, k, v, 17))
    with pytest.raises(RuntimeError, match="CUDA"):
        tattn.pfn_attention(q, k, v, 17, impl="flash")
    assert torch.equal(tattn.pfn_attention(q, k, v, 17, impl="fused"), tattn.pfn_attention(q, k, v, 17))
    want = jattn.pfn_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), 17, impl="fused")
    _close(tattn.pfn_attention(q, k, v, 17, impl="fused"), want)
    with pytest.raises(ValueError):
        tattn.pfn_attention(q, k, v, 17, impl="nope")


def test_sep_as_tensor_matches_int():
    """sep may be a one-element tensor (the kernel reads it from memory)."""
    q, k, v = _t(*_qkv(50, D=32))
    sep_t = torch.tensor([23], dtype=torch.int32)
    _close(tattn.pfn_attention_reference(q, k, v, sep_t), tattn.pfn_attention_reference(q, k, v, 23))
    _close(tflash.pfn_flash_attention(q, k, v, sep_t), tattn.pfn_attention_reference(q, k, v, 23))
