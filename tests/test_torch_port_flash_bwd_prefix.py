"""Parity of the port's PFN flash-attention backward with the JAX package:
the prefix variant (keys < sep, no diagonal; Tq may differ from Tk; lse is a
differentiable output). Protocol and tolerance as in
tests/test_torch_port_flash_bwd.py: atol = rtol = 1e-4."""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_port_flash_cases import CASES, check_plain_backward, close, qkv4

from pfn_tpu.ops import flash_attention as jflash
from pfn_tpu_torch.ops import attention as tattn
from pfn_tpu_torch.ops import flash_attention as tflash


@pytest.mark.parametrize("T,sep", CASES)
def test_plain_backward_matches_jax_bwd_impl(T, sep):
    """Tq = T//2 + 1 queries against T keys, with a nonzero dlse."""
    check_plain_backward(T, sep, include_diag=False)


@pytest.mark.parametrize("Tq,T,sep", [(65, 129, 0), (65, 129, 70), (100, 100, 37), (128, 256, 200)])
def test_autograd_with_lse_matches_jax_grad(Tq, T, sep):
    """Gradients of sum(w * o) + sum(tanh(lse)) through the wrappers."""
    q, k, v, w = qkv4(1, 2, Tq, T, seed=Tq + T + sep)

    def loss_jax(q, k, v):
        o, lse = jflash.pfn_flash_prefix_attention(q, k, v, jnp.asarray(sep))
        return jnp.sum(jnp.asarray(w) * o) + jnp.sum(jnp.tanh(lse))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss_jax, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = tflash.pfn_flash_prefix_attention(*leaves, sep)
    loss = (torch.from_numpy(w) * o).sum() + torch.tanh(lse).sum()
    for name, g, wnt in zip(("dq", "dk", "dv"), torch.autograd.grad(loss, leaves), want):
        close(g, wnt, name)


def test_prefix_merge_gradient_equals_pfn_rule():
    """impl='prefix' (prefix pass + exact self merge) differentiates to the
    dense PFN rule's gradient, through the prefix pass's lse."""
    q, k, v, w = qkv4(2, 2, 90, 90, seed=9)
    grads = []
    for impl in ("prefix", "dense"):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        loss = (torch.from_numpy(w) * tattn.pfn_attention(*leaves, 41, impl=impl)).sum()
        grads.append(torch.autograd.grad(loss, leaves))
    for name, a, b in zip(("dq", "dk", "dv"), *grads):
        close(a, b, name)
