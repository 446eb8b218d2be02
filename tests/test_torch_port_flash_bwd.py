"""Parity of the port's PFN flash-attention backward with the JAX package:
the diagonal variant (the PFN rule). The prefix variant is in
tests/test_torch_port_flash_bwd_prefix.py.

The port's plain backward (``_flash_bwd_plain``, the gold its CUDA kernels
are held to on the card) against the JAX ``_bwd_impl``, whose two Pallas
kernels run in interpret mode as tests/test_flash_attention.py runs them;
then autograd through the port's ``pfn_flash_attention`` (its
``autograd.Function`` on the plain path) against ``jax.grad`` through the
JAX wrapper. Inputs come from a numpy seed; the JAX side works on a layout
padded to its block and is sliced back to T. Tolerance: atol = rtol = 1e-4,
the gradient tolerance of tests/test_flash_attention.py; both sides compute
in f32 and differ only in summation order.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_port_flash_cases import CASES, check_plain_backward, close, qkv4

from pfn_tpu.ops import flash_attention as jflash
from pfn_tpu_torch.ops import flash_attention as tflash


@pytest.mark.parametrize("T,sep", CASES)
def test_plain_backward_matches_jax_bwd_impl(T, sep):
    check_plain_backward(T, sep, include_diag=True)


@pytest.mark.parametrize("T,sep", [(100, 0), (129, 1), (129, 50), (256, 255)])
def test_autograd_matches_jax_grad(T, sep):
    """Gradients of sum(w * o) through the wrappers; the scale on q reaches
    dq through autograd, as in the JAX package."""
    q, k, v, w = qkv4(1, 2, T, T, seed=T + sep)

    def loss_jax(q, k, v):
        return jnp.sum(jnp.asarray(w) * jflash.pfn_flash_attention(q, k, v, jnp.asarray(sep)))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss_jax, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    loss = (torch.from_numpy(w) * tflash.pfn_flash_attention(*leaves, sep)).sum()
    for name, g, wnt in zip(("dq", "dk", "dv"), torch.autograd.grad(loss, leaves), want):
        close(g, wnt, name)


def test_sep_tensor_gradient_equals_int():
    """sep as a one-element tensor (what the training loop passes) gives the
    gradient of the int."""
    q, k, v, w = qkv4(1, 2, 60, 60, seed=3)
    grads = []
    for sep in (23, torch.tensor([23], dtype=torch.int32)):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        loss = (torch.from_numpy(w) * tflash.pfn_flash_attention(*leaves, sep)).sum()
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
