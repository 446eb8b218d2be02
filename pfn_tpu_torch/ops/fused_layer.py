"""Fused PFN encoder layer, forward: the hand-written Hopper kernel and its
plain version.

Port of the forward side of ``pfn_tpu/ops/fused_layer.py``: one whole
post-LN encoder layer (qkv projection -> PFN attention -> out projection ->
residual -> LN1 -> FFN with tanh GELU -> residual -> LN2) in one call. On a
CUDA tensor :func:`fused_layer_fwd` launches ``csrc/pfn_fused_layer_fwd.cu``;
on a CPU tensor it runs :func:`fused_layer_fwd_plain`, which is also the gold
that ``chip_smoke.py`` holds the kernel against.

Numerics are the TPU kernel's (``_fwd_kernel``), which round to the compute
dtype at other places than ``models.transformer.PFNEncoderLayer``: qkv after
its f32 bias add, the head outputs, and ao before the f32 residual; q and k
enter the scores as f32, p = e / l is rounded before P.V, h1 and f stay f32,
both LayerNorms are f32. Every product accumulates in f32. Parameters use the
JAX package's layout: wqkv (D, 3D), bqkv (3D,), wout (D, D), bout (D,),
ln1_g/ln1_b (D,), w1 (D, F), b1 (F,), w2 (F, D), b2 (D,), ln2_g/ln2_b (D,).

The backward kernels (the JAX package's ``_bwd_ffn_kernel`` and
``_bwd_attn_kernel``) are not ported yet: on a CPU tensor autograd goes
through the plain version, on a CUDA tensor the backward raises.
"""

from __future__ import annotations

import torch

from pfn_tpu_torch.ops import _ext
from pfn_tpu_torch.ops.flash_attention import _sep_tensor

_EPS = 1e-5  # torch nn.LayerNorm default
_GELU_C = 0.7978845608028654  # sqrt(2/pi)
_GELU_A = 0.044715


def _gelu(x):
    """tanh-approximate GELU, f32."""
    u = _GELU_C * (x + _GELU_A * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(u))


def _ln_fwd(r1):
    """f32 LayerNorm: (normalized activations, rstd), eps inside the rsqrt."""
    mu = r1.mean(dim=-1, keepdim=True)
    c = r1 - mu
    var = (c * c).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + _EPS)
    return c * rstd, rstd


def _mm(a, b):
    """Matrix product with f32 accumulation: the operands' values (bf16 or f32)
    multiplied in f32, as ``preferred_element_type=f32`` does."""
    return torch.matmul(a.float(), b.float())


def _attn_plain(qkv, sep, nhead: int, dtype):
    """PFN attention for (B, T, 3D) qkv in ``dtype``, all heads (the JAX
    package's ``_attn_item``). Returns (attn (B, T, D) in dtype, lse (B, T, H)
    f32)."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    dh = D // nhead
    heads = qkv.reshape(B, T, 3, nhead, dh)
    q = heads[:, :, 0].transpose(1, 2).float() * (1.0 / dh**0.5)  # (B, H, T, dh)
    k = heads[:, :, 1].transpose(1, 2).float()
    v = heads[:, :, 2].transpose(1, 2)
    rows = torch.arange(T, device=qkv.device)[:, None]
    cols = torch.arange(T, device=qkv.device)[None, :]
    allowed = (cols < sep) | (cols == rows)
    s = torch.where(allowed, torch.matmul(q, k.transpose(-1, -2)), torch.full((), -1e30, device=qkv.device))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(allowed, torch.exp(s - m), torch.zeros((), device=qkv.device))
    l = e.sum(dim=-1, keepdim=True)
    p = e / l
    o = _mm(p.to(dtype), v).to(dtype)  # (B, H, T, dh)
    lse = (m + torch.log(l))[..., 0]  # (B, H, T)
    return o.transpose(1, 2).reshape(B, T, D), lse.transpose(1, 2)


def fused_layer_fwd_plain(x, p: dict, sep, nhead: int, dtype=torch.float32):
    """The plain PyTorch version of the TPU kernel ``_fwd_kernel``.

    x: (B, T, D), any float dtype; ``p`` in the JAX layout (module docstring);
    ``dtype`` the compute dtype. Returns (y, r, lse): the post-LN2 and post-LN1
    activations (B, T, D) and the attention logsumexp (B, T, H), all f32.
    Differentiable.
    """
    xf = x.float()
    qkv = (_mm(x.to(dtype), p["wqkv"].to(dtype)) + p["bqkv"].float()).to(dtype)
    attn, lse = _attn_plain(qkv, sep, nhead, dtype)
    ao = (_mm(attn, p["wout"].to(dtype)) + p["bout"].float()).to(dtype)
    xhat1, _ = _ln_fwd(xf + ao.float())
    r = xhat1 * p["ln1_g"].float() + p["ln1_b"].float()
    h1 = _mm(r.to(dtype), p["w1"].to(dtype)) + p["b1"].float()
    g = _gelu(h1).to(dtype)
    f = _mm(g, p["w2"].to(dtype)) + p["b2"].float()
    xhat2, _ = _ln_fwd(r + f)
    y = xhat2 * p["ln2_g"].float() + p["ln2_b"].float()
    return y, r, lse


def _kernel_params(p: dict, dtype) -> dict:
    """``p`` as the kernel takes it: the four matrices pre-cast to the compute
    dtype (as the JAX package's ``_fwd_call`` does), the vectors f32, all
    contiguous."""
    return {k: (p[k].to(dtype) if k in _ext.FUSED_MATRICES else p[k].float()).contiguous()
            for k in _ext.FUSED_PARAM_ORDER}


def fused_layer_fwd(x, p: dict, sep, nhead: int, dtype=torch.float32):
    """(y, r, lse) of one layer, as the JAX package's ``_fwd_call`` returns
    them: the kernel on a CUDA tensor, the plain version on a CPU tensor.
    Not differentiable; :func:`fused_encoder_layer` is."""
    if not x.is_cuda:
        return fused_layer_fwd_plain(x, p, sep, nhead, dtype)
    return _ext.fused_layer_fwd(x.float().contiguous(), _kernel_params(p, dtype), _sep_tensor(sep, x.device), nhead)


class _FusedLayer(torch.autograd.Function):
    """The JAX package's ``fused_encoder_layer`` custom VJP, forward side."""

    @staticmethod
    def forward(ctx, x, sep, nhead, dtype, *params):
        y, _, _ = fused_layer_fwd(x, dict(zip(_ext.FUSED_PARAM_ORDER, params)), sep, nhead, dtype)
        ctx.save_for_backward(x, sep, *params)
        ctx.nhead, ctx.dtype = nhead, dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, sep, *params = ctx.saved_tensors
        if x.is_cuda:
            raise NotImplementedError(
                "the fused layer's backward kernels are not ported yet (ROADMAP.md queue 2 items 5-6); "
                "train with attention_impl='auto' or 'flash'"
            )
        needs = (ctx.needs_input_grad[0], *ctx.needs_input_grad[4:])
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip((x, *params), needs)]
            y, _, _ = fused_layer_fwd_plain(leaves[0], dict(zip(_ext.FUSED_PARAM_ORDER, leaves[1:])), sep,
                                            ctx.nhead, ctx.dtype)
            grads = iter(torch.autograd.grad(y, [t for t in leaves if t.requires_grad], dy))
        dx, *dparams = [next(grads) if need else None for need in needs]
        return (dx, None, None, None, *dparams)


def fused_encoder_layer(x, p: dict, single_eval_pos, nhead: int, dtype=torch.float32):
    """One PFN encoder layer, fully fused; the JAX package's signature.

    x: (B, T, D), any float dtype; ``p`` in the JAX layout (module
    docstring); ``dtype`` the compute dtype of the products (LayerNorms stay
    f32). Returns the post-LN2 activations, f32 (B, T, D). On a CUDA tensor
    the forward launches the kernel and the backward raises; on a CPU tensor
    both run the plain version.
    """
    sep = _sep_tensor(single_eval_pos, x.device)
    return _FusedLayer.apply(x, sep, nhead, dtype, *(p[k] for k in _ext.FUSED_PARAM_ORDER))
