"""Fused PFN encoder layer: the hand-written Hopper kernels and their plain
versions, forward and backward.

Port of ``pfn_tpu/ops/fused_layer.py``: one whole post-LN encoder layer
(qkv projection -> PFN attention -> out projection -> residual -> LN1 -> FFN
with tanh GELU -> residual -> LN2) in one call each way. On a CUDA tensor
:func:`fused_layer_fwd` launches ``csrc/pfn_fused_layer_fwd.cu`` and
:func:`fused_layer_bwd` the two entry points of ``csrc/pfn_fused_layer_bwd.cu``
(the FFN block, then the attention block, as the TPU kernels
``_bwd_ffn_kernel`` and ``_bwd_attn_kernel``); on a CPU tensor they run
:func:`fused_layer_fwd_plain` and :func:`fused_layer_bwd_plain`, which are
also the gold that ``chip_smoke.py`` holds the kernels against.

Numerics are the TPU kernels', which round to the compute dtype at other
places than ``models.transformer.PFNEncoderLayer``: qkv after its f32 bias
add, the head outputs, and ao before the f32 residual; q and k enter the
scores as f32, p = e / l is rounded before P.V, h1 and f stay f32, both
LayerNorms are f32. The backward takes the forward's saved r (post-LN1) and
lse, recomputes the rest (p = exp(s - lse)), and rounds the gradients that
enter a product (dr2, dh1, the head output gradient, ds, dqkv) to the
compute dtype. Every product accumulates in f32, and the weight and bias
gradients are f32 sums over the batch. Parameters use the JAX package's
layout: wqkv (D, 3D), bqkv (3D,), wout (D, D), bout (D,), ln1_g/ln1_b (D,),
w1 (D, F), b1 (F,), w2 (F, D), b2 (D,), ln2_g/ln2_b (D,); they enter in
their own dtype (f32 for a model's parameters) and the four matrices are
cast to the compute dtype inside, so their gradients come back f32.
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


def _gelu_grad(x):
    """Derivative of the tanh-approximate GELU, f32."""
    u = _GELU_C * (x + _GELU_A * x * x * x)
    t = torch.tanh(u)
    du = _GELU_C * (1.0 + 3.0 * _GELU_A * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du


def _ln_fwd(r1):
    """f32 LayerNorm: (normalized activations, rstd), eps inside the rsqrt."""
    mu = r1.mean(dim=-1, keepdim=True)
    c = r1 - mu
    var = (c * c).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + _EPS)
    return c * rstd, rstd


def _ln_bwd(dxh, xhat, rstd):
    """Gradient through the normalisation x -> xhat; ``dxh`` is the gradient
    with respect to xhat, already scaled by the LayerNorm's gain."""
    m1 = dxh.mean(dim=-1, keepdim=True)
    m2 = (dxh * xhat).mean(dim=-1, keepdim=True)
    return rstd * (dxh - m1 - xhat * m2)


def _mm(a, b):
    """Matrix product with f32 accumulation: the operands' values (bf16 or f32)
    multiplied in f32, as ``preferred_element_type=f32`` does."""
    return torch.matmul(a.float(), b.float())


def _mm_tn(a, b):
    """a^T b over every row of (B, T, X) and (B, T, Y): the (X, Y) f32 sum
    over the batch that a weight gradient is."""
    return _mm(a.reshape(-1, a.shape[-1]).t(), b.reshape(-1, b.shape[-1]))


def _row_sum(a):
    """Sum over every row of (B, T, X): the (X,) f32 sum over the batch that a
    bias or LayerNorm gradient is."""
    return a.float().reshape(-1, a.shape[-1]).sum(dim=0)


def _scores(qkv, sep, nhead: int):
    """Per-head q, k, v (B, H, T, dh) of (B, T, 3D) qkv, the masked f32
    scores (q * scale) k^T (-1e30 where the PFN rule forbids the key) and the
    (T, T) mask of allowed keys."""
    B, T, D3 = qkv.shape
    dh = D3 // 3 // nhead
    q, k, v = qkv.reshape(B, T, 3, nhead, dh).permute(2, 0, 3, 1, 4)
    rows = torch.arange(T, device=qkv.device)[:, None]
    cols = torch.arange(T, device=qkv.device)[None, :]
    allowed = (cols < sep) | (cols == rows)
    s = _mm(q.float() * (1.0 / dh**0.5), k.float().transpose(-1, -2))
    s = torch.where(allowed, s, torch.full((), -1e30, device=qkv.device))
    return q, k, v, s, allowed


def _merge_heads(o):
    """(B, H, T, dh) -> (B, T, H * dh)."""
    B, H, T, dh = o.shape
    return o.transpose(1, 2).reshape(B, T, H * dh)


def _attn_plain(qkv, sep, nhead: int, dtype):
    """PFN attention for (B, T, 3D) qkv in ``dtype``, all heads (the JAX
    package's ``_attn_item``). Returns (attn (B, T, D) in dtype, lse (B, T, H)
    f32)."""
    _, _, v, s, allowed = _scores(qkv, sep, nhead)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(allowed, torch.exp(s - m), torch.zeros((), device=qkv.device))
    l = e.sum(dim=-1, keepdim=True)
    p = e / l
    o = _mm(p.to(dtype), v).to(dtype)  # (B, H, T, dh)
    lse = (m + torch.log(l))[..., 0]  # (B, H, T)
    return _merge_heads(o), lse.transpose(1, 2)


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


def _bwd_ffn_plain(r, p: dict, dy, dtype):
    """The TPU kernel ``_bwd_ffn_kernel``: the FFN and LN2 recomputed from r,
    then their backward. Returns (dr (B, T, D) f32, the gradients of w1, b1,
    w2, b2, ln2_g, ln2_b as f32 sums over the batch)."""
    w1, w2 = p["w1"].to(dtype), p["w2"].to(dtype)
    rc = r.to(dtype)
    h1 = _mm(rc, w1) + p["b1"].float()
    g = _gelu(h1).to(dtype)
    f = _mm(g, w2) + p["b2"].float()
    xhat2, rstd2 = _ln_fwd(r + f)
    dy = dy.float()
    dr2 = _ln_bwd(dy * p["ln2_g"].float(), xhat2, rstd2)
    dr2c = dr2.to(dtype)
    dh1 = _mm(dr2c, w2.t()) * _gelu_grad(h1)
    dh1c = dh1.to(dtype)
    dr = dr2 + _mm(dh1c, w1.t())
    return dr, {"w1": _mm_tn(rc, dh1c), "b1": _row_sum(dh1), "w2": _mm_tn(g, dr2c), "b2": _row_sum(dr2),
                "ln2_g": _row_sum(dy * xhat2), "ln2_b": _row_sum(dy)}


def _bwd_attn_plain(x, p: dict, sep, lse, dr, nhead: int, dtype):
    """The TPU kernel ``_bwd_attn_kernel``: qkv, the attention (p from the
    saved lse) and LN1 recomputed from x, then their backward. Returns (dx
    (B, T, D) f32, the gradients of wqkv, bqkv, wout, bout, ln1_g, ln1_b as
    f32 sums over the batch)."""
    B, T, D = x.shape
    scale = 1.0 / (D // nhead) ** 0.5
    wqkv, wout = p["wqkv"].to(dtype), p["wout"].to(dtype)
    xc = x.to(dtype)
    qkv = (_mm(xc, wqkv) + p["bqkv"].float()).to(dtype)
    q, k, v, s, allowed = _scores(qkv, sep, nhead)
    prob = torch.where(allowed, torch.exp(s - lse.transpose(1, 2)[..., None]), torch.zeros((), device=x.device))
    pc = prob.to(dtype)
    attn = _merge_heads(_mm(pc, v).to(dtype))
    ao = (_mm(attn, wout) + p["bout"].float()).to(dtype)
    xhat1, rstd1 = _ln_fwd(x.float() + ao.float())
    dr1 = _ln_bwd(dr * p["ln1_g"].float(), xhat1, rstd1)
    dr1c = dr1.to(dtype)
    do = _mm(dr1c, wout.t()).reshape(B, T, nhead, -1).transpose(1, 2).to(dtype)  # (B, H, T, dh)
    o = _mm(pc, v)  # the head outputs again, left unrounded (as the TPU kernel)
    delta = (do.float() * o).sum(dim=-1, keepdim=True)
    ds = (prob * (_mm(do, v.transpose(-1, -2)) - delta)).to(dtype)
    dq = _mm(ds, k) * scale
    dk = _mm(ds.transpose(-1, -2), q) * scale
    dv = _mm(pc.transpose(-1, -2), do)
    dqkv = torch.cat([_merge_heads(dq), _merge_heads(dk), _merge_heads(dv)], dim=-1)
    dqkvc = dqkv.to(dtype)
    dx = dr1 + _mm(dqkvc, wqkv.t())
    return dx, {"wqkv": _mm_tn(xc, dqkvc), "bqkv": _row_sum(dqkv), "wout": _mm_tn(attn, dr1c),
                "bout": _row_sum(dr1), "ln1_g": _row_sum(dr * xhat1), "ln1_b": _row_sum(dr)}


def fused_layer_bwd_plain(x, p: dict, sep, r, lse, dy, nhead: int, dtype=torch.float32):
    """The plain PyTorch version of the TPU kernels' backward, ``_bwd_call``:
    the FFN block from r and dy gives dr, then the attention block from x,
    lse and dr gives dx.

    x: (B, T, D); ``p`` in the JAX layout; r (B, T, D) and lse (B, T, H) as
    :func:`fused_layer_fwd` returns them; dy (B, T, D) the gradient of y.
    Returns (dx in x's dtype, {name: gradient in that parameter's dtype}).
    """
    dr, dp_ffn = _bwd_ffn_plain(r.float(), p, dy, dtype)
    dx, dp_attn = _bwd_attn_plain(x, p, sep, lse.float(), dr, nhead, dtype)
    return dx.to(x.dtype), _like_params({**dp_attn, **dp_ffn}, p)


def _like_params(dp: dict, p: dict) -> dict:
    """The f32 gradients ``dp`` in the shape and dtype of their parameters
    (the JAX package's ``like``)."""
    return {k: dp[k].reshape(p[k].shape).to(p[k].dtype) for k in _ext.FUSED_PARAM_ORDER}


def _kernel_params(p: dict, dtype) -> dict:
    """``p`` as the kernels take it: the four matrices cast to the compute
    dtype (as the JAX package's ``_fwd_call`` and ``_bwd_call`` do), the
    vectors f32, all contiguous."""
    return {k: (p[k].to(dtype) if k in _ext.FUSED_MATRICES else p[k].float()).contiguous()
            for k in _ext.FUSED_PARAM_ORDER}


def fused_layer_fwd(x, p: dict, sep, nhead: int, dtype=torch.float32):
    """(y, r, lse) of one layer, as the JAX package's ``_fwd_call`` returns
    them: the kernel on a CUDA tensor, the plain version on a CPU tensor.
    Not differentiable; :func:`fused_encoder_layer` is."""
    if not x.is_cuda:
        return fused_layer_fwd_plain(x, p, sep, nhead, dtype)
    return _ext.fused_layer_fwd(x.float().contiguous(), _kernel_params(p, dtype), _sep_tensor(sep, x.device), nhead)


def fused_layer_bwd(x, p: dict, sep, r, lse, dy, nhead: int, dtype=torch.float32):
    """(dx, dp) of one layer, as the JAX package's ``_bwd_call`` returns them:
    on a CUDA tensor the FFN kernel (dy, r -> dr and the FFN and LN2
    gradients), then the attention kernel (x, lse, dr -> dx and the
    attention and LN1 gradients); on a CPU tensor the plain version."""
    if not x.is_cuda:
        return fused_layer_bwd_plain(x, p, sep, r, lse, dy, nhead, dtype)
    kp = _kernel_params(p, dtype)
    dr, dp_ffn = _ext.fused_layer_bwd_ffn(r.contiguous(), kp, dy.float().contiguous())
    dx, dp_attn = _ext.fused_layer_bwd_attn(x.float().contiguous(), kp, lse.contiguous(), dr,
                                            _sep_tensor(sep, x.device), nhead)
    return dx.to(x.dtype), _like_params({**dp_attn, **dp_ffn}, p)


class _FusedLayer(torch.autograd.Function):
    """The JAX package's ``fused_encoder_layer`` custom VJP: the forward saves
    x, sep, r and lse, the backward is :func:`fused_layer_bwd`."""

    @staticmethod
    def forward(ctx, x, sep, nhead, dtype, *params):
        y, r, lse = fused_layer_fwd(x, dict(zip(_ext.FUSED_PARAM_ORDER, params)), sep, nhead, dtype)
        ctx.save_for_backward(x, sep, r, lse, *params)
        ctx.nhead, ctx.dtype = nhead, dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, sep, r, lse, *params = ctx.saved_tensors
        dx, dp = fused_layer_bwd(x, dict(zip(_ext.FUSED_PARAM_ORDER, params)), sep, r, lse, dy, ctx.nhead, ctx.dtype)
        needs = ctx.needs_input_grad
        dparams = [dp[k] if need else None for k, need in zip(_ext.FUSED_PARAM_ORDER, needs[4:])]
        return (dx if needs[0] else None, None, None, None, *dparams)


def fused_encoder_layer(x, p: dict, single_eval_pos, nhead: int, dtype=torch.float32):
    """One PFN encoder layer, fully fused; the JAX package's signature.

    x: (B, T, D), any float dtype; ``p`` in the JAX layout (module
    docstring), in the parameters' own dtype; ``dtype`` the compute dtype of
    the products (LayerNorms stay f32). Returns the post-LN2 activations, f32
    (B, T, D). On a CUDA tensor the forward and the backward launch the
    kernels; on a CPU tensor both run the plain versions.
    """
    sep = _sep_tensor(single_eval_pos, x.device)
    return _FusedLayer.apply(x, sep, nhead, dtype, *(p[k] for k in _ext.FUSED_PARAM_ORDER))
