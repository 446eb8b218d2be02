"""PFN-masked attention.

Port of ``pfn_tpu/ops/attention.py``. The PFN rule: every token attends to
all train tokens (positions < ``single_eval_pos``) and, in addition, to
itself. The rule is a function of one scalar, never a materialised mask in the
kernel path.

  * :func:`pfn_attention_reference`: dense torch, f32 accumulation. The plain
    path on the CPU, and ``impl="dense"`` on the card.
  * :func:`pfn_tpu_torch.ops.flash_attention.pfn_flash_attention`: the
    hand-written Hopper kernels, forward and backward.

:func:`pfn_attention` dispatches between them by the JAX package's rule: the
kernel where ``flash_supported`` holds (a CUDA tensor of T >= 256 whose head
dim the kernels are built for), the dense path elsewhere. The mesh branch of the JAX
dispatch is not ported (ROADMAP.md queue 1 item 14).
"""

from __future__ import annotations

import torch

from pfn_tpu_torch.ops.flash_attention import flash_supported, pfn_flash_attention, pfn_flash_prefix_attention


def pfn_mask(seq_len: int, single_eval_pos, device=None) -> torch.Tensor:
    """Boolean (T, T) PFN mask: mask[q, k] = (k < sep) | (k == q)."""
    idx = torch.arange(seq_len, device=device)
    return (idx[None, :] < single_eval_pos) | (idx[None, :] == idx[:, None])


def pfn_attention_reference(q, k, v, single_eval_pos, scale=None):
    """Dense PFN-masked scaled dot-product attention.

    q, k, v: (B, H, T, D). Logits and softmax in f32, weights cast to v's
    dtype, the weighted sum accumulated in f32 and returned in v's dtype.
    """
    T, D = q.shape[-2], q.shape[-1]
    scale = scale if scale is not None else 1.0 / (D**0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = pfn_mask(T, single_eval_pos, device=q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights.float(), v.float()).to(v.dtype)


def pfn_prefix_attention_reference(q, k, v, single_eval_pos, scale=None):
    """Dense prefix-only attention (keys < sep, no diagonal) with logsumexp.

    q: (B, H, Tq, D) may be a sequence shard; k, v: (B, H, Tk, D) are full.
    Returns (o, lse (B, H, Tq)); empty-prefix rows (sep == 0) get o = 0 and
    lse ~ -1e30, as the kernel does.
    """
    D = q.shape[-1]
    Tk = k.shape[-2]
    scale = scale if scale is not None else 1.0 / (D**0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    allowed = (torch.arange(Tk, device=q.device) < single_eval_pos)[None, None, None, :]
    s = torch.where(allowed, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul((p / l).to(v.dtype).float(), v.float()).to(v.dtype)
    return o, (m + torch.log(l))[..., 0]


def pfn_attention_prefix_merge(q, k_full, v_full, k_self, v_self, single_eval_pos, q_global_start, scale=None):
    """PFN attention as prefix attention plus an exact self-attention merge.

    For an eval token i the PFN rule is softmax over {j < sep} ∪ {i}. With
    the prefix pass's output o_p and logsumexp lse, adding the one self key is
    exact logsumexp algebra:

        w   = sigmoid(s_ii - lse)          (s_ii = scale * <q_i, k_i>)
        out = o_p + w * (v_i - o_p)        for i >= sep; o_p for i < sep

    The prefix pass is the kernel's prefix variant where ``flash_supported``
    holds for the keys, and the dense prefix path elsewhere (the JAX merge's
    ``prefix_impl="auto"``). Gradients flow through the prefix pass's lse.
    """
    B, H, Tq, D = q.shape
    scale = scale if scale is not None else 1.0 / (D**0.5)
    prefix = pfn_flash_prefix_attention if flash_supported(k_full) else pfn_prefix_attention_reference
    o_p, lse = prefix(q, k_full, v_full, single_eval_pos, scale=scale)
    s_self = (q.float() * k_self.float()).sum(dim=-1) * scale  # (B, H, Tq)
    w = torch.sigmoid(s_self - lse)[..., None].to(o_p.dtype)
    merged = o_p + w * (v_self - o_p)
    gi = q_global_start + torch.arange(Tq, device=q.device)
    is_train = (gi < single_eval_pos)[None, None, :, None]
    return torch.where(is_train, o_p, merged)


def pfn_attention(q, k, v, single_eval_pos, impl: str = "auto", scale=None):
    """Dispatching PFN attention; ``scale`` overrides 1/sqrt(head_dim).

    impl:
      * "auto": the kernel where ``flash_supported(q)`` holds, the dense path
        elsewhere (a CPU tensor, T < 256, or a head dim the kernels lack).
      * "flash": the kernel. It raises on a CPU tensor (the kernel has no CPU
        build) and on a head dim the kernels lack.
      * "prefix": the prefix pass plus the exact self merge; the prefix pass
        follows the "auto" rule.
      * "dense": the dense path, on any device.
      * "fused": as "auto". The fused whole-layer kernel replaces the whole
        layer, not this op (``models.fused_apply.fused_forward``); a model
        configured with it evaluates through the ordinary path, as in the
        JAX package.
    """
    if impl == "fused":
        impl = "auto"
    if impl == "dense":
        return pfn_attention_reference(q, k, v, single_eval_pos, scale=scale)
    if impl == "prefix":
        return pfn_attention_prefix_merge(q, k, v, k, v, single_eval_pos, 0, scale=scale)
    if impl == "flash" and not q.is_cuda:
        raise RuntimeError(
            "impl='flash' needs a CUDA tensor: the PFN flash kernel has no CPU build "
            "(use impl='auto' or 'dense' on the CPU)"
        )
    if impl == "flash" or (impl == "auto" and flash_supported(q)):
        return pfn_flash_attention(q, k, v, single_eval_pos, scale=scale)
    if impl == "auto":
        return pfn_attention_reference(q, k, v, single_eval_pos, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")
