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
dim the kernels are built for), the dense path elsewhere. On a device mesh
(``mesh=``) each rank passes its shards, and a sequence axis takes
:func:`pfn_sharded_attention`: K and V gathered over ``sp``, the prefix pass
on the rank's queries and the exact self merge (kernels 1′-3′ on the card).
"""

from __future__ import annotations

import torch

from pfn_tpu_torch.ops.flash_attention import (
    FLASH_MIN_SEQ,
    flash_supported,
    flash_supported_on,
    pfn_flash_attention,
    pfn_flash_prefix_attention,
)
from pfn_tpu_torch.parallel.collectives import all_gather


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


def pfn_attention_prefix_merge(q, k_full, v_full, k_self, v_self, single_eval_pos, q_global_start, scale=None,
                               prefix_impl: str = "auto"):
    """PFN attention as prefix attention plus an exact self-attention merge.

    For an eval token i the PFN rule is softmax over {j < sep} ∪ {i}. With
    the prefix pass's output o_p and logsumexp lse, adding the one self key is
    exact logsumexp algebra:

        w   = sigmoid(s_ii - lse)          (s_ii = scale * <q_i, k_i>)
        out = o_p + w * (v_i - o_p)        for i >= sep; o_p for i < sep

    The mask of the prefix pass does not depend on the query, so q may be a
    sequence shard: k_self and v_self are its own rows, and
    ``q_global_start`` places it for the i < sep test. ``prefix_impl``:
    "flash" (the kernel's prefix variant; on a CPU tensor its plain
    version), "dense", or "auto": "flash" where ``flash_supported`` holds for
    the keys. Gradients flow through the prefix pass's lse.
    """
    B, H, Tq, D = q.shape
    scale = scale if scale is not None else 1.0 / (D**0.5)
    if prefix_impl == "auto":
        prefix_impl = "flash" if flash_supported(k_full) else "dense"
    if prefix_impl == "flash":
        o_p, lse = pfn_flash_prefix_attention(q, k_full, v_full, single_eval_pos, scale=scale)
    elif prefix_impl == "dense":
        o_p, lse = pfn_prefix_attention_reference(q, k_full, v_full, single_eval_pos, scale=scale)
    else:
        raise ValueError(f"unknown prefix_impl {prefix_impl!r}")
    s_self = (q.float() * k_self.float()).sum(dim=-1) * scale  # (B, H, Tq)
    w = torch.sigmoid(s_self - lse)[..., None].to(o_p.dtype)
    merged = o_p + w * (v_self - o_p)
    gi = q_global_start + torch.arange(Tq, device=q.device)
    is_train = (gi < single_eval_pos)[None, None, :, None]
    return torch.where(is_train, o_p, merged)


def pfn_sharded_attention(q, k, v, single_eval_pos, mesh, scale=None, prefix_impl: str = "auto"):
    """PFN attention on this rank's shards of a (dp, sp, tp, ep) mesh.

    q, k, v: (B/dp, H/tp, T/sp, Dh), the rank's batch rows, heads and
    positions. K and V are all-gathered over sp (the backward reduce-scatters
    their gradients), and the prefix pass runs on the rank's T/sp queries
    against all T keys, from ``q_global_start = sp_rank * T/sp``, then the
    exact self merge. Heads are local to tp and the batch to dp; ep holds
    copies. ``prefix_impl`` as :func:`pfn_attention_prefix_merge`'s; "auto"
    takes the kernel's prefix variant for CUDA tensors of T >= 256.
    """
    k_full = all_gather(k, mesh, "sp", dim=2)
    v_full = all_gather(v, mesh, "sp", dim=2)
    q_start = mesh.axis_index("sp") * q.shape[2]
    return pfn_attention_prefix_merge(q, k_full, v_full, k, v, single_eval_pos, q_start, scale=scale,
                                      prefix_impl=prefix_impl)


def _mesh_divisible(q_shape, mesh) -> bool:
    """Whether global (B, H, T, Dh) shapes divide the mesh: B over dp, H over
    tp, T over sp."""
    B, H, T, _ = q_shape
    return B % mesh.axis_size("dp") == 0 and H % mesh.axis_size("tp") == 0 and T % mesh.axis_size("sp") == 0


def pfn_attention(q, k, v, single_eval_pos, impl: str = "auto", scale=None, mesh=None):
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

    ``mesh``: q, k, v are this rank's shards. With a sequence axis (sp > 1)
    :func:`pfn_sharded_attention` runs, its prefix pass the kernel's prefix
    variant on CUDA tensors where ``impl`` is "flash", or not "dense" at a
    global T >= 256 (the JAX rule, with the card for the TPU), and the dense
    prefix elsewhere. Without one the rank's shards are whole sequences of
    its batch rows and heads, and the rule above runs on them: a deviation,
    since the JAX package takes the prefix composition on any multi-device
    mesh, where here the kernel's own variant does the same work.
    """
    if impl == "fused":
        impl = "auto"
    if mesh is not None and mesh.axis_size("sp") > 1:
        if impl not in ("auto", "flash", "prefix", "dense"):
            raise ValueError(f"unknown attention impl {impl!r}")
        T = q.shape[2] * mesh.axis_size("sp")
        want_flash = impl == "flash" or (impl != "dense" and T >= FLASH_MIN_SEQ
                                         and flash_supported_on(q.device.type, q.shape[-1]))
        return pfn_sharded_attention(q, k, v, single_eval_pos, mesh, scale=scale,
                                     prefix_impl="flash" if want_flash and q.is_cuda else "dense")
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
