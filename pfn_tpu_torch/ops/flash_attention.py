"""PFN flash attention, forward: the hand-written Hopper kernel and its plain
version.

Port of ``pfn_tpu/ops/flash_attention.py``. The PFN rule: query i attends to
keys {j < sep} and, in the diagonal variant, to itself. The kernel
(``csrc/pfn_flash_fwd.cu``) walks only the KV tiles that hold allowed keys and
never builds a (T, T) mask or score matrix; ``sep`` is read from device
memory. Layouts are the JAX package's: (B, H, T, Dh) at the public functions,
(B*H, T, Dh) inside.

On a CUDA tensor the wrappers launch the kernel. On a CPU tensor they run
:func:`_flash_fwd_plain`, the dense float32 version of the same function,
which is also the gold that ``chip_smoke.py`` holds the kernel against. There
is no backward kernel yet: on a CUDA tensor a call that needs a gradient
raises (ROADMAP.md, queue 1 item 6 and queue 2 items 2-3, the training slice).
"""

from __future__ import annotations

import torch

from pfn_tpu_torch.ops import _ext

_NO_BACKWARD = (
    "the PFN flash-attention backward kernels are not ported yet (ROADMAP.md queue 1 "
    "item 6, queue 2 items 2-3: the training slice); run the forward under torch.no_grad()"
)


def _flash_fwd_plain(q, k, v, sep, valid_len, include_diag: bool):
    """Dense float32 PFN attention with per-row logsumexp.

    q: (BH, Tq, D) already scaled; k, v: (BH, Tk, D). A key j is allowed for
    query i when (j < sep and j < valid_len), or, with ``include_diag``, when
    j == i < valid_len. Returns (o (BH, Tq, D) in q's dtype, lse (BH, Tq)
    float32); a row with no allowed key gets o = 0 and lse = -1e30 + log(1e-30),
    as the TPU kernel's initial state gives.
    """
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    Tq, Tk = q.shape[1], k.shape[1]
    keys = torch.arange(Tk, device=q.device)[None, :]
    allowed = (keys < sep) & (keys < valid_len)
    if include_diag:
        queries = torch.arange(Tq, device=q.device)[:, None]
        allowed = allowed | ((keys == queries) & (keys < valid_len))
    s = s.masked_fill(~allowed, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.full_like(m, -1e30))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _sep_tensor(sep, device) -> torch.Tensor:
    """``sep`` as a one-element int32 tensor on ``device`` (no host sync)."""
    if isinstance(sep, torch.Tensor):
        return sep.to(device=device, dtype=torch.int32).reshape(1)
    return torch.full((1,), int(sep), dtype=torch.int32, device=device)


def _flash_fwd(q, k, v, sep, include_diag: bool):
    """(BH, T, D) forward: the kernel on CUDA, the plain version on the CPU."""
    if not q.is_cuda:
        return _flash_fwd_plain(q, k, v, sep, k.shape[1], include_diag)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(_NO_BACKWARD)
    return _ext.flash_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), _sep_tensor(sep, q.device), include_diag
    )


def pfn_flash_attention(q, k, v, single_eval_pos, scale=None):
    """Flash PFN attention. q, k, v: (B, H, T, Dh) -> (B, H, T, Dh).

    Equal to :func:`pfn_tpu_torch.ops.attention.pfn_attention_reference` for
    any ``single_eval_pos`` (int or one-element tensor). q is scaled in its own
    dtype before the kernel, as the JAX package does, so bf16 rounds at the
    same place.
    """
    B, H, T, D = q.shape
    scale = scale if scale is not None else 1.0 / (D**0.5)
    o, _ = _flash_fwd(
        (q * scale).reshape(B * H, T, D),
        k.reshape(B * H, T, D),
        v.reshape(B * H, T, D),
        single_eval_pos,
        include_diag=True,
    )
    return o.reshape(B, H, T, D)


def pfn_flash_prefix_attention(q, k, v, single_eval_pos, scale=None):
    """Prefix-only flash attention (keys < sep, no diagonal) with logsumexp.

    q: (B, H, Tq, Dh), possibly a sequence shard; k, v: (B, H, Tk, Dh), the
    full keys. Returns (o (B, H, Tq, Dh), lse (B, H, Tq)); rows with an empty
    prefix (sep == 0) get o = 0 and lse ~ -1e30.
    """
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = scale if scale is not None else 1.0 / (D**0.5)
    o, lse = _flash_fwd(
        (q * scale).reshape(B * H, Tq, D),
        k.reshape(B * H, Tk, D),
        v.reshape(B * H, Tk, D),
        single_eval_pos,
        include_diag=False,
    )
    return o.reshape(B, H, Tq, D), lse.reshape(B, H, Tq)
