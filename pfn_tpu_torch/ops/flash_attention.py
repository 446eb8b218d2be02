"""PFN flash attention: the hand-written Hopper kernels, forward and backward,
and their plain versions.

Port of ``pfn_tpu/ops/flash_attention.py``. The PFN rule: query i attends to
keys {j < sep} and, in the diagonal variant, to itself. The kernels
(``csrc/pfn_flash_fwd.cu``, ``csrc/pfn_flash_bwd.cu``) walk only the tiles
that hold allowed keys and never build a (T, T) mask or score matrix; ``sep``
is read from device memory. Layouts are the JAX package's: (B, H, T, Dh) at
the public functions, (B*H, T, Dh) inside.

The gradient is two ``torch.autograd.Function``s, the counterparts of the
JAX package's ``_flash`` and ``_flash_prefix`` custom VJPs. Each forward
saves (q, k, v, o, lse, sep); each backward computes delta = rowsum(dO * o)
(minus dlse in the prefix variant) in f32 and launches the dq and the dk/dv
kernels. On a CUDA tensor the wrappers launch the kernels; on a CPU tensor
they run :func:`_flash_fwd_plain` and :func:`_flash_bwd_plain`, the dense
float32 versions of the same functions, which are also the gold that
``chip_smoke.py`` holds the kernels against.
"""

from __future__ import annotations

import torch

from pfn_tpu_torch.ops import _ext


def flash_supported_on(device_type: str, head_dim: int) -> bool:
    """Whether the kernels serve a tensor on ``device_type`` with head dim
    ``head_dim``: a CUDA tensor whose head dim the kernels are built for."""
    return device_type == "cuda" and head_dim in _ext.FLASH_HEAD_DIMS


def flash_supported(q: torch.Tensor) -> bool:
    """Auto-dispatch predicate, the counterpart of the JAX package's
    ``flash_supported``: the kernel path runs where this holds, the dense path
    elsewhere. It has no sequence-length threshold: where the kernel starts
    to beat the dense path on Hopper is not measured yet."""
    return flash_supported_on(q.device.type, q.shape[-1])


def _allowed(Tq: int, Tk: int, sep, valid_len, include_diag: bool, device) -> torch.Tensor:
    """(Tq, Tk) bool: key j allowed for query i."""
    keys = torch.arange(Tk, device=device)[None, :]
    allowed = (keys < sep) & (keys < valid_len)
    if include_diag:
        queries = torch.arange(Tq, device=device)[:, None]
        allowed = allowed | ((keys == queries) & (keys < valid_len))
    return allowed.expand(Tq, Tk)


def _flash_fwd_plain(q, k, v, sep, valid_len, include_diag: bool):
    """Dense float32 PFN attention with per-row logsumexp.

    q: (BH, Tq, D) already scaled; k, v: (BH, Tk, D). A key j is allowed for
    query i when (j < sep and j < valid_len), or, with ``include_diag``, when
    j == i < valid_len. Returns (o (BH, Tq, D) in q's dtype, lse (BH, Tq)
    float32); a row with no allowed key gets o = 0 and lse = -1e30 + log(1e-30),
    as the TPU kernel's initial state gives.
    """
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    allowed = _allowed(q.shape[1], k.shape[1], sep, valid_len, include_diag, q.device)
    s = s.masked_fill(~allowed, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.full_like(m, -1e30))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _flash_bwd_plain(q, k, v, o, lse, do, dlse, sep, valid_len, include_diag: bool):
    """Dense float32 backward of :func:`_flash_fwd_plain`, with the JAX
    kernels' formulas: p = exp(s - lse) on allowed entries (0 elsewhere),
    dp = dO v^T, delta = rowsum(dO * o) - dlse, ds = p (dp - delta),
    dq = ds k, dk = ds^T q, dv = p^T dO.

    q, o, do: (BH, Tq, D); k, v: (BH, Tk, D); lse (BH, Tq) from the forward;
    dlse: (BH, Tq) or None. Returns (dq, dk, dv) in the dtypes of q, k, v;
    dq is the gradient with respect to the scaled q.
    """
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    allowed = _allowed(q.shape[1], k.shape[1], sep, valid_len, include_diag, q.device)
    s = torch.matmul(qf, kf.transpose(-1, -2))
    p = torch.where(allowed, torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    if dlse is not None:
        delta = delta - dlse.float()[..., None]
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _sep_tensor(sep, device) -> torch.Tensor:
    """``sep`` as a one-element int32 tensor on ``device`` (no host sync)."""
    if isinstance(sep, torch.Tensor):
        return sep.to(device=device, dtype=torch.int32).reshape(1)
    return torch.full((1,), int(sep), dtype=torch.int32, device=device)


def _flash_fwd(q, k, v, sep, include_diag: bool):
    """(BH, T, D) forward: the kernel on CUDA, the plain version on the CPU."""
    if not q.is_cuda:
        return _flash_fwd_plain(q, k, v, sep, k.shape[1], include_diag)
    return _ext.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), _sep_tensor(sep, q.device), include_diag)


def _flash_bwd(q, k, v, o, lse, do, dlse, sep, include_diag: bool):
    """(BH, T, D) backward: the two kernels on CUDA, the plain version on the
    CPU. delta is plain f32 torch, as it is plain XLA in the JAX package."""
    if not q.is_cuda:
        return _flash_bwd_plain(q, k, v, o, lse, do, dlse, sep, k.shape[1], include_diag)
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    sep = _sep_tensor(sep, q.device)
    dq = _ext.flash_bwd_dq(q, k, v, do, lse, delta, sep, include_diag)
    dk, dv = _ext.flash_bwd_dkv(q, k, v, do, lse, delta, sep, include_diag)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The PFN rule: o only (the JAX package's ``_flash``)."""

    @staticmethod
    def forward(ctx, q, k, v, sep):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _flash_fwd(q, k, v, sep, include_diag=True)
        ctx.save_for_backward(q, k, v, o, lse, sep)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, sep = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, None, sep, include_diag=True)
        return dq, dk, dv, None


class _FlashPrefix(torch.autograd.Function):
    """The prefix rule: (o, lse), both differentiable (the JAX package's
    ``_flash_prefix``); the self merge downstream depends on lse."""

    @staticmethod
    def forward(ctx, q, k, v, sep):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _flash_fwd(q, k, v, sep, include_diag=False)
        ctx.save_for_backward(q, k, v, o, lse, sep)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, sep = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, dlse, sep, include_diag=False)
        return dq, dk, dv, None


def pfn_flash_attention(q, k, v, single_eval_pos, scale=None):
    """Flash PFN attention. q, k, v: (B, H, T, Dh) -> (B, H, T, Dh).

    Equal to :func:`pfn_tpu_torch.ops.attention.pfn_attention_reference` for
    any ``single_eval_pos`` (int or one-element tensor), and differentiable.
    q is scaled in its own dtype before the kernel, as the JAX package does,
    so bf16 rounds at the same place and autograd carries the scale into dq.
    """
    B, H, T, D = q.shape
    scale = scale if scale is not None else 1.0 / (D**0.5)
    o = _Flash.apply(
        (q * scale).reshape(B * H, T, D),
        k.reshape(B * H, T, D),
        v.reshape(B * H, T, D),
        _sep_tensor(single_eval_pos, q.device),
    )
    return o.reshape(B, H, T, D)


def pfn_flash_prefix_attention(q, k, v, single_eval_pos, scale=None):
    """Prefix-only flash attention (keys < sep, no diagonal) with logsumexp.

    q: (B, H, Tq, Dh), possibly a sequence shard; k, v: (B, H, Tk, Dh), the
    full keys. Returns (o (B, H, Tq, Dh), lse (B, H, Tq)), both
    differentiable; rows with an empty prefix (sep == 0) get o = 0 and
    lse ~ -1e30.
    """
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = scale if scale is not None else 1.0 / (D**0.5)
    o, lse = _FlashPrefix.apply(
        (q * scale).reshape(B * H, Tq, D),
        k.reshape(B * H, Tk, D),
        v.reshape(B * H, Tk, D),
        _sep_tensor(single_eval_pos, q.device),
    )
    return o.reshape(B, H, Tq, D), lse.reshape(B, H, Tq)
