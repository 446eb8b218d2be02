"""Products computed in a stated precision.

The reference runs in float32 with TF32 off. Its control runs the same
equations with every product's operands (forward and backward) rounded to
the precision below the configuration's: fp8 (e4m3, one scale a tensor) for
the parts the configuration runs in bfloat16, TF32 for its float32 parts
when the port keeps TF32 off, bfloat16 for other float32 work (the GP
sampler's field). Rounding the operands and accumulating in float32 is what
the tensor cores do for these types. Which part of a model runs in which
precision under the control is the model kind's (``control`` in
``reference/model_<kind>.py``).
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 with its mantissa rounded to TF32's 10 bits (to nearest)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """e4m3 with one scale a tensor (its largest magnitude to 448)."""
    scale = FP8_MAX / t.detach().abs().amax().float().clamp_min(1e-30)
    return ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)


ROUNDING = {"f32": None, "tf32": round_tf32, "bf16": round_bf16, "fp8": round_fp8}
# The precision below each stated one: fp8 for bfloat16, TF32 for float32
# that the port runs with TF32 off.
BELOW = {"bfloat16": "fp8", "float32": "tf32"}


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return rnd(a) @ rnd(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        rnd = ctx.rnd
        gq = rnd(g)
        ga = gq @ rnd(b).transpose(-1, -2)
        gb = rnd(a).transpose(-1, -2) @ gq
        # Broadcast operands (a weight shared over a batch) sum their gradient back.
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str = "f32") -> torch.Tensor:
    """a @ b with both operands, and in the backward the incoming gradient,
    rounded to ``mode`` (a key of ROUNDING)."""
    rnd = ROUNDING[mode]
    return a @ b if rnd is None else _RoundedMatmul.apply(a, b, rnd)


def rounded(t: torch.Tensor, mode: str = "f32") -> torch.Tensor:
    rnd = ROUNDING[mode]
    return t if rnd is None else rnd(t)
