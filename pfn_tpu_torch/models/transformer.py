"""The PFN transformer.

Port of ``pfn_tpu/models/transformer.py`` (dense FFN, no dropout, default
encoders and decoder). Behaviour:
  * Train tokens are encoder(x) + y_encoder(y); eval tokens are encoder(x)
    only, via ``where(pos < sep)``, so shapes do not depend on sep.
  * PFN attention is a parameter of the attention op, never a mask.
  * Post-LN encoder layers with a GELU FFN; out_proj and linear2 start at
    zero, so the stack starts as the identity.
  * The decoder runs on every position.

Casting follows flax exactly (no autocast): x and y are cast to the compute
dtype and promoted back to f32 by the f32 encoders, so embeddings are f32;
qkv, out_proj, linear1 and linear2 compute in the compute dtype; both
LayerNorms run in f32 (eps 1e-5), so the residual stream is f32; the decoder
is fed f32. Submodule names give the reference's torch state_dict keys
(``pfn_tpu/train/checkpoints.py:100-165``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from pfn_tpu_torch.models.decoders import MLPDecoder
from pfn_tpu_torch.models.encoders import LinearEncoder
from pfn_tpu_torch.models.init import lecun_normal_
from pfn_tpu_torch.models.positional import NoPositionalEncoding
from pfn_tpu_torch.ops.attention import pfn_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Static model configuration; the fields of the JAX package's config
    that place work on a device mesh are not part of the port yet."""

    num_features: int
    n_out: int
    emsize: int = 200
    nhead: int = 2
    nhid: int = 200
    nlayers: int = 6
    dropout: float = 0.0
    input_normalization: bool = False
    attention_impl: str = "auto"  # 'auto' | 'flash' | 'prefix' | 'dense' | 'fused' (as 'auto' here)
    dtype: torch.dtype = torch.float32  # compute dtype; parameters are f32
    encoder: Callable | None = None
    y_encoder: Callable | None = None
    pos_encoder: Callable | None = None
    decoder: Callable | None = None
    max_len: int = 5000
    exact_gelu: bool = False
    num_experts: int = 0

    def check_ported(self) -> None:
        """Raise for the options the port does not have yet."""
        todo = {
            "input_normalization": (self.input_normalization, "queue 1 item 9 (SeqBN)"),
            "num_experts > 0": (self.num_experts > 0, "queue 1 item 14 (MoE)"),
            "encoder": (self.encoder is not None, "queue 1 item 9 (encoders)"),
            "y_encoder": (self.y_encoder is not None, "queue 1 item 9 (encoders)"),
            "pos_encoder": (self.pos_encoder is not None, "queue 1 item 9 (positional encodings)"),
            "decoder": (self.decoder is not None, "queue 1 item 9 (decoders)"),
        }
        for name, (used, item) in todo.items():
            if used:
                raise NotImplementedError(f"TransformerConfig.{name} is not ported yet (ROADMAP.md {item})")


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=dtype): inputs, kernel and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class MultiheadPFNAttention(nn.Module):
    """Multi-head self-attention with the PFN mask rule: a combined qkv
    projection (torch's ``in_proj``) with xavier-uniform init, and a
    zero-initialised out-projection."""

    def __init__(self, emsize: int, nhead: int, dtype: torch.dtype = torch.float32, attention_impl: str = "auto"):
        super().__init__()
        if emsize % nhead:
            raise ValueError(f"emsize {emsize} is not divisible by nhead {nhead}")
        self.nhead = nhead
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.in_proj_weight = nn.Parameter(torch.empty(3 * emsize, emsize))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * emsize))
        self.out_proj = nn.Linear(emsize, emsize)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor, single_eval_pos) -> torch.Tensor:
        B, T, D = x.shape
        dt = self.dtype
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        qkv = qkv.reshape(B, T, 3, self.nhead, D // self.nhead)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, T, Dh)
        out = pfn_attention(q, k, v, single_eval_pos, impl=self.attention_impl)
        out = out.transpose(1, 2).reshape(B, T, D)
        return _linear(out, self.out_proj, dt)


class PFNEncoderLayer(nn.Module):
    """Post-LN encoder layer with a GELU FFN, as
    torch.nn.TransformerEncoderLayer(activation='gelu'), plus the zero init
    of linear2."""

    def __init__(self, emsize: int, nhead: int, nhid: int, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto", exact_gelu: bool = False):
        super().__init__()
        self.dtype = dtype
        self.gelu_approximate = "none" if exact_gelu else "tanh"
        self.self_attn = MultiheadPFNAttention(emsize, nhead, dtype=dtype, attention_impl=attention_impl)
        self.linear1 = nn.Linear(emsize, nhid)
        self.linear2 = nn.Linear(nhid, emsize)
        self.norm1 = nn.LayerNorm(emsize, eps=1e-5)
        self.norm2 = nn.LayerNorm(emsize, eps=1e-5)
        lecun_normal_(self.linear1.weight)
        nn.init.zeros_(self.linear1.bias)
        nn.init.zeros_(self.linear2.weight)
        nn.init.zeros_(self.linear2.bias)

    def forward(self, x: torch.Tensor, single_eval_pos) -> torch.Tensor:
        attn = self.self_attn(x, single_eval_pos)
        x = self.norm1((x + attn).float())
        h = _linear(x, self.linear1, self.dtype)
        h = F.gelu(h, approximate=self.gelu_approximate)
        h = _linear(h, self.linear2, self.dtype)
        return self.norm2((x + h).float())


class _EncoderStack(nn.Module):
    """Holds the layers under ``transformer_encoder.layers.N``."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class PFNTransformer(nn.Module):
    """The PFN: ``model(x, y, single_eval_pos)`` -> (B, T, n_out).

    x: (B, T, F) features; y: (B, T) targets, read at positions <
    ``single_eval_pos`` only. ``single_eval_pos`` is an int or a one-element
    tensor. The output covers all positions; rows < single_eval_pos are train
    tokens whose outputs callers ignore.
    """

    def __init__(self, config: TransformerConfig):
        super().__init__()
        config.check_ported()
        self.config = config
        c = config
        self.encoder = LinearEncoder(c.num_features, c.emsize)
        self.y_encoder = LinearEncoder(1, c.emsize)
        self.pos_encoder = NoPositionalEncoding(max_len=c.max_len)
        self.transformer_encoder = _EncoderStack(
            PFNEncoderLayer(c.emsize, c.nhead, c.nhid, dtype=c.dtype, attention_impl=c.attention_impl,
                            exact_gelu=c.exact_gelu)
            for _ in range(c.nlayers)
        )
        self.decoder = MLPDecoder(c.emsize, c.nhid, c.n_out, approximate=not c.exact_gelu)

    def forward(self, x: torch.Tensor, y: torch.Tensor, single_eval_pos) -> torch.Tensor:
        c = self.config
        if self.training and c.dropout > 0:
            raise NotImplementedError("dropout > 0 in training is not ported yet (ROADMAP.md queue 1 item 9)")
        T = x.shape[1]
        x_emb = self.encoder(x.to(c.dtype).float())
        y_emb = self.y_encoder(y[..., None].to(c.dtype).float())
        pos = torch.arange(T, device=x.device)[None, :, None]
        tokens = x_emb + torch.where(pos < single_eval_pos, y_emb, torch.zeros_like(y_emb))
        tokens = self.pos_encoder(tokens)
        for layer in self.transformer_encoder.layers:
            tokens = layer(tokens, single_eval_pos)
        return self.decoder(tokens.float())



def num_params(model: nn.Module) -> int:
    """Number of parameter entries (the JAX package's ``num_params`` of the
    params tree), which ``get_openai_lr`` takes."""
    return sum(p.numel() for p in model.parameters())
