"""The model forward with the layer stack on the fused whole-layer kernel.

Port of ``pfn_tpu/models/fused_apply.py``. :func:`fused_forward` computes
``PFNTransformer.forward`` from the same module and weights, with the embed
and the f32 decoder through the model's own modules and each encoder layer as
one :func:`pfn_tpu_torch.ops.fused_layer.fused_encoder_layer` call. The
layers' numerics are the TPU kernel's (see that module), so in bf16 the
result differs from the unfused forward by rounding; in f32 the two agree.

The layers take the model's f32 parameters as they are (in the JAX layout,
a transposed view) and cast the four matrices to the compute dtype inside,
as the JAX package's ``_fwd_call`` and ``_bwd_call`` do, so the weight
gradients reach the parameters as f32 sums, not rounded through a bf16 copy.

Supported subset: the flagship configs (default Linear x/y encoders, no
positional encoding, no SeqBN, dropout 0, dense FFN, tanh GELU, no device
mesh), T <= 512,
as in the JAX package; on the card, also the widths the kernels are built
for (``_ext.fused_shape_error``). The plain version on the CPU takes any
width. Anything else raises.
``PFNTransformer.forward`` does not dispatch here; the train loop does, for
``TrainConfig(attention_impl="fused")`` (``train/loop.py``).
"""

from __future__ import annotations

import torch

from pfn_tpu_torch.models.decoders import MLPDecoder
from pfn_tpu_torch.models.encoders import LinearEncoder
from pfn_tpu_torch.models.positional import NoPositionalEncoding
from pfn_tpu_torch.models.transformer import PFNEncoderLayer, PFNTransformer, TransformerConfig
from pfn_tpu_torch.ops import _ext
from pfn_tpu_torch.ops.fused_layer import fused_encoder_layer
from pfn_tpu_torch.utils.profiling import span, split_backward_at


def fused_supported(cfg: TransformerConfig, device=None) -> str | None:
    """None if the fused path can run this config, else the reason not.

    The config checks are the JAX package's. On a CUDA ``device`` (a
    ``torch.device`` or its type name) the kernels' width rule applies too;
    elsewhere the plain version runs, which takes any width."""
    checks = [
        (cfg.encoder in (None, LinearEncoder), "custom x-encoder"),
        (cfg.y_encoder in (None, LinearEncoder), "custom y-encoder"),
        (cfg.pos_encoder in (None, NoPositionalEncoding), "positional encoding"),
        (cfg.decoder in (None, MLPDecoder), "custom decoder"),
        (not cfg.input_normalization, "SeqBN input normalization"),
        (cfg.dropout == 0.0, "dropout > 0"),
        (cfg.num_experts == 0, "MoE FFN"),
        (not cfg.exact_gelu, "exact (erf) GELU — kernel implements tanh"),
        (cfg.mesh is None, "multi-device mesh"),
        (cfg.emsize % cfg.nhead == 0, "emsize % nhead != 0"),
    ]
    for ok, reason in checks:
        if not ok:
            return reason
    if device is not None and torch.device(device).type == "cuda":
        return _ext.fused_shape_error(cfg.emsize, cfg.nhead, cfg.nhid)
    return None


def _layer_params(layer: PFNEncoderLayer) -> dict:
    """A port layer's parameters in the JAX layout, f32 as they are: the
    matrices as (in, out) views, the biases and LayerNorm parameters as
    vectors."""
    attn = layer.self_attn
    return {
        "wqkv": attn.in_proj_weight.t(),
        "bqkv": attn.in_proj_bias,
        "wout": attn.out_proj.weight.t(),
        "bout": attn.out_proj.bias,
        "ln1_g": layer.norm1.weight,
        "ln1_b": layer.norm1.bias,
        "w1": layer.linear1.weight.t(),
        "b1": layer.linear1.bias,
        "w2": layer.linear2.weight.t(),
        "b2": layer.linear2.bias,
        "ln2_g": layer.norm2.weight,
        "ln2_b": layer.norm2.bias,
    }


def fused_forward(model: PFNTransformer, x: torch.Tensor, y: torch.Tensor, single_eval_pos) -> torch.Tensor:
    """``model(x, y, single_eval_pos)`` with the layer stack on the fused
    kernel: (B, T, F), (B, T) -> (B, T, n_out) f32, every row decoded."""
    cfg = model.config
    reason = fused_supported(cfg, x.device)
    if reason is not None:
        raise ValueError(f"fused path does not support this config: {reason}")
    T = x.shape[1]
    if T > _ext.FUSED_MAX_SEQ:
        # The kernel holds a (32, T) f32 score row buffer per block: the
        # short-sequence regime. Long sequences belong to the flash kernels.
        raise ValueError(
            f"fused path is for short sequences (T <= {_ext.FUSED_MAX_SEQ}, got {T}) — use "
            "attention_impl='flash' for the long-context regime"
        )
    dtype = cfg.dtype
    with span("model.forward"):
        x_emb = model.encoder(x.to(dtype).float())
        y_emb = model.y_encoder(y[..., None].to(dtype).float())
        pos = torch.arange(T, device=x.device)[None, :, None]
        tokens = x_emb + torch.where(pos < single_eval_pos, y_emb, torch.zeros_like(y_emb))
        for layer in model.transformer_encoder.layers:
            tokens = fused_encoder_layer(tokens, _layer_params(layer), single_eval_pos, cfg.nhead, dtype)
        decoder_input = tokens.float()
        split_backward_at(decoder_input)  # the spans of PFNTransformer.forward (utils.profiling)
        with span("model.decoder") as s:
            if s is not None:
                s.rows = (x.shape[0] * T,) * 2  # every row
            return model.decoder(decoder_input)
