"""The reference side of the ``pfn`` model kind: the PFN transformer's
forward pass, from its equations.

Tokens: encoder(x) + y_encoder(y) on the rows below ``sep``, encoder(x)
alone on the rows at and after it. Each encoder layer is post-LN:
h = LN1(t + Attn(t)), t' = LN2(h + W2 gelu_tanh(W1 h + b1) + b2), with
multi-head attention whose query i sees the keys j < sep and, at or after
sep, also itself. The decoder is Linear-GELU(tanh)-Linear on every row.
Parameters are a dict by the torch names of the reference model's
state_dict. ``prec`` maps a part of the model ("enc": the layers' four
products, "attn": the two attention products, "dec": the decoder) to a
precision of :mod:`.precision`; the reference itself is float32 throughout.

A reference model module gives ``forward(params, model, x, y, sep, prec)``
(logits of every row), ``block_rows(model, n_out, T)`` (datasets a block of
the training reference), ``F32`` (its parts all in float32) and
``control(dtype)`` (the control's ``prec``, with the prior's precision
under "prior").
"""

from __future__ import annotations

import math

import torch

from pfnbench.reference.precision import BELOW, matmul

F32 = {"enc": "f32", "attn": "f32", "dec": "f32"}


def control(dtype: str) -> dict:
    """The control's precision of each part, for a model whose products run
    in ``dtype``: its layers and attention one step below it
    (``precision.BELOW``), its float32 decoder and the prior ("prior", read
    by ``reference.train.replay``) in TF32."""
    return {"enc": BELOW[dtype], "attn": BELOW[dtype], "dec": "tf32", "prior": "tf32"}


def linear(x, w, b, mode="f32"):
    return matmul(x, w.t(), mode) + b


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def layer_norm(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def pfn_attention(q, k, v, sep: int, mode="f32"):
    """q, k, v (B, H, T, Dh): softmax(q k^T / sqrt(Dh)) v over the allowed
    keys, j < sep or j == i."""
    T, D = q.shape[-2], q.shape[-1]
    s = matmul(q, k.transpose(-1, -2), mode) / math.sqrt(D)
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    allowed = (j < sep) | (j == i)
    p = torch.softmax(s.masked_fill(~allowed, float("-inf")), dim=-1)
    return matmul(p, v, mode)


def forward(params: dict, model: dict, x, y, sep: int, prec: dict = F32):
    """Logits (B, T, n_out) of x (B, T, F) and y (B, T) at ``sep``, for the
    model of sizes ``model`` (the config's ``model``)."""
    nlayers, nhead = model["nlayers"], model["nhead"]
    B, T, _ = x.shape
    pos = torch.arange(T, device=x.device)[None, :, None]
    x_emb = linear(x, params["encoder.weight"], params["encoder.bias"])
    y_emb = linear(y[..., None], params["y_encoder.weight"], params["y_encoder.bias"])
    t = x_emb + torch.where(pos < sep, y_emb, torch.zeros_like(y_emb))
    D = t.shape[-1]
    for n in range(nlayers):
        p = lambda name: params[f"transformer_encoder.layers.{n}.{name}"]  # noqa: E731
        qkv = linear(t, p("self_attn.in_proj_weight"), p("self_attn.in_proj_bias"), prec["enc"])
        q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(B, T, nhead, D // nhead).transpose(1, 2) for i in range(3))
        a = pfn_attention(q, k, v, sep, prec["attn"]).transpose(1, 2).reshape(B, T, D)
        a = linear(a, p("self_attn.out_proj.weight"), p("self_attn.out_proj.bias"), prec["enc"])
        h = layer_norm(t + a, p("norm1.weight"), p("norm1.bias"))
        f = gelu_tanh(linear(h, p("linear1.weight"), p("linear1.bias"), prec["enc"]))
        f = linear(f, p("linear2.weight"), p("linear2.bias"), prec["enc"])
        t = layer_norm(h + f, p("norm2.weight"), p("norm2.bias"))
    d = gelu_tanh(linear(t, params["decoder.0.weight"], params["decoder.0.bias"], prec["dec"]))
    return linear(d, params["decoder.2.weight"], params["decoder.2.bias"], prec["dec"])


def block_rows(model: dict, n_out: int, T: int, budget_bytes: float = 16e9) -> int:
    """Datasets a block, so that a block's activations stay near ``budget_bytes``."""
    per = model["nlayers"] * 3 * model["nhead"] * T * T * 4 + 4 * T * n_out * 4 + 12 * T * model["nhid"] * 4
    return max(1, int(budget_bytes // per))
