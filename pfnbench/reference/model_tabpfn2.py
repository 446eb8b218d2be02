"""The reference side of the ``tabpfn2`` model kind: TabPFN v2's
per-feature transformer (Hollmann et al., Nature 637, 319-326, 2025;
github.com/PriorLabs/TabPFN), its forward pass from its equations.

x (B, T, F), y (B, T) at sep s: rows < s are train rows.

* Inputs: mu and sigma, the mean and the population std of each dataset's
  feature over its train rows (0 and 1 where s = 0);
  x~ = clip((x - mu) / (sigma + 1e-6), -100, 100), padded with zero columns
  to G * P features, P = ``features_per_group``, G groups.
* Tokens of a row: group g's W_x x~_g + W_p r_g + b_p, with r_g the g-th row
  of a standard normal (G, emsize / 4) draw from a CPU generator seeded with
  ``embed_seed``; then the target's W_y [y_t, 0] + b_y on a train row,
  W_y [mean of the train y (0 where s = 0), 1] + b_y on a test row.
* Each layer, with LN(h) = (h - mean) / sqrt(var + 1e-5) over the width and
  attention softmax(q k^T / sqrt(Dh)) v, head by head, without bias:
  h = LN(h + W_o^f attn over the row's tokens);
  h = LN(h + W_o^i attn over the token column's rows), where a train row
  sees the train rows with each head's own q, k, v, and a test row sees the
  train rows with its head's q and head 0's k and v (no train row: 0);
  h = LN(h + W_2 gelu_erf(W_1 h + b_1) + b_2).
* The decoder W_d2 gelu_erf(W_d1 h + b_d1) + b_d2 on each row's target
  token.

Parameters are a dict by the port's state_dict names. ``prec`` maps a part
("enc": the embeddings; "feat", "item": each attention's projections and
products; "mlp"; "dec": the decoder) to a precision of :mod:`.precision`;
the reference itself is float32 throughout.
"""

from __future__ import annotations

import math

import torch

from pfnbench.reference.precision import BELOW, matmul

F32 = {"enc": "f32", "feat": "f32", "item": "f32", "mlp": "f32", "dec": "f32"}


def control(dtype: str) -> dict:
    """The control's precision of each part, for a model whose layers run
    in ``dtype``: both attentions and the MLP one step below it
    (``precision.BELOW``), its float32 embeddings and decoder and the
    prior in TF32."""
    low = BELOW[dtype]
    return {"enc": "tf32", "feat": low, "item": low, "mlp": low, "dec": "tf32", "prior": "tf32"}


def linear(x, w, b=None, mode="f32"):
    out = matmul(x, w.t(), mode)
    return out if b is None else out + b


def gelu_erf(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def layer_norm(x, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def attend(q, k, v, mode="f32"):
    """softmax(q k^T / sqrt(Dh)) v over the last two axes."""
    s = matmul(q, k.transpose(-1, -2), mode) / math.sqrt(q.shape[-1])
    return matmul(torch.softmax(s, dim=-1), v, mode)


def heads(qkv, nhead):
    """(..., L, 3 D) -> q, k, v each (..., H, L, Dh)."""
    *lead, L, three_d = qkv.shape
    D = three_d // 3
    x = qkv.reshape(*lead, L, 3, nhead, D // nhead)
    return [x[..., i, :, :].transpose(-2, -3) for i in range(3)]


def merge(o):
    """(..., H, L, Dh) -> (..., L, H Dh)."""
    o = o.transpose(-2, -3)
    return o.reshape(*o.shape[:-2], -1)


def feature_attention(h, w_qkv, w_o, nhead, mode):
    """h (B, T, C, D): each row's C tokens attend to each other."""
    q, k, v = heads(linear(h, w_qkv, mode=mode), nhead)
    return linear(merge(attend(q, k, v, mode)), w_o, mode=mode)


def item_attention(h, w_qkv, w_o, nhead, sep: int, mode):
    """h (B, T, C, D): each token column's rows attend to its train rows."""
    cols = h.transpose(1, 2)  # (B, C, T, D)
    q, k, v = heads(linear(cols, w_qkv, mode=mode), nhead)  # (B, C, H, T, Dh)
    B, C, T, _ = cols.shape
    if sep == 0:
        o = torch.zeros_like(q)
    else:
        kt, vt = k[..., :sep, :], v[..., :sep, :]
        train = attend(q[..., :sep, :], kt, vt, mode)
        shared = (B, C, nhead, sep, q.shape[-1])
        test = attend(q[..., sep:, :], kt[:, :, :1].expand(shared), vt[:, :, :1].expand(shared), mode)
        o = torch.cat([train, test], dim=-2)
    return linear(merge(o), w_o, mode=mode).transpose(1, 2)


def group_codes(model: dict, groups: int, device) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(model["embed_seed"])
    return torch.randn(groups, model["emsize"] // 4, generator=g, device="cpu").to(device)


def forward(params: dict, model: dict, x, y, sep: int, prec: dict = F32):
    """Logits (B, T, n_out) of x (B, T, F) and y (B, T) at ``sep``, for the
    model of sizes ``model`` (the config's ``model``)."""
    nhead, P = model["nhead"], model["features_per_group"]
    x, y = x.float(), y.float()
    B, T, nf = x.shape
    G = math.ceil(nf / P)
    if sep > 0:
        mu = x[:, :sep].mean(1, keepdim=True)
        sigma = x[:, :sep].std(1, keepdim=True, correction=0)
        y_mean = y[:, :sep].mean(1, keepdim=True)
    else:
        mu, sigma, y_mean = torch.zeros_like(x[:, :1]), torch.ones_like(x[:, :1]), torch.zeros_like(y[:, :1])
    xn = ((x - mu) / (sigma + 1e-6)).clamp(-100.0, 100.0)
    xn = torch.cat([xn, xn.new_zeros(B, T, G * P - nf)], dim=-1).reshape(B, T, G, P)
    codes = linear(group_codes(model, G, x.device), params["encoder.group_proj.weight"],
                   params["encoder.group_proj.bias"], prec["enc"])
    groups = linear(xn, params["encoder.x_proj.weight"], mode=prec["enc"]) + codes
    is_test = (torch.arange(T, device=x.device) >= sep).float().expand(B, T)
    y_in = torch.cat([y[:, :sep], y_mean.expand(B, T - sep)], dim=1)
    target = linear(torch.stack([y_in, is_test], dim=-1), params["y_encoder.weight"], params["y_encoder.bias"],
                    prec["enc"])
    h = torch.cat([groups, target[:, :, None]], dim=2)  # (B, T, C, D)
    for n in range(model["nlayers"]):
        p = lambda name: params[f"transformer.layers.{n}.{name}"]  # noqa: E731
        h = layer_norm(h + feature_attention(h, p("feat_attn.in_proj_weight"), p("feat_attn.out_proj.weight"),
                                             nhead, prec["feat"]))
        h = layer_norm(h + item_attention(h, p("item_attn.in_proj_weight"), p("item_attn.out_proj.weight"), nhead,
                                          sep, prec["item"]))
        f = gelu_erf(linear(h, p("linear1.weight"), p("linear1.bias"), prec["mlp"]))
        h = layer_norm(h + linear(f, p("linear2.weight"), p("linear2.bias"), prec["mlp"]))
    d = gelu_erf(linear(h[:, :, -1], params["decoder.0.weight"], params["decoder.0.bias"], prec["dec"]))
    return linear(d, params["decoder.2.weight"], params["decoder.2.bias"], prec["dec"])


def block_rows(model: dict, n_out: int, T: int, budget_bytes: float = 16e9) -> int:
    """Datasets a block, so that a block's saved activations stay near
    ``budget_bytes``: a layer keeps the item attention's probabilities (the
    token columns times the heads times T x T at most) and about 24
    float32 copies of the (T, width) tokens of a column; the columns are
    taken as 64, a wide table's."""
    columns, H, D = 64, model["nhead"], model["emsize"]
    per = model["nlayers"] * 4 * columns * (H * T * T + 24 * T * D)
    return max(1, int(budget_bytes // per))
