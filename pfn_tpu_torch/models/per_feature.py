"""TabPFN v2's per-feature transformer.

Hollmann et al., "Accurate predictions on small data with a tabular
foundation model", Nature 637, 319-326 (2025); github.com/PriorLabs/TabPFN.
Each cell of the table is a token: a row of F features holds ceil(F / G)
feature-group tokens (G features each, F padded with zero columns) and one
target token, C = ceil(F / G) + 1 tokens a row. ``model(x, y, sep)`` takes
x (B, T, F), y (B, T) and sep s, as ``PFNTransformer`` does: rows < s are
train rows, rows >= s test rows, whose y is never read.

  1. Inputs: each dataset's features are z-scored over its train rows
     (population std), x~ = clip((x - mu) / (sigma + 1e-6), -100, 100); with
     no train row mu = 0 and sigma = 1.
  2. Group g's token: W_x x~_g + W_p r_g + b_p, r_g a fixed vector of
     emsize / 4 entries drawn once from ``EMBED_SEED`` (the subspace
     embedding: r_g fixed, W_p learned).
  3. The target token: W_y [y, 0] + b_y on train rows, W_y [mean train y, 1]
     + b_y on test rows (mean 0 with no train row).
  4. Each layer, post-norm, LayerNorms without gain or bias (eps 1e-5):
     h = LN(h + MHA_feat(h)), full attention over a row's C tokens;
     h = LN(h + MHA_item(h)), for each token column: train rows attend to
     the train rows with every head, test rows to the train rows with their
     own queries and head 0's keys and values (multi-query);
     h = LN(h + W_2 gelu_erf(W_1 h + b_1) + b_2).
  5. The decoder, Linear-GELU(erf)-Linear, on the target token of the rows
     ``rows=(start, stop)`` names (every row where None), as
     ``PFNTransformer`` decodes them.

The attention's projections have no bias. The item attention is two calls
of the flash kernels' prefix variant a layer (:func:`item_attention`), so it
needs sep on the host: a sep given as a tensor is copied there as the
forward starts (``utils.samplers.HostSep``; the training loop's own copy
where ``rows`` starts with it) and waited for only once the first layer's
feature attention is enqueued. The feature attention is
``torch.nn.functional.scaled_dot_product_attention``: on the card its fused
kernels, which keep no (C, C) matrix for the backward, beat the port's dense
path at these rows (PERF.md §6).

Precision as ``PFNTransformer``'s: the layers' products and both attentions
in the compute dtype; the input normalisation, the embeddings, the
LayerNorms, the residual stream and the decoder in float32. One device: no
mesh, no dropout, no fused path (``train.build_model`` raises on them).
"""

from __future__ import annotations

import dataclasses
import operator

import torch
import torch.nn.functional as F
from torch import nn

from pfn_tpu_torch.models.decoders import MLPDecoder
from pfn_tpu_torch.models.init import lecun_normal_
from pfn_tpu_torch.ops.flash_attention import pfn_flash_prefix_attention
from pfn_tpu_torch.utils.profiling import span, split_backward_at
from pfn_tpu_torch.utils.samplers import HostSep

LN_EPS = 1e-5
NORM_EPS = 1e-6
CLIP = 100.0
# Published: features in groups of 2. The groups' fixed codes r_g come from
# a CPU generator with this seed.
FEATURES_PER_GROUP = 2
EMBED_SEED = 42


@dataclasses.dataclass(frozen=True)
class PerFeatureConfig:
    """Sizes of the per-feature model."""

    num_features: int
    n_out: int
    emsize: int = 192
    nhead: int = 6
    nhid: int = 768
    nlayers: int = 12
    dtype: torch.dtype = torch.float32
    # Not a field: the training loop reads every model's config.mesh (the
    # loss, the clip, the LR's parameter count, checkpoints), and this model
    # runs on one device.
    mesh = None

    @property
    def groups(self) -> int:
        return -(-self.num_features // FEATURES_PER_GROUP)


def _norm(h: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(h.float(), h.shape[-1:], eps=LN_EPS)


def item_attention(q, k, v, sep: int) -> torch.Tensor:
    """q, k, v (N, H, T, Dh): rows < sep attend to keys < sep with every
    head; rows >= sep attend to keys < sep with their own queries and head
    0's keys and values. Two calls of the flash kernels' prefix variant:
    the train rows (N, H, sep, Dh) against K, V (N, H, T, Dh), and the test
    rows with the heads folded into the query rows, (N, 1, H (T - sep), Dh)
    against head 0's (N, 1, T, Dh). A row with no key to see (sep 0) gets 0.
    Returns (N, H, T, Dh)."""
    N, H, T, Dh = q.shape
    parts = []
    if sep > 0:
        parts.append(pfn_flash_prefix_attention(q[:, :, :sep], k, v, sep)[0])
    if sep < T:
        test = q[:, :, sep:].reshape(N, 1, H * (T - sep), Dh)
        parts.append(pfn_flash_prefix_attention(test, k[:, :1], v[:, :1], sep)[0].view(N, H, T - sep, Dh))
    return torch.cat(parts, dim=2) if len(parts) > 1 else parts[0]


class _Attention(nn.Module):
    """The projections of one multi-head attention, without bias: a packed
    qkv (``in_proj_weight``, xavier-uniform) and a zero-initialised
    out-projection."""

    def __init__(self, emsize: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * emsize, emsize))
        self.out_proj = nn.Linear(emsize, emsize, bias=False)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.weight)


class PerFeatureLayer(nn.Module):
    """One layer: attention across a row's features, attention across the
    rows of a token column, the MLP; each post-norm."""

    def __init__(self, emsize: int, nhead: int, nhid: int, dtype: torch.dtype):
        super().__init__()
        if emsize % nhead:
            raise ValueError(f"emsize {emsize} is not divisible by nhead {nhead}")
        self.nhead, self.dtype = nhead, dtype
        self.feat_attn = _Attention(emsize)
        self.item_attn = _Attention(emsize)
        self.linear1 = nn.Linear(emsize, nhid)
        self.linear2 = nn.Linear(nhid, emsize)
        lecun_normal_(self.linear1.weight)
        nn.init.zeros_(self.linear1.bias)
        nn.init.zeros_(self.linear2.weight)
        nn.init.zeros_(self.linear2.bias)

    def _qkv(self, attn: _Attention, h: torch.Tensor) -> torch.Tensor:
        """h (..., D) -> (..., 3, H, Dh) in the compute dtype."""
        qkv = F.linear(h.to(self.dtype), attn.in_proj_weight.to(self.dtype))
        return qkv.view(*h.shape[:-1], 3, self.nhead, h.shape[-1] // self.nhead)

    def forward(self, h: torch.Tensor, sep) -> torch.Tensor:
        """h (B, T, C, D) float32; ``sep`` an int or an object with
        ``__index__``, read once the feature attention is enqueued."""
        B, T, C, D = h.shape
        dt = self.dtype
        with span("model.attn_features"):
            q, k, v = self._qkv(self.feat_attn, h).view(B * T, C, 3, self.nhead, -1).permute(2, 0, 3, 1, 4)
            a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, T, C, D)
            h = _norm(h + F.linear(a, self.feat_attn.out_proj.weight.to(dt)).float())
        with span("model.attn_items"):
            qkv = self._qkv(self.item_attn, h).permute(3, 0, 2, 4, 1, 5).contiguous()  # (3, B, C, H, T, Dh)
            q, k, v = qkv.view(3, B * C, self.nhead, T, -1)
            a = item_attention(q, k, v, operator.index(sep)).view(B, C, self.nhead, T, -1)
            a = a.permute(0, 3, 1, 2, 4).reshape(B, T, C, D)
            h = _norm(h + F.linear(a, self.item_attn.out_proj.weight.to(dt)).float())
        f = F.gelu(F.linear(h.to(dt), self.linear1.weight.to(dt), self.linear1.bias.to(dt)))
        f = F.linear(f, self.linear2.weight.to(dt), self.linear2.bias.to(dt))
        return _norm(h + f.float())


class _Encoder(nn.Module):
    """The feature-group tokens: ``x_proj`` (W_x, no bias) of a group's
    normalised features plus ``group_proj`` (W_p, b_p) of its fixed code r_g
    (the buffer ``group_codes``, not saved: it is drawn from the seed)."""

    def __init__(self, c: PerFeatureConfig):
        super().__init__()
        self.x_proj = nn.Linear(FEATURES_PER_GROUP, c.emsize, bias=False)
        self.group_proj = nn.Linear(c.emsize // 4, c.emsize)
        lecun_normal_(self.x_proj.weight)
        lecun_normal_(self.group_proj.weight)
        nn.init.zeros_(self.group_proj.bias)
        g = torch.Generator(device="cpu").manual_seed(EMBED_SEED)
        codes = torch.randn(c.groups, c.emsize // 4, generator=g, device="cpu")
        self.register_buffer("group_codes", codes, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, G * FEATURES_PER_GROUP) normalised -> (B, T, G, D)."""
        B, T, _ = x.shape
        groups = x.view(B, T, self.group_codes.shape[0], -1)
        return self.x_proj(groups) + self.group_proj(self.group_codes)


class _Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class PerFeatureTransformer(nn.Module):
    """TabPFN v2's model: ``model(x, y, sep, generator=None, rows=None)`` ->
    (B, T, n_out), or (B, stop - start, n_out) with ``rows=(start, stop)``,
    as ``PFNTransformer``. ``sep``: an int, a one-element tensor, or an
    object with ``__index__``. ``generator`` is accepted for the loop's
    call and unused (no dropout)."""

    def __init__(self, config: PerFeatureConfig):
        super().__init__()
        self.config = c = config
        self.param_specs: dict = {}
        self.encoder = _Encoder(c)
        self.y_encoder = nn.Linear(2, c.emsize)
        lecun_normal_(self.y_encoder.weight)
        nn.init.zeros_(self.y_encoder.bias)
        self.transformer = _Stack(PerFeatureLayer(c.emsize, c.nhead, c.nhid, c.dtype) for _ in range(c.nlayers))
        self.decoder = MLPDecoder(c.emsize, c.nhid, c.n_out, approximate=False)

    def _tokens(self, x: torch.Tensor, y: torch.Tensor, sep: torch.Tensor) -> torch.Tensor:
        """(B, T, C, D) float32 tokens; ``sep`` a one-element device tensor."""
        B, T, nf = x.shape
        x, y = x.float(), y.float()
        train = (torch.arange(T, device=x.device) < sep).float()  # (T,)
        n = train.sum().clamp_min(1.0)
        w = train[None, :, None]
        mu = (x * w).sum(1, keepdim=True) / n
        sigma = ((((x - mu) * w) ** 2).sum(1, keepdim=True) / n).sqrt()
        sigma = torch.where(train.sum() > 0, sigma, torch.ones_like(sigma))
        x = ((x - mu) / (sigma + NORM_EPS)).clamp(-CLIP, CLIP)
        x = F.pad(x, (0, self.config.groups * FEATURES_PER_GROUP - nf))
        y_mean = (y * train).sum(1, keepdim=True) / n
        target = torch.stack([torch.where(train > 0, y, y_mean), 1.0 - train.expand_as(y)], dim=-1)
        return torch.cat([self.encoder(x), self.y_encoder(target)[:, :, None]], dim=2)

    def forward(self, x: torch.Tensor, y: torch.Tensor, single_eval_pos, generator: torch.Generator | None = None,
                rows=None) -> torch.Tensor:
        T = x.shape[1]
        if isinstance(single_eval_pos, torch.Tensor):
            sep_t = single_eval_pos.to(device=x.device).reshape(-1)[:1]
            # The training loop decodes rows (its copy of this sep, T): that copy serves.
            copied = rows[0] if rows is not None and isinstance(rows[0], HostSep) else None
            host = copied if copied is not None and copied.source is single_eval_pos else HostSep(sep_t)
        else:
            host = operator.index(single_eval_pos)
            sep_t = torch.full((1,), host, device=x.device)
        with span("model.forward"):
            h = self._tokens(x, y, sep_t)
            for layer in self.transformer.layers:
                h = layer(h, host)
            decoder_input = h[:, :, -1]
            split_backward_at(decoder_input)
            produced = decoder_input.shape[0] * T
            if rows is not None:
                start, stop = (operator.index(r) for r in rows)
                if not 0 <= start <= stop <= T:
                    raise ValueError(f"rows ({start}, {stop}) outside the {T} positions")
                decoder_input = decoder_input[:, start:stop]
            with span("model.decoder") as s:
                out = self.decoder(decoder_input)
                if s is not None:
                    s.rows = (decoder_input.shape[0] * decoder_input.shape[1], produced)
            return out
