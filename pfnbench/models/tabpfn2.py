"""The ``tabpfn2`` model kind: TabPFN v2's per-feature transformer as
``pfn_tpu_torch.train.build_model`` builds it with ``model_kind="tabpfn2"``
(``models/per_feature.py``), and the work its inputs require. Its reference
side is ``reference/model_tabpfn2.py``. The config's ``model`` gives
``emsize``, ``nhid``, ``nlayers``, ``nhead``, ``dtype``,
``features_per_group`` and ``embed_seed`` (the seed of the groups' fixed
codes), which the reference reads and the port holds as its published
constants (``FEATURES_PER_GROUP``, ``EMBED_SEED``: :func:`build` refuses a
config that states others), and ``num_features``, the tables' width, which
sets the tokens a row (it must equal the prior's: ``attention_calls`` is
given the model alone).

The counts follow ``flops.py``'s rule. A row holds C = ceil(F / G) + 1
tokens (the feature groups and the target). Products: 2 operations a weight
on every token (both attentions' qkv and out-projections, the MLP's two),
the feature embedding on every group token and the target embedding on
every target token, the groups' codes once a forward. Attention: 2
operations a head-dim entry and allowed pair, 2 products forward, 4
backward; across features C^2 pairs a row, across rows sep * T pairs a
token column (each train row sees the sep train rows, each test row the
sep train rows), for every head. The decoder on the rows >= sep in
training, on the one returned row in scoring. An update is 3 forwards.

The criterion's module is called ``program(borders, cfg)`` with the
criterion's config (the ``ce`` kind reads its number of classes there).
"""

from __future__ import annotations

import math

from pfnbench import flops, spec
from pfnbench.models.pfn import DTYPES


def groups(model: dict, num_features: int) -> int:
    return math.ceil(num_features / model["features_per_group"])


def parameter_shapes(model: dict, num_features: int, n_out: int) -> dict:
    """{torch state_dict name: shape} of the per-feature model (no
    LayerNorm parameters: its LayerNorms have no gain or bias)."""
    D, Fh, L = model["emsize"], model["nhid"], model["nlayers"]
    shapes = {"encoder.x_proj.weight": (D, model["features_per_group"]), "encoder.group_proj.weight": (D, D // 4),
              "encoder.group_proj.bias": (D,), "y_encoder.weight": (D, 2), "y_encoder.bias": (D,)}
    for n in range(L):
        p = f"transformer.layers.{n}."
        for attn in ("feat_attn", "item_attn"):
            shapes.update({p + attn + ".in_proj_weight": (3 * D, D), p + attn + ".out_proj.weight": (D, D)})
        shapes.update({p + "linear1.weight": (Fh, D), p + "linear1.bias": (Fh,), p + "linear2.weight": (D, Fh),
                       p + "linear2.bias": (D,)})
    shapes.update({"decoder.0.weight": (Fh, D), "decoder.0.bias": (Fh,), "decoder.2.weight": (n_out, Fh),
                   "decoder.2.bias": (n_out,)})
    return shapes


def build(cfg: dict, device, weights: dict, borders, **train):
    """(prior, criterion, TrainConfig, model) of configuration ``cfg``;
    ``train`` holds the TrainConfig fields of the cell."""
    import torch

    from pfn_tpu_torch.models.per_feature import EMBED_SEED, FEATURES_PER_GROUP
    from pfn_tpu_torch.train import TrainConfig, build_model

    m, t, c = cfg["model"], cfg["train"], cfg["criterion"]
    if m["num_features"] != cfg["prior"]["num_features"]:
        raise ValueError(f"model.num_features {m['num_features']} is not the prior's {cfg['prior']['num_features']}")
    for key, port in (("features_per_group", FEATURES_PER_GROUP), ("embed_seed", EMBED_SEED)):
        if m[key] != port:
            raise ValueError(f"model.{key} {m[key]} is not the port's published {port}")
    prior = spec.program_prior(cfg["prior"]["kind"]).program(cfg["prior"])
    criterion = spec.program_criterion(c["kind"]).program(borders, c).to(device)
    tcfg = TrainConfig(emsize=m["emsize"], nhid=m["nhid"], nlayers=m["nlayers"], nhead=m["nhead"],
                       dtype=DTYPES[m["dtype"]], bptt=t["bptt"], lr=t["lr"], eval_pos_sampler=t["eval_pos_sampler"],
                       eval_pos_max=t.get("eval_pos_max"), device=device, verbose=False, model_kind="tabpfn2", **train)
    with torch.device(device):
        model = build_model(prior, criterion, tcfg)
    model.load_state_dict(weights, strict=True)
    return prior, criterion, tcfg, model


def token_weights(model: dict) -> int:
    """Weights of one layer's products that every token goes through."""
    D = model["emsize"]
    return 2 * 4 * D * D + 2 * D * model["nhid"]


def forward_flops(model: dict, num_features: int, n_out: int, datasets: int, rows: int, sep: int,
                  decoder_rows: int) -> float:
    """One forward of ``datasets`` datasets of ``rows`` rows at ``sep``,
    with ``decoder_rows`` decoded rows in all."""
    D, Fh, L = model["emsize"], model["nhid"], model["nlayers"]
    G = groups(model, num_features)
    C = G + 1
    tokens = datasets * rows * C
    products = 2.0 * tokens * L * token_weights(model)
    embed = 2.0 * datasets * rows * (G * model["features_per_group"] * D + 2 * D) + 2.0 * G * (D // 4) * D
    features = 2.0 * 2 * L * D * datasets * rows * C * C
    items = 2.0 * 2 * L * D * datasets * C * sep * rows
    decoder = 2.0 * decoder_rows * (D * Fh + Fh * n_out)
    return products + embed + features + items + decoder


def train_flops(model: dict, num_features: int, n_out: int, batch_size: int, T: int, seps) -> float:
    """An update's required operations over microbatches with ``seps``."""
    return sum(3.0 * forward_flops(model, num_features, n_out, batch_size, T, s, batch_size * (T - s)) for s in seps)


def score_flops(model: dict, num_features: int, n_out: int, datasets: int, positions) -> float:
    """A scoring pass's required operations: for each position p, the rows
    0 .. p at sep p and the one decoded row."""
    return sum(forward_flops(model, num_features, n_out, datasets, p + 1, p, datasets) for p in positions)


def _item_calls(model: dict, datasets: int, C: int, T: int, sep: int, backward: bool) -> list[dict]:
    """The two item-attention calls of one layer at ``sep`` over ``T`` rows:
    the train rows with every head, the test rows folded into one head
    against head 0's keys; a call with no query row is not made."""
    H, Dh = model["nhead"], model["emsize"] // model["nhead"]
    calls = [{"model": "tabpfn2", "BH": datasets * C * H, "Tq": sep, "keys": sep},
             {"model": "tabpfn2", "BH": datasets * C, "Tq": H * (T - sep), "keys": sep}]
    return [dict(c, D=Dh, dtype=model["dtype"], backward=backward, count=model["nlayers"]) for c in calls if c["Tq"]]


def attention_calls(model: dict, batch_size: int, T: int, seps_or_positions, kind: str) -> list[dict]:
    """The item-attention (flash) passes of one update over microbatches
    with these seps (``kind`` "train": forward and backward in every
    layer) or of one scoring pass at these positions ("score": forward over
    the rows 0 .. p at sep p). Each is {"BH", "Tq" query rows, "keys"
    allowed keys a row, "D", "dtype", "backward", "count"}, read by
    :func:`attention_bound_s`."""
    C = groups(model, model["num_features"]) + 1
    if kind == "train":
        return [c for s in seps_or_positions for backward in (False, True)
                for c in _item_calls(model, batch_size, C, T, s, backward)]
    if kind == "score":
        return [c for p in seps_or_positions for c in _item_calls(model, batch_size, C, p + 1, p, False)]
    raise ValueError(f"unknown traffic kind {kind!r}")


def attention_bound_s(call: dict) -> float:
    """Least time of one item-attention pass of :func:`attention_calls`:
    the larger of its operations over the peak of its dtype and its unique
    bytes over the HBM rate. Operations: 2 a head-dim entry and allowed
    pair, 2 products forward, 4 backward. Bytes: forward q in and o out
    (Tq rows), k and v in (the allowed keys), one f32 logsumexp a row;
    backward q, dO in and dq out, k, v in and dk, dv out, the logsumexp and
    the row dot products."""
    BH, Tq, keys, D = call["BH"], call["Tq"], call["keys"], call["D"]
    e = flops.ELEMENT_BYTES[call["dtype"]]
    ops = 2.0 * (4 if call["backward"] else 2) * D * BH * Tq * keys
    q, kv, row = BH * Tq * D * e, BH * keys * D * e, BH * Tq * 4
    nbytes = (3 * q + 4 * kv + 2 * row) if call["backward"] else (2 * q + 2 * kv + row)
    return max(ops / flops.PEAK_FLOPS[call["dtype"]], nbytes / flops.HBM_BYTES_PER_S)
