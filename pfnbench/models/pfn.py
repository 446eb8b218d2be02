"""The ``pfn`` model kind: the port's ``PFNTransformer`` as
``pfn_tpu_torch.train.build_model`` builds it (x and y encoders, post-LN
encoder layers, the Linear-GELU-Linear decoder), and the work its inputs
require. Its reference side is ``reference/model_pfn.py``.

A model kind's module gives the harness:

* ``parameter_shapes(model, num_features, n_out)``: {torch state_dict name:
  shape}, in the order ``weights.make`` draws them (a name holding
  ``.norm`` is a LayerNorm's gain or bias);
* ``build(cfg, device, weights, borders, **train)``: (prior, criterion,
  TrainConfig, model) of configuration ``cfg``, the model holding
  ``weights``; ``train`` holds the TrainConfig fields of the cell;
* ``train_flops(model, num_features, n_out, batch_size, T, seps)`` and
  ``score_flops(model, num_features, n_out, datasets, positions)``: the
  operations an update or a scoring pass requires, by ``flops.py``'s rule;
* ``attention_calls(model, batch_size, T, seps_or_positions, kind)``: the
  flash-attention passes of one update (``kind`` "train", a sep each) or of
  one scoring pass ("score", a position each), as ``metrics/attn_roofline``
  reads them.

``model`` is the config's ``model`` object.
"""

from __future__ import annotations

import torch

from pfnbench import flops, spec

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parameter_shapes(model: dict, num_features: int, n_out: int) -> dict:
    """{torch state_dict name: shape} of the PFN of ``model``'s sizes."""
    D, F, L = model["emsize"], model["nhid"], model["nlayers"]
    shapes = {"encoder.weight": (D, num_features), "encoder.bias": (D,), "y_encoder.weight": (D, 1),
              "y_encoder.bias": (D,)}
    for n in range(L):
        p = f"transformer_encoder.layers.{n}."
        shapes.update({p + "self_attn.in_proj_weight": (3 * D, D), p + "self_attn.in_proj_bias": (3 * D,),
                       p + "self_attn.out_proj.weight": (D, D), p + "self_attn.out_proj.bias": (D,),
                       p + "linear1.weight": (F, D), p + "linear1.bias": (F,),
                       p + "linear2.weight": (D, F), p + "linear2.bias": (D,),
                       p + "norm1.weight": (D,), p + "norm1.bias": (D,),
                       p + "norm2.weight": (D,), p + "norm2.bias": (D,)})
    shapes.update({"decoder.0.weight": (F, D), "decoder.0.bias": (F,), "decoder.2.weight": (n_out, F),
                   "decoder.2.bias": (n_out,)})
    return shapes


def build(cfg: dict, device, weights: dict, borders, **train):
    """(prior, criterion, TrainConfig, model) of configuration ``cfg``;
    ``train`` holds the TrainConfig fields of the cell (batch, microbatches)."""
    from pfn_tpu_torch.train import TrainConfig, build_model

    m = cfg["model"]
    prior = spec.program_prior(cfg["prior"]["kind"]).program(cfg["prior"])
    criterion = spec.program_criterion(cfg["criterion"]["kind"]).program(borders).to(device)
    t = cfg["train"]
    tcfg = TrainConfig(emsize=m["emsize"], nhid=m["nhid"], nlayers=m["nlayers"], nhead=m["nhead"],
                       dtype=DTYPES[m["dtype"]], bptt=t["bptt"], lr=t["lr"], eval_pos_sampler=t["eval_pos_sampler"],
                       eval_pos_max=t.get("eval_pos_max"), device=device, verbose=False, **train)
    with torch.device(device):
        model = build_model(prior, criterion, tcfg)
    model.load_state_dict(weights, strict=True)
    return prior, criterion, tcfg, model


def layer_weights(model: dict) -> int:
    """Weights of one encoder layer's four products."""
    D, F = model["emsize"], model["nhid"]
    return 3 * D * D + D * D + 2 * D * F


def forward_flops(model: dict, num_features: int, n_out: int, datasets: int, rows: int, pairs: int,
                  decoder_rows: int) -> float:
    """One forward of ``datasets`` datasets, each with ``rows`` encoder rows
    and ``pairs`` attention pairs a head, and ``decoder_rows`` decoded rows
    in all."""
    D, F, L, H = model["emsize"], model["nhid"], model["nlayers"], model["nhead"]
    encoder = 2.0 * datasets * rows * (L * layer_weights(model) + num_features * D + D)
    attention = 2.0 * 2 * L * datasets * H * pairs * (D // H)
    decoder = 2.0 * decoder_rows * (D * F + F * n_out)
    return encoder + attention + decoder


def train_flops(model: dict, num_features: int, n_out: int, batch_size: int, T: int, seps) -> float:
    """An update's required operations over microbatches with ``seps``."""
    return sum(3.0 * forward_flops(model, num_features, n_out, batch_size, T, flops.pfn_pairs(T, s),
                                   batch_size * (T - s)) for s in seps)


def score_flops(model: dict, num_features: int, n_out: int, datasets: int, positions) -> float:
    """A scoring pass's required operations: for each position p, the rows
    0 .. p and the one decoded row."""
    return sum(forward_flops(model, num_features, n_out, datasets, p + 1, flops.pfn_pairs(p + 1, p), datasets)
               for p in positions)


def attention_calls(model: dict, batch_size: int, T: int, seps_or_positions, kind: str) -> list[dict]:
    """The flash-attention passes of one update over microbatches with these
    seps (``kind`` "train": a forward and a backward each, in every layer),
    or of one scoring pass at these positions ("score": a forward over the
    rows 0 .. p at sep p, in every layer)."""
    BH, D, L, dtype = batch_size * model["nhead"], model["emsize"] // model["nhead"], model["nlayers"], model["dtype"]
    if kind == "train":
        return [{"BH": BH, "T": T, "D": D, "sep": s, "dtype": dtype, "backward": backward, "count": L}
                for s in seps_or_positions for backward in (False, True)]
    if kind == "score":
        return [{"BH": BH, "T": p + 1, "D": D, "sep": p, "dtype": dtype, "backward": False, "count": L}
                for p in seps_or_positions]
    raise ValueError(f"unknown traffic kind {kind!r}")
