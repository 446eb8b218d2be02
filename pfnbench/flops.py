"""The yardstick: the operations and bytes the inputs need, and the peaks.

Counted is the work these inputs require, never what the program happens to
run, so that a change that skips wasted work cannot read above 100 %:

* Encoder products (qkv, out-projection, the FFN's two) and the input
  encoders: 2 operations a weight and row, on every row the result needs.
* Attention: 2 operations a head-dim entry and (query, key) pair the PFN
  rule allows (every query sees the keys below sep, a query at or after sep
  also itself), for each product: 2 in the forward (Q K^T, P V), 4 in the
  backward (dP, dS K, dS^T Q, P^T dO), shared by the dq and dk/dv kernels;
  no recompute is counted.
* The decoder (and the loss) only on the rows that are scored: in training
  the rows at and after sep, in scoring the one row each scored position
  returns, whose encoder and attention count only on the rows 0 .. p.
* An update is 3 forward passes' work; a scoring pass one.
* Bytes: each input read once and each output written once.

Peaks: the NVIDIA H100 SXM's data sheet, dense: 989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s float32 outside them, 3.35 TB/s of HBM.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def pfn_pairs(T: int, sep: int) -> int:
    """(query, key) pairs the PFN rule allows over T rows at ``sep``."""
    s = min(max(sep, 0), T)
    return T * s + (T - s)


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
    return sum(3.0 * forward_flops(model, num_features, n_out, batch_size, T, pfn_pairs(T, s),
                                   batch_size * (T - s)) for s in seps)


def score_flops(model: dict, num_features: int, n_out: int, datasets: int, positions) -> float:
    """A scoring pass's required operations: for each position p, the rows
    0 .. p and the one decoded row."""
    return sum(forward_flops(model, num_features, n_out, datasets, p + 1, pfn_pairs(p + 1, p), datasets)
               for p in positions)


def attention_bound_s(BH: int, T: int, D: int, sep: int, dtype: str, backward: bool) -> float:
    """Least time of one PFN attention pass (forward, or the backward's dq
    and dk/dv together) over BH heads of T rows: the larger of its required
    operations over the peak of ``dtype`` and its bytes over the HBM rate.
    Forward bytes: q, k, v in, o out, one f32 logsumexp a row; backward: q,
    k, v, dO in, dq, dk, dv out, the logsumexp and the row dot products."""
    products = 4 if backward else 2
    flops = 2.0 * products * D * BH * pfn_pairs(T, sep)
    tensor = BH * T * D * ELEMENT_BYTES[dtype]
    row = BH * T * 4
    nbytes = (7 * tensor + 2 * row) if backward else (4 * tensor + row)
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
