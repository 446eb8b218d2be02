"""The yardstick: the operations and bytes the inputs need, and the peaks.

Counted is the work these inputs require, never what the program happens to
run, so that a change that skips wasted work cannot read above 100 %. Each
model kind counts its own products by this rule (``models/<kind>.py``:
``train_flops``, ``score_flops``); for the ``pfn`` kind:

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
