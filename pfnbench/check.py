"""The comparison that decides ``correct``: each number beside its limit.

Train cells compare, against the reference's first three updates:

* ``batch_gap``: the largest absolute difference between the program's
  microbatches (x and y) and the reference's, drawn again from the same
  generator seed; y labels within 1e-5 of their threshold are left out.
* ``sep_gap``: the microbatches whose sep differs, from each update's
  histogram of seps (exact: limit 0).
* ``loss_gap``: the largest relative gap of an update's loss.
* ``grad_gap``: the first update's clipped gradient as the optimizer got it
  (Adam's first moment after one step, over 1 - b1), by the worst leaf: the
  gap between the program's norm of the leaf and the reference's, over the
  larger of the reference's norm of that leaf and of the median leaf.
* ``change_gap``: the same for the parameters' change after three updates,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (the others move under Adam by round-off alone).
* ``change_median_gap``: the median over those leaves of the same gap, the
  steadier number where one small leaf's change swings from seed to seed
  (the recipe's query bias: Adam moves every entry by about lr whatever its
  size, so bf16 noise in a small gradient flips the sign of some entries).

A cell's ``limits`` name the numbers it compares; the others are reported
and not compared.

The score cell compares ``logit_tv``: the largest total-variation distance
between the program's and the reference's softmax of a scored row.
"""

from __future__ import annotations

import statistics

import torch

LABEL_MARGIN = 1e-5
QUIET_LEAF = 1e-3
# Packed parameters whose parts are separate leaves of the model: the
# attention's stacked query, key and value projections.
PACKED = ("in_proj_weight", "in_proj_bias")


def leaf_norms(tensors: dict) -> dict:
    """{leaf: float64 norm} of {parameter name: tensor}; a packed
    projection counts as its three parts (``.q``, ``.k``, ``.v``), so that
    the key bias, which the softmax ignores, is a leaf of its own."""
    out = {}
    for name, t in tensors.items():
        t = t.detach().double()
        if name.endswith(PACKED):
            for part, piece in zip("qkv", t.chunk(3, dim=0)):
                out[f"{name}.{part}"] = float(piece.norm())
        else:
            out[name] = float(t.norm())
    return out


def adopt_ambiguous_labels(program: list, reference: list) -> int:
    """Give the reference's microbatches the program's label wherever the
    seed's uniform lies within LABEL_MARGIN of its probability: rounding
    decides those labels, not the sampler (about one in 30 runs of the BNN
    cell flips one of its 230 400 labels, and one flipped label moves the
    loss by ~4e-6). ``batch_gap`` leaves the same labels out. Returns how
    many labels were taken."""
    taken = 0
    for p, r in zip(program, reference, strict=True):
        if "margin" in r:
            ambiguous = r["margin"] < LABEL_MARGIN
            taken += int((ambiguous & (p["y"].double() != r["y"])).sum())
            r["y"] = torch.where(ambiguous, p["y"].double(), r["y"])
    return taken


def batch_gap(program: list, reference: list) -> float:
    gap = 0.0
    for p, r in zip(program, reference, strict=True):
        gap = max(gap, float((p["x"].double() - r["x"].double()).abs().max()))
        dy = (p["y"].double() - r["y"].double()).abs()
        if "margin" in r:
            dy = torch.where(r["margin"] < LABEL_MARGIN, torch.zeros_like(dy), dy)
        gap = max(gap, float(dy.max()))
    return gap


def sep_gap(program_counts: list, reference_seps: list, bptt: int) -> float:
    """Half the L1 distance between each update's sep histograms."""
    gap = 0.0
    for counts, seps in zip(program_counts, reference_seps, strict=True):
        ref = torch.zeros(bptt, dtype=torch.float64)
        for s in seps:
            ref[s] += 1
        gap += 0.5 * float((counts.double().cpu() - ref).abs().sum())
    return gap


def relative_gap(program: list, reference: list) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference, strict=True))


def leaf_gaps(program: dict, reference: dict, keep=None) -> dict:
    """{leaf: |program norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf}."""
    names = [n for n in reference if keep is None or keep(n)]
    median = statistics.median(reference[n] for n in names)
    return {n: abs(program[n] - reference[n]) / max(reference[n], median) for n in names}


def leaf_gap(program: dict, reference: dict, keep=None) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return max(leaf_gaps(program, reference, keep).values())


def worst_leaves(program: dict, reference: dict) -> dict:
    """The leaf that sets ``grad_gap`` and ``change_gap``, for the record."""
    grads = reference["grad_leaf_norms"]
    median = statistics.median(grads.values())
    out = {}
    for name, key, keep in (("grad_gap", "grad_leaf_norms", None),
                            ("change_gap", "change_leaf_norms", lambda n: grads[n] >= QUIET_LEAF * median)):
        gaps = leaf_gaps(program[key], reference[key], keep)
        out[name] = max(gaps, key=gaps.get)
    return out


def train_numbers(program: dict, reference: dict, bptt: int) -> dict:
    grads = reference["grad_leaf_norms"]
    median = statistics.median(grads.values())
    moved = lambda n: grads[n] >= QUIET_LEAF * median  # noqa: E731
    changes = leaf_gaps(program["change_leaf_norms"], reference["change_leaf_norms"], moved)
    return {"batch_gap": batch_gap(program["batches"], reference["batches"]),
            "sep_gap": sep_gap(program["pos_cnt"], reference["seps"], bptt),
            "loss_gap": relative_gap(program["losses"], reference["losses"]),
            "grad_gap": leaf_gap(program["grad_leaf_norms"], grads),
            "change_gap": max(changes.values()),
            "change_median_gap": statistics.median(changes.values())}


def logit_tv(program: torch.Tensor, reference: torch.Tensor) -> float:
    """Largest total-variation distance between two (..., K) logit rows."""
    p = torch.softmax(program.double(), dim=-1)
    r = torch.softmax(reference.double(), dim=-1)
    return float(0.5 * (p - r).abs().sum(-1).max())


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(every number named in ``limits`` within its limit, [[name, number,
    limit]]). A number that is missing or not finite fails."""
    checks = [[name, numbers.get(name), limit] for name, limit in limits.items()]
    ok = all(value is not None and value == value and value <= limit for _, value, limit in checks)
    return ok, checks
