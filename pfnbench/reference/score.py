"""The reference's scoring: the logits of row p of a forward at sep = p.

Row p attends to the rows below p and to itself, and each of those rows to
the rows below p only, so rows after p change nothing: the reference runs
the rows 0 .. p alone.
"""

from __future__ import annotations

import torch

from pfnbench.reference import model as ref_model


@torch.no_grad()
def logits_at(params: dict, model: dict, x, y, positions, prec: dict = ref_model.F32, block: int = 8):
    """(len(positions), B, n_out) float32 logits."""
    rows = []
    for p in positions:
        parts = []
        for s in range(0, x.shape[0], block):
            xb, yb = x[s:s + block, :p + 1].float(), y[s:s + block, :p + 1].float()
            parts.append(ref_model.forward(params, model["nlayers"], model["nhead"], xb, yb, p, prec)[:, p])
        rows.append(torch.cat(parts))
    return torch.stack(rows)
