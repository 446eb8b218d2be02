"""The reference's scoring: the logits of row p of a forward at sep = p.

Row p attends to the rows below p and to itself, and each of those rows to
the rows below p only, so rows after p change nothing: the reference runs
the rows 0 .. p alone.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def logits_at(net, params: dict, model: dict, x, y, positions, prec: dict | None = None, block: int = 8):
    """(len(positions), B, n_out) float32 logits of ``net``, the reference
    model of the configuration's kind (``part("model", kind)``), of sizes
    ``model``; ``prec`` None is ``net.F32``."""
    prec = net.F32 if prec is None else prec
    rows = []
    for p in positions:
        parts = []
        for s in range(0, x.shape[0], block):
            xb, yb = x[s:s + block, :p + 1].float(), y[s:s + block, :p + 1].float()
            parts.append(net.forward(params, model, xb, yb, p, prec)[:, p])
        rows.append(torch.cat(parts))
    return torch.stack(rows)
