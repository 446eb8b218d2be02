"""The Bayesian-neural-network prior of the reference's BNN comparison,
with C = ``num_classes`` label classes (``prior_bnn.py`` is C = 2).

Datasets come in groups that share one network: the group size is the
largest divisor of B at or below max(B // 16, 1), so B // g networks. Each
network is linear-linear (no activation) with standard-normal weights
w1 (F, E), b1 (E), w2 (E, C), b2 (C); its datasets have x ~ N(0, 1)^(T, F)
and y ~ Cat(p), p = softmax(f(x)), from one uniform u a row: y is the
number of classes c >= 1 whose tail p_c + ... + p_{C-1} exceeds u. x is
then z-scored along the sequence (population std + 1e-6). The draws follow
the sampler's order: w1, b1, w2, b2 for all networks, x, then u.
``margin`` is the least |u - tail|: a label closer than that to a threshold
may change on rounding alone.
"""

from __future__ import annotations

import torch

from pfnbench.reference.precision import matmul


def group_size(batch_size: int) -> int:
    target = max(batch_size // 16, 1)
    return next(g for g in range(target, 0, -1) if batch_size % g == 0)


def draw(generator: torch.Generator, batch_size: int, seq_len: int, cfg: dict, mode: str = "f32") -> dict:
    F, E, C, device = cfg["num_features"], cfg["embed"], cfg["num_classes"], generator.device
    g = group_size(batch_size)
    M = batch_size // g
    w1, b1, w2, b2 = (torch.randn(s, generator=generator, device=device)
                      for s in ((M, F, E), (M, E), (M, E, C), (M, C)))
    x = torch.randn((M, g, seq_len, F), generator=generator, device=device)
    dt = torch.float64 if mode == "f32" else torch.float32
    h = matmul(x.to(dt), w1[:, None].to(dt), mode) + b1[:, None, None, :].to(dt)
    logits = matmul(h, w2[:, None].to(dt), mode) + b2[:, None, None, :].to(dt)
    p = torch.softmax(logits, dim=-1)
    tails = torch.stack([p[..., c:].sum(-1) for c in range(1, C)], dim=-1)
    u = torch.rand((M, g, seq_len), generator=generator, device=device).to(dt)
    y = (u[..., None] < tails).sum(-1).to(torch.float64)
    margin = (u[..., None] - tails).abs().amin(-1).double()
    x = x.reshape(batch_size, seq_len, F).double()
    x = (x - x.mean(1, keepdim=True)) / (x.std(1, keepdim=True, correction=0) + 1e-6)
    return {"x": x, "y": y.reshape(batch_size, seq_len), "margin": margin.reshape(batch_size, seq_len)}
