"""The Bayesian-neural-network prior of the reference's BNN comparison.

Datasets come in groups that share one network: the group size is the
largest divisor of B at or below max(B // 16, 1), so B // g networks. Each
network is linear-linear (no activation) with standard-normal weights
w1 (F, E), b1 (E), w2 (E, 2), b2 (2); its datasets have x ~ N(0, 1)^(T, F)
and y = 1 where a uniform u lies below p = softmax(f(x))[1], else 0. x is
then z-scored along the sequence (population std + 1e-6). The draws follow
the sampler's order: w1, b1, w2, b2 for all networks, x, then u.
``margin`` is |u - p|: a label closer than that to its threshold may flip on
rounding alone.
"""

from __future__ import annotations

import torch

from pfnbench.reference.precision import matmul


def group_size(batch_size: int) -> int:
    target = max(batch_size // 16, 1)
    return next(g for g in range(target, 0, -1) if batch_size % g == 0)


def draw(generator: torch.Generator, batch_size: int, seq_len: int, cfg: dict, mode: str = "f32") -> dict:
    F, E, device = cfg["num_features"], cfg["embed"], generator.device
    g = group_size(batch_size)
    M = batch_size // g
    w1, b1, w2, b2 = (torch.randn(s, generator=generator, device=device)
                      for s in ((M, F, E), (M, E), (M, E, 2), (M, 2)))
    x = torch.randn((M, g, seq_len, F), generator=generator, device=device)
    wide = "f32" if mode == "f32" else mode
    dt = torch.float64 if mode == "f32" else torch.float32
    h = matmul(x.to(dt), w1[:, None].to(dt), wide) + b1[:, None, None, :].to(dt)
    logits = matmul(h, w2[:, None].to(dt), wide) + b2[:, None, None, :].to(dt)
    p = torch.sigmoid(logits[..., 1] - logits[..., 0])
    u = torch.rand((M, g, seq_len), generator=generator, device=device)
    y = (u.to(dt) < p).to(torch.float64)
    x = x.reshape(batch_size, seq_len, F).double()
    x = (x - x.mean(1, keepdim=True)) / (x.std(1, keepdim=True, correction=0) + 1e-6)
    return {"x": x, "y": y.reshape(batch_size, seq_len), "margin": (u.double() - p.double()).abs().reshape(
        batch_size, seq_len)}
