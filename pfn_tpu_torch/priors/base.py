"""The prior protocol and its helpers. Port of ``pfn_tpu/priors/base.py``
without the host data loader (the train loop's ``data_iter`` takes host
batches directly)."""

from __future__ import annotations

from typing import Protocol, Tuple, runtime_checkable

import torch


@runtime_checkable
class Prior(Protocol):
    """A synthetic-dataset prior: ``sample`` draws (x (B, T, F), y (B, T),
    target_y (B, T)) on ``device`` from ``generator``, which lies on that
    device. The train loop calls ``prior.sample(batch_size, bptt,
    generator=g, device=g.device)``."""

    num_features: int
    num_outputs: int

    def sample(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None,
               device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        ...


def sample_y_for_buckets(prior, n_samples: int, seq_len: int, seed: int = 0, max_seq_len: int | None = None,
                         device=None) -> torch.Tensor:
    """A flat sample of target ys for estimating adaptive bucket borders.

    Draws max(1, n_samples // s) datasets of length s = min(seq_len,
    max_seq_len) from a generator seeded with ``seed``. Capping s draws more
    independent functions for the same n_samples, which widens the border
    span toward the prior's true marginal (see the JAX package's docstring).
    """
    s = min(seq_len, max_seq_len) if max_seq_len else seq_len
    batch = max(1, n_samples // s)
    generator = torch.Generator(device=device or "cpu").manual_seed(seed)
    _, _, target_y = prior.sample(batch, s, generator=generator, device=device)
    return target_y.reshape(-1)


def default_group_size(batch_size: int, divisor: int) -> int:
    """Largest divisor of ``batch_size`` that is <= max(batch_size // divisor,
    1): the reference's ``B // divisor`` group-size heuristic
    (fast_gp_mix.py:76, mlp.py:82-84) made safe for batch sizes the quotient
    does not divide (B = 100, divisor 16: 6 -> 5)."""
    target = max(batch_size // divisor, 1)
    for g in range(target, 0, -1):
        if batch_size % g == 0:
            return g
    return 1
