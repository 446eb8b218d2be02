"""Prior helpers. Port of the part of ``pfn_tpu/priors/base.py`` that the
inference slice uses; the host data loader waits for the training slice."""

from __future__ import annotations

import torch


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
