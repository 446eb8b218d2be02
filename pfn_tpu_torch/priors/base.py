"""The prior protocol, the host data loader and the border sample. Port of
``pfn_tpu/priors/base.py``."""

from __future__ import annotations

import dataclasses
from typing import Iterator, Protocol, Tuple, runtime_checkable

import torch

from pfn_tpu_torch.device import require_cuda


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


@dataclasses.dataclass
class PriorDataLoader:
    """Host-side iterator over ``num_steps`` freshly sampled prior batches.

    Mirrors the reference DataLoader (priors/utils.py:35-39): every step
    draws a new batch, yielded as ``((x, y), target_y)``, batch-first. The
    draws come from one ``torch.Generator`` on ``device`` seeded with
    ``seed`` at each ``iter()``, so two loaders of one seed, or two passes
    over one loader, yield equal batches. The stream is torch's, not JAX's
    threefry: the same seed gives other datasets than the JAX loader's, of
    the same law. ``device`` None is the current card (an error without
    one); pass ``"cpu"`` for the host.
    """

    prior: Prior
    num_steps: int
    batch_size: int
    seq_len: int
    seed: int = 0
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = require_cuda() if self.device is None else torch.device(self.device)
        self.num_features = self.prior.num_features
        self.num_outputs = self.prior.num_outputs

    def __len__(self) -> int:
        return self.num_steps

    def __iter__(self) -> Iterator:
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        for _ in range(self.num_steps):
            x, y, target_y = self.prior.sample(self.batch_size, self.seq_len, generator=generator,
                                               device=self.device)
            yield (x, y), target_y

    def validate(self, model) -> float | None:  # hook parity: priors/prior.py:12
        """Optional validation hook; a prior's own loader may override it."""
        return None


def make_dataloader(prior: Prior, num_steps: int, batch_size: int, seq_len: int, seed: int = 0,
                    device=None) -> PriorDataLoader:
    """The pure prior as a host iterable (parity with
    get_batch_to_dataloader, reference priors/utils.py:14-42)."""
    return PriorDataLoader(prior, num_steps, batch_size, seq_len, seed, device)


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
