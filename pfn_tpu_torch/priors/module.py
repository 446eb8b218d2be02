"""Bring-your-own prior: wrap a sampler callable into a Prior.

Port of ``pfn_tpu/priors/module.py`` (reference priors/pyro.py:10-32): the
user supplies a sampler of datasets, and groups of ``batch_size_per_model``
datasets share one sampled model; x is z-scored per dataset
(``normalize_x``, as the reference normalizes x only).

The callable's contract. The JAX package's is per dataset, ``sample_fn(
model_key, data_key, seq_len) -> (x (T, F), y (T,))``, vmapped over the
batch with one model key per group. Torch has no keys to vmap over, so the
port's contract is batched over the groups:

    sample_fn(generator, num_models, group_size, seq_len)
        -> (x (num_models, group_size, T, F), y (num_models, group_size, T))

The callable draws each model's parameters once (a leading ``num_models``
axis, broadcast over the group) and each dataset's data per entry, all from
``generator`` and on its device. The prior flattens the groups into the
batch axis, group by group, as the JAX prior's ``repeat`` of the model keys
lays them out. :meth:`ModulePrior.draw` calls the callable;
:meth:`ModulePrior.from_draws` is the deterministic rest.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from pfn_tpu_torch.priors.base import default_group_size
from pfn_tpu_torch.priors.transforms import normalize_data


@dataclasses.dataclass(frozen=True)
class ModulePrior:
    sample_fn: Callable  # (generator, num_models, group_size, seq_len) -> (x (M, G, T, F), y (M, G, T))
    num_features: int
    num_outputs: int = 1
    batch_size_per_model: int | None = None
    normalize_x: bool = True

    def group_size(self, batch_size: int) -> int:
        g = self.batch_size_per_model or default_group_size(batch_size, 16)
        if batch_size % g:
            raise ValueError(f"batch_size {batch_size} is not divisible by batch_size_per_model {g}")
        return g

    def draw(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None, device=None) -> dict:
        """The callable's (x, y), flattened to (B, T, F) and (B, T)."""
        g = self.group_size(batch_size)
        if generator is None:  # seeded from torch's global RNG, as the other priors draw without one
            generator = torch.Generator(device=device or "cpu").manual_seed(int(torch.randint(2**62, ())))
        x, y = self.sample_fn(generator, batch_size // g, g, seq_len)
        expected = (batch_size // g, g, seq_len)
        if tuple(x.shape[:3]) != expected or tuple(y.shape) != expected:
            raise ValueError(f"sample_fn returned x {tuple(x.shape)} and y {tuple(y.shape)}; expected x "
                             f"{expected + (self.num_features,)} and y {expected}")
        return {"x": x.reshape(batch_size, seq_len, -1).float(), "y": y.reshape(batch_size, seq_len).float()}

    def from_draws(self, d: dict):
        """(x (B, T, F), y (B, T), y (B, T)), x z-scored per dataset when
        ``normalize_x``."""
        x = normalize_data(d["x"], dim=1) if self.normalize_x else d["x"]
        return x, d["y"], d["y"]

    def sample(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None, device=None):
        return self.from_draws(self.draw(batch_size, seq_len, generator, device))
