"""Batch-level prior mixture: split each batch between component priors.

Port of ``pfn_tpu/priors/mixture.py``. The per-component allocation is static
(largest remainder over the weights, computed from the batch size), so every
component samples a fixed-size sub-batch from the same generator in turn and
the result is one concatenation. Components must agree on ``num_outputs``;
narrower components are zero-padded on the right to the widest
``num_features``, the convention real datasets follow at eval time
(``experiments/tabular_eval.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from pfn_tpu_torch.priors.base import Prior


def _allocate(batch_size: int, weights: Sequence[float]) -> Tuple[int, ...]:
    """Largest-remainder allocation of ``batch_size`` rows to components.
    Every component with a positive weight gets at least one row when
    batch_size >= the number of components."""
    total = float(sum(weights))
    if total <= 0:
        raise ValueError("mixture weights must have a positive sum")
    shares = [batch_size * float(w) / total for w in weights]
    counts = [int(s) for s in shares]
    if batch_size >= len(weights):
        counts = [max(c, 1) if w > 0 else c for c, w in zip(counts, weights)]
    while sum(counts) > batch_size:
        i = max(range(len(counts)), key=lambda j: counts[j])
        counts[i] -= 1
    rema = [s - c for s, c in zip(shares, counts)]
    while sum(counts) < batch_size:
        i = max(range(len(counts)), key=lambda j: rema[j])
        counts[i] += 1
        rema[i] = -1.0
    return tuple(counts)


@dataclasses.dataclass(frozen=True)
class BatchMixture:
    """Each batch as a static split across component priors; ``weights`` are
    relative. The split is deterministic given (batch_size, weights)."""

    components: Tuple[Prior, ...]
    weights: Tuple[float, ...]

    def __post_init__(self):
        if len(self.components) != len(self.weights):
            raise ValueError("components and weights must align")
        if not self.components:
            raise ValueError("need at least one component")
        outs = {p.num_outputs for p in self.components}
        if len(outs) != 1:
            raise ValueError(f"components disagree on num_outputs: {outs}")

    @property
    def num_features(self) -> int:
        return max(p.num_features for p in self.components)

    @property
    def num_outputs(self) -> int:
        return self.components[0].num_outputs

    def sample(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None, device=None):
        xs, ys, ts = [], [], []
        for prior, n in zip(self.components, _allocate(batch_size, self.weights)):
            if n == 0:
                continue
            x, y, t = prior.sample(n, seq_len, generator=generator, device=device)
            xs.append(F.pad(x, (0, self.num_features - x.shape[-1])))
            ys.append(y)
            ts.append(t)
        return torch.cat(xs), torch.cat(ys), torch.cat(ts)
