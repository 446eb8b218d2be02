"""Bayesian linear (ridge) prior, the closed-form oracle's prior.

Port of ``pfn_tpu/priors/ridge.py`` (reference priors/ridge.py:10-16):
weights w ~ N(0, weight_std^2), inputs x ~ U(0, 1), y = w.x + N(0,
noisy_std^2). ``target_y`` is the noise-free y (the reference scores MSE
against it, priors/ridge.py:31). Split, as every port sampler, into
:meth:`RidgePrior.draw` (the random draws, from a ``torch.Generator``) and
the deterministic :meth:`RidgePrior.from_draws`.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RidgePrior:
    num_features: int = 1
    num_outputs: int = 1
    noisy_std: float = 0.1
    weight_std: float = 0.1

    def draw(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None, device=None) -> dict:
        """Unit normals ``w`` (B, F) and ``noise`` (B, T), uniforms ``x``
        (B, T, F)."""
        F = self.num_features
        return {
            "w": torch.randn((batch_size, F), generator=generator, device=device),
            "x": torch.rand((batch_size, seq_len, F), generator=generator, device=device),
            "noise": torch.randn((batch_size, seq_len), generator=generator, device=device),
        }

    def from_draws(self, d: dict):
        """(x (B, T, F), y (B, T), y_clean (B, T)) from :meth:`draw`'s
        draws."""
        w = self.weight_std * d["w"]
        y_clean = torch.einsum("bf,btf->bt", w, d["x"])
        return d["x"], y_clean + self.noisy_std * d["noise"], y_clean

    def sample(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None, device=None):
        return self.from_draws(self.draw(batch_size, seq_len, generator, device))
