"""GP hyperprior-mixture prior (Matern-5/2 ARD with Gamma hyperpriors).

Port of ``pfn_tpu/priors/gp_mix.py`` (reference priors/fast_gp_mix.py:24-134):
hyperparameters drawn per group of ``batch_size_per_gp_sample`` datasets from
Gamma hyperpriors (noise concentration 1.1 / rate 0.05, per-dimension
lengthscale 3.0 / 6.0, outputscale 0.5 / 0.15), optional y min-max-norm and
sigmoid, and rejection re-sampling of the datasets whose y leaves
``fix_to_range``.

The sampler is split in two: :meth:`GPMixPrior.draw` takes every random
number from the caller's ``torch.Generator`` and :meth:`GPMixPrior.from_draws`
maps them to (x, y). The JAX package's rejection loop is a ``while_loop``
that stops once every dataset is in range; here all ``max_retries`` rounds
are drawn and applied, each replacing only the datasets still out of range.
Once every dataset is in range a round changes nothing, so this is the same
function, and it needs no host sync to decide whether to go on. The residue
still out of range after the last round is clipped, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from pfn_tpu_torch.ops.gp_sample import gp_sample_paths_from_normals, matern52_kernel
from pfn_tpu_torch.priors.base import default_group_size
from pfn_tpu_torch.priors.hyper import sample_gamma


@dataclasses.dataclass(frozen=True)
class GPMixPrior:
    num_features: int = 1
    num_outputs: int = 1
    batch_size_per_gp_sample: int | None = None
    noise_concentration: float = 1.1
    noise_rate: float = 0.05
    lengthscale_concentration: float = 3.0
    lengthscale_rate: float = 6.0
    outputscale_concentration: float = 0.5
    outputscale_rate: float = 0.15
    y_minmax_norm: bool = False
    sigmoid: bool = False
    fix_to_range: tuple | None = None
    max_retries: int = 8
    equidistant_x: bool = False

    def group_size(self, batch_size: int) -> int:
        g = self.batch_size_per_gp_sample or default_group_size(batch_size, 10)
        if batch_size % g:
            raise ValueError(f"batch_size {batch_size} is not divisible by batch_size_per_gp_sample {g}")
        return g

    def draw(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None, device=None) -> dict:
        """The random numbers of one batch: standard Gamma draws per group
        ``noise`` (NG,), ``lengthscale`` (NG, F), ``outputscale`` (NG,); and
        for the first draw and each rejection round, ``x`` (R, B, T, F)
        uniforms (absent with ``equidistant_x``) and ``z`` (R, B, T) standard
        normals, R = 1 + max_retries with ``fix_to_range``, else 1."""
        if self.equidistant_x and self.num_features != 1:
            raise ValueError("equidistant_x needs num_features == 1")
        num_groups = batch_size // self.group_size(batch_size)
        rounds = 1 + (self.max_retries if self.fix_to_range is not None else 0)
        d = {
            "noise": sample_gamma(self.noise_concentration, (num_groups,), generator, device),
            "lengthscale": sample_gamma(self.lengthscale_concentration, (num_groups, self.num_features), generator,
                                        device),
            "outputscale": sample_gamma(self.outputscale_concentration, (num_groups,), generator, device),
        }
        if not self.equidistant_x:
            d["x"] = torch.rand((rounds, batch_size, seq_len, self.num_features), generator=generator, device=device)
        d["z"] = torch.randn((rounds, batch_size, seq_len), generator=generator, device=device)
        return d

    def hypers(self, d: dict, batch_size: int):
        """(noise (B,), lengthscale (B, F), outputscale (B,)): each group's
        draws over its rate, repeated over its datasets."""
        g = self.group_size(batch_size)
        noise = d["noise"] / self.noise_rate
        lengthscale = d["lengthscale"] / self.lengthscale_rate
        outputscale = d["outputscale"] / self.outputscale_rate
        return tuple(h.repeat_interleave(g, dim=0) for h in (noise, lengthscale, outputscale))

    def _draw_y(self, x, z, hypers):
        noise, lengthscale, outputscale = hypers
        y = gp_sample_paths_from_normals(x, z, lengthscale, outputscale, noise, kernel=matern52_kernel)
        if self.y_minmax_norm:
            y_min = y.amin(dim=1, keepdim=True)
            y_max = y.amax(dim=1, keepdim=True)
            y = (y - y_min) / (y_max - y_min).clamp_min(1e-9)
        if self.sigmoid:
            y = torch.sigmoid(y)
        return y

    def from_draws(self, d: dict):
        """The deterministic half: draws -> (x (B, T, F), y (B, T))."""
        R, B, T = d["z"].shape
        hypers = self.hypers(d, B)
        if self.equidistant_x:
            grid = torch.linspace(0.0, 1.0, T, device=d["z"].device)
            xs = [grid[None, :, None].expand(B, T, 1)] * R
        else:
            xs = list(d["x"])
        x, y = xs[0], self._draw_y(xs[0], d["z"][0], hypers)
        if self.fix_to_range is not None:
            lo, hi = self.fix_to_range
            for r in range(1, R):
                keep = ((y >= lo) & (y < hi)).all(dim=1)  # datasets already in range stay
                x = torch.where(keep[:, None, None], x, xs[r])
                y = torch.where(keep[:, None], y, self._draw_y(xs[r], d["z"][r], hypers))
            y = y.clamp(lo, hi - 1e-6)
        return x, y

    def sample(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None, device=None):
        """(x (B, T, F), y (B, T), target_y = y) on ``device``."""
        x, y = self.from_draws(self.draw(batch_size, seq_len, generator, device))
        return x, y, y
