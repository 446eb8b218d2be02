"""Fixed-hyperparameter GP prior, the Fig-3a prior.

Port of ``pfn_tpu/priors/gp.py``: x ~ U(0, 1)^(B, T, F) (or an equidistant
grid for F = 1), y drawn in one shot from the GP prior plus Gaussian noise
(RBF kernel scaled by outputscale, zero mean). ``grid > 0`` selects the 1-D
grid sampler (circulant FFT). Random draws come from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import torch

from pfn_tpu_torch.ops.gp_sample import gp_sample_paths, gp_sample_paths_grid, rbf_kernel


@dataclasses.dataclass(frozen=True)
class GPPrior:
    num_features: int = 1
    num_outputs: int = 1
    noise: float = 0.1
    outputscale: float = 0.1
    lengthscale: float = 0.1
    equidistant_x: bool = False
    # > 0: the grid sampler (1-D only) with a G-point grid; see
    # ops.gp_sample.gp_sample_paths_grid.
    grid: int = 0

    def hyperparameters(self) -> dict:
        return {"noise": self.noise, "outputscale": self.outputscale, "lengthscale": self.lengthscale}

    def sample_x(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None, device=None):
        if self.equidistant_x:
            if self.num_features != 1:
                raise ValueError("equidistant_x needs num_features == 1")
            grid = torch.linspace(0.0, 1.0, seq_len, device=device)
            return grid[None, :, None].expand(batch_size, seq_len, 1).contiguous()
        return torch.rand((batch_size, seq_len, self.num_features), generator=generator, device=device)

    def sample(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None, device=None):
        """Return (x (B, T, F), y (B, T), target_y (B, T)) on ``device``."""
        if self.grid > 0:
            if self.num_features != 1 or self.equidistant_x:
                raise ValueError("the grid sampler is 1-D continuous-x only")
            x, y = gp_sample_paths_grid(
                batch_size, seq_len, self.grid, self.lengthscale, self.outputscale, self.noise,
                generator=generator, device=device,
            )
            return x, y, y
        x = self.sample_x(batch_size, seq_len, generator, device)
        y = gp_sample_paths(
            x, self.lengthscale, self.outputscale, self.noise, kernel=rbf_kernel, generator=generator
        )
        return x, y, y
