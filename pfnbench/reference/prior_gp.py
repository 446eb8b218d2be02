"""The Fig-3a GP prior on a fixed grid, from its definition.

A latent f ~ GP(0, outputscale exp(-d^2 / (2 lengthscale^2))) is drawn on G
equispaced points of [0, 1] by circulant embedding (length M, the next power
of two at or above 8 G, a spectral factor from the FFT of the kernel's first
row, negative eigenvalues set to 0), in float64. Each dataset reads its T
inputs off the grid at uniform random indices, and y = f(x) + sqrt(noise)
eps. The random draws are taken from the generator in the order the grid
sampler takes them: indices (B, T), then two normal arrays (ceil(B/2), M),
then eps (B, T), so that a generator in the same state gives the same
datasets.
"""

from __future__ import annotations

import math

import torch

from pfnbench.reference.precision import rounded


def circulant_size(G: int) -> int:
    M = 1
    while M < 8 * G:
        M *= 2
    return M


def sqrt_eigenvalues(G: int, lengthscale: float, outputscale: float, device) -> torch.Tensor:
    M = circulant_size(G)
    j = torch.arange(M, dtype=torch.float64, device=device)
    d = torch.minimum(j, M - j) / (G - 1)
    c = outputscale * torch.exp(-0.5 * (d / lengthscale) ** 2)
    return torch.fft.fft(c).real.clamp_min(0.0).sqrt()


def draw(generator: torch.Generator, batch_size: int, seq_len: int, cfg: dict, mode: str = "f32") -> dict:
    """x (B, T, 1) and y (B, T), float64; ``mode`` rounds the field and y
    (the control's lower precision)."""
    G, device = cfg["grid"], generator.device
    M = circulant_size(G)
    idx = torch.randint(0, G, (batch_size, seq_len), generator=generator, device=device)
    half = ((batch_size + 1) // 2, M)
    a = torch.randn(half, generator=generator, device=device)
    b = torch.randn(half, generator=generator, device=device)
    eps = torch.randn((batch_size, seq_len), generator=generator, device=device)
    lam = sqrt_eigenvalues(G, cfg["lengthscale"], cfg["outputscale"], device)
    w = torch.fft.ifft(lam * torch.complex(a.double(), b.double()), dim=-1) * math.sqrt(M)
    f = torch.cat([rounded(w.real, mode), rounded(w.imag, mode)], dim=0)[:batch_size, :G]
    grid = torch.linspace(0.0, 1.0, G, dtype=torch.float64, device=device)
    y = torch.gather(f, 1, idx) + math.sqrt(cfg["noise"]) * eps.double()
    return {"x": grid[idx][..., None], "y": rounded(y, mode)}
