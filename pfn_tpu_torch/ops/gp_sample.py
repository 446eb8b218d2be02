"""Batched GP sample paths and exact GP posteriors, in torch.

Port of ``pfn_tpu/ops/gp_sample.py``. Every sampler is split in two: a draw
of the standard normals (and grid indices) from a ``torch.Generator``, and a
pure function from those draws to (x, y). Tests hand both packages the same
draws; the JAX and torch random streams differ.

GP covariance work at noise scales of 1e-4 needs true f32 (or f64) matrix
products. On the card that means TF32 off, which is PyTorch's default for
matmuls; the functions here check it and never switch it on.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _require_full_precision(x: torch.Tensor) -> None:
    if x.is_cuda and x.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "GP covariance work needs full-f32 matmuls: torch.backends.cuda.matmul.allow_tf32 is True"
        )


def _sq_dists(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distances. x1: (..., N, F), x2: (..., M, F)."""
    _require_full_precision(x1)
    n1 = (x1 * x1).sum(dim=-1, keepdim=True)
    n2 = (x2 * x2).sum(dim=-1, keepdim=True)
    cross = torch.matmul(x1, x2.transpose(-1, -2))
    return (n1 + n2.transpose(-1, -2) - 2.0 * cross).clamp_min(0.0)


def rbf_kernel(x1, x2, lengthscale, outputscale):
    """K = outputscale * exp(-||x - x'||^2 / (2 l^2)); ``lengthscale`` is a
    scalar or broadcasts against x's feature axis (ARD)."""
    ls = torch.as_tensor(lengthscale, dtype=x1.dtype, device=x1.device)
    return outputscale * torch.exp(-0.5 * _sq_dists(x1 / ls, x2 / ls))


def matern52_kernel(x1, x2, lengthscale, outputscale):
    """Matern-5/2 (ARD) kernel, the covariance of the GP hyperprior-mixture
    prior (botorch's SingleTaskGP default, reference priors/fast_gp_mix.py:24-55):
    K = outputscale (1 + sqrt5 d + 5/3 d^2) exp(-sqrt5 d), d the distance
    in lengthscale units."""
    ls = torch.as_tensor(lengthscale, dtype=x1.dtype, device=x1.device)
    d = torch.sqrt(_sq_dists(x1 / ls, x2 / ls) + 1e-20)
    sqrt5_d = math.sqrt(5.0) * d
    return outputscale * (1.0 + sqrt5_d + (5.0 / 3.0) * d * d) * torch.exp(-sqrt5_d)


def per_dataset_hypers(lengthscale, outputscale, noise, batch_size: int, num_features: int, device=None):
    """The hyperparameters of a batch of B datasets shaped to broadcast
    against its (B, T, T) kernel matrices: lengthscale (B, 1, F or 1),
    outputscale and noise (B, 1, 1), f32 on ``device``.

    Each may be a scalar (shared), (B,) (per dataset), (F,) or (1, F)
    (shared ARD) or (B, F) (per-dataset ARD), as the JAX package's
    ``gp_sample_paths`` takes them. A 1-D value of length B = F is ambiguous
    and raises: pass (1, F) for a shared ARD vector or (B, 1) for per-dataset
    scalars.
    """
    B, F = batch_size, num_features

    def bcast(h):
        h = torch.as_tensor(h, dtype=torch.float32, device=device)
        if h.ndim == 1 and h.shape[0] == B == F:
            raise ValueError(
                f"ambiguous 1-D hyperparameter of length {B} with batch_size == num_features == {B}: "
                f"pass (1, {F}) for a shared ARD vector or ({B}, 1) for per-dataset scalars")
        if h.ndim == 1 and h.shape[0] == F:
            return h.expand(B, F)  # shared ARD
        if h.ndim == 2 and h.shape[0] == 1:
            return h.expand(B, h.shape[1])
        if h.ndim > 0 and h.shape[0] == B:
            return h  # per dataset
        return h.expand((B,) + tuple(h.shape))

    ls, os_, nz = bcast(lengthscale), bcast(outputscale), bcast(noise)
    return ls.reshape(B, 1, -1), os_.reshape(B, 1, 1), nz.reshape(B, 1, 1)


def psd_safe_cholesky(A: torch.Tensor, initial_jitter: float = 1e-6, max_tries: int = 5) -> torch.Tensor:
    """Cholesky with escalating diagonal jitter (x10 per retry), per matrix.

    A: (..., T, T). Success is judged by ``cholesky_ex``'s ``info``: on
    failure torch returns a finite but partial factor, so finiteness (the JAX
    package's test) would accept it. Matrices that already factored are left
    untouched; those still failing after the last step get a NaN factor, as
    in the JAX package.
    """
    T = A.shape[-1]
    eye = torch.eye(T, dtype=A.dtype, device=A.device)
    L, info = torch.linalg.cholesky_ex(A + initial_jitter * eye)
    ok = info == 0
    jitter = max(initial_jitter * 10.0, 1e-6)
    for _ in range(max_tries):
        if bool(ok.all()):
            break
        L_new, info_new = torch.linalg.cholesky_ex(A + jitter * eye)
        L = torch.where(ok[..., None, None], L, L_new)
        ok = ok | (info_new == 0)
        jitter *= 10.0
    return torch.where(ok[..., None, None], L, torch.full_like(L, float("nan")))


def gp_sample_paths_from_normals(x, z, lengthscale, outputscale, noise, kernel=rbf_kernel, jitter: float = 1e-6):
    """y = L z with L L^T = K(x, x) + noise I, per dataset.

    x: (B, T, F); z: (B, T) standard normals. The hyperparameters are Python
    numbers shared by the batch, or arrays in any of the shapes
    :func:`per_dataset_hypers` takes (shared ARD, per dataset, per-dataset
    ARD). Returns y (B, T) f32.
    """
    B, T, F = x.shape
    x = x.float()
    if not all(isinstance(h, (int, float)) for h in (lengthscale, outputscale, noise)):
        lengthscale, outputscale, noise = per_dataset_hypers(lengthscale, outputscale, noise, B, F, x.device)
    K = kernel(x, x, lengthscale, outputscale)
    A = K + noise * torch.eye(T, dtype=torch.float32, device=x.device)
    L = psd_safe_cholesky(A, initial_jitter=jitter)
    return torch.matmul(L, z.float()[..., None])[..., 0]


def gp_sample_paths(x, lengthscale, outputscale, noise, kernel=rbf_kernel, jitter: float = 1e-6,
                    generator: torch.Generator | None = None):
    """Sample y ~ N(0, K(x, x) + noise I) per dataset. x: (B, T, F) -> (B, T)."""
    z = torch.randn(x.shape[:2], generator=generator, dtype=torch.float32, device=x.device)
    return gp_sample_paths_from_normals(x, z, lengthscale, outputscale, noise, kernel=kernel, jitter=jitter)


@functools.lru_cache(maxsize=4)
def _grid_factor(G: int, lengthscale: float, outputscale: float, device=None):
    """float64 Cholesky of the RBF kernel on a fixed G-point grid over [0, 1],
    computed on the host with an escalating jitter ladder and cast to f32.
    Returns (grid (G,), L (G, G)), f32 tensors on ``device``."""
    g = np.linspace(0.0, 1.0, G)
    d2 = (g[:, None] - g[None, :]) ** 2
    K = outputscale * np.exp(-0.5 * d2 / lengthscale**2)
    jitter = 1e-12 * max(outputscale, 1.0)
    for _ in range(10):
        try:
            L = np.linalg.cholesky(K + jitter * np.eye(G))
            break
        except np.linalg.LinAlgError:
            jitter *= 10.0
    else:
        raise np.linalg.LinAlgError(f"grid kernel not factorizable even at jitter {jitter:g}")
    return (
        torch.as_tensor(g, dtype=torch.float32, device=device),
        torch.as_tensor(L, dtype=torch.float32, device=device),
    )


def _circulant_size(G: int) -> int:
    """The circulant embedding's length: the next power of two >= 8 G."""
    M = 1
    while M < 8 * G:
        M *= 2
    return M


# The largest share of the circulant embedding's trace that its negative
# eigenvalues may hold: clipping them to 0 samples from another covariance,
# distorted by about that share. Measured (numpy f64, G 2048 and 8192): 5e-11
# at lengthscale 0.6, 7.7e-5 at 1.0, 3.0e-2 at 2.0.
MAX_CLIPPED_SHARE = 1e-6


@functools.lru_cache(maxsize=4)
def _circulant_sqrt_eigs(G: int, lengthscale: float, outputscale: float, device=None):
    """sqrt-eigenvalues of the circulant embedding of the RBF kernel on an
    equispaced G-point grid over [0, 1], computed in float64 on the host and
    cast to f32. Negative eigenvalues are clipped to 0, as in the JAX
    package, which does so silently (``pfn_tpu/ops/gp_sample.py:242``); the
    port raises ``ValueError`` where the clipped mass exceeds
    ``MAX_CLIPPED_SHARE`` of the trace (lengthscales of about 1 and above:
    use method "chol" there). Returns (grid (G,), sqrt_lam (M,), M)."""
    h = 1.0 / (G - 1)
    M = _circulant_size(G)
    j = np.arange(M)
    d = np.minimum(j, M - j) * h
    c = outputscale * np.exp(-0.5 * (d / lengthscale) ** 2)
    lam = np.fft.fft(c).real
    clipped = float(np.maximum(-lam, 0.0).sum() / (M * c[0]))  # the trace is M c[0] = sum(lam)
    if clipped > MAX_CLIPPED_SHARE:
        raise ValueError(
            f"the grid sampler's circulant embedding (G {G}, lengthscale {lengthscale}) has negative eigenvalues "
            f"holding {clipped:.2e} of its trace (> {MAX_CLIPPED_SHARE:g}): clipping them, as the JAX package does "
            "silently, would sample from a distorted covariance; use method 'chol' or the exact sampler (grid=0)")
    lam = np.maximum(lam, 0.0)
    grid = torch.as_tensor(np.linspace(0.0, 1.0, G), dtype=torch.float32, device=device)
    sqrt_lam = torch.as_tensor(np.sqrt(lam), dtype=torch.float32, device=device)
    return grid, sqrt_lam, M


def grid_normals(batch_size: int, seq_len: int, grid_size: int, method: str = "fft",
                 generator: torch.Generator | None = None, device=None):
    """The random draws of :func:`gp_sample_paths_grid`.

    Returns (idx (B, T) int64 grid indices, latent, eps (B, T) normals) where
    ``latent`` is (a, b), two (ceil(B/2), M) normal arrays, for "fft", and a
    (B, G) normal array for "chol".
    """
    idx = torch.randint(0, grid_size, (batch_size, seq_len), generator=generator, device=device)
    if method == "fft":
        shape = ((batch_size + 1) // 2, _circulant_size(grid_size))
        latent = (
            torch.randn(shape, generator=generator, device=device),
            torch.randn(shape, generator=generator, device=device),
        )
    elif method == "chol":
        latent = torch.randn((batch_size, grid_size), generator=generator, device=device)
    else:
        raise ValueError(f"unknown grid method {method!r}")
    eps = torch.randn((batch_size, seq_len), generator=generator, device=device)
    return idx, latent, eps


def grid_latent_from_normals(latent, batch_size: int, grid_size: int, lengthscale: float, outputscale: float,
                             method: str = "fft"):
    """The latent GP fields on the fixed G-point grid over [0, 1] from the
    normals of :func:`grid_normals`: returns (grid (G,), f (B, G)), f32 on
    the normals' device. "fft" uses the circulant spectral factor,
    w = ifft(sqrt(lam) * (a + i b)) * sqrt(M), whose real and imaginary parts
    are two independent fields; "chol" multiplies by the dense f64-factored
    Cholesky factor."""
    if method == "fft":
        a, b = latent
        grid, sqrt_lam, M = _circulant_sqrt_eigs(grid_size, float(lengthscale), float(outputscale), a.device)
        w = torch.fft.ifft(sqrt_lam.to(torch.complex64) * torch.complex(a.float(), b.float()), dim=-1)
        w = w * math.sqrt(M)
        return grid, torch.cat([w.real, w.imag], dim=0)[:batch_size, :grid_size]
    if method == "chol":
        grid, L = _grid_factor(grid_size, float(lengthscale), float(outputscale), latent.device)
        _require_full_precision(L)
        return grid, torch.matmul(latent.float(), L.T)
    raise ValueError(f"unknown grid method {method!r}")


def gp_sample_paths_grid_from_normals(idx, latent, eps, grid_size: int, lengthscale: float,
                                      outputscale: float, noise, method: str = "fft"):
    """Grid GP draws from given normals: returns (x (B, T, 1), y (B, T)).

    The latent f is drawn on a fixed G-point grid over [0, 1]
    (:func:`grid_latent_from_normals`) and each dataset reads its x off the
    grid: x = grid[idx], y = f[idx] + sqrt(noise) * eps.
    """
    grid, f_grid = grid_latent_from_normals(latent, idx.shape[0], grid_size, lengthscale, outputscale, method)
    x = grid[idx][..., None]
    f = torch.gather(f_grid, 1, idx)
    # A Python-float noise becomes a 0-dim CPU tensor, which multiplies a
    # CUDA tensor without a host-to-device copy (a copy would sync the host).
    y = f + torch.sqrt(torch.as_tensor(noise, dtype=torch.float32)) * eps.float()
    return x, y


def gp_sample_paths_grid(batch_size: int, seq_len: int, grid_size: int, lengthscale: float, outputscale: float,
                         noise, method: str = "fft", generator: torch.Generator | None = None, device=None):
    """Grid fast path for 1-D GP prior sampling: (x (B, T, 1), y (B, T))."""
    idx, latent, eps = grid_normals(batch_size, seq_len, grid_size, method, generator, device)
    return gp_sample_paths_grid_from_normals(idx, latent, eps, grid_size, lengthscale, outputscale, noise, method)


def gp_posterior(x_train, y_train, x_query, lengthscale, outputscale, noise, kernel=rbf_kernel,
                 jitter: float = 1e-6, context_mask=None, dtype=torch.float32):
    """Exact GP posterior predictive (mean, variance incl. noise).

    x_train: (..., N, F), y_train: (..., N), x_query: (..., M, F); leading
    axes are a batch of datasets. If ``context_mask`` (N,) or (..., N) is
    given, masked-out rows are excluded from conditioning without changing
    shapes: their rows and columns of the train covariance become identity and
    their cross-covariances zero, so the Cholesky solves the sub-system
    exactly. ``dtype=torch.float64`` gives the large-T oracle accuracy, on
    either device. The hyperparameters are scalars (or an (F,) ARD
    lengthscale), or per dataset in :func:`per_dataset_hypers`' layout:
    lengthscale (..., 1, F), outputscale and noise (..., 1, 1).
    """
    xt = x_train.to(dtype)
    xq = x_query.to(dtype)
    N = xt.shape[-2]
    K = kernel(xt, xt, lengthscale, outputscale).to(dtype)
    k_star = kernel(xt, xq, lengthscale, outputscale).to(dtype)  # (..., N, M)
    y = y_train.to(dtype)
    if context_mask is not None:
        m = context_mask.to(dtype)
        K = K * m[..., :, None] * m[..., None, :] + torch.diag_embed(1.0 - m)
        k_star = k_star * m[..., :, None]
        y = y * m
        A = K + torch.diag_embed(m) * (noise + jitter)
    else:
        A = K + (noise + jitter) * torch.eye(N, dtype=dtype, device=xt.device)
    L = psd_safe_cholesky(A, initial_jitter=0.0)
    alpha = torch.cholesky_solve(y[..., None], L)
    mean = torch.matmul(k_star.transpose(-1, -2), alpha)[..., 0]
    v = torch.linalg.solve_triangular(L, k_star, upper=False)
    # diag(K(xq, xq)) from per-row self-evaluations, without the (M, M)
    # matrix; per-dataset hyperparameters gain the axis of those rows.
    def rows(h):
        return h.unsqueeze(-3) if isinstance(h, torch.Tensor) and h.ndim >= 2 else h

    kqq_diag = kernel(xq[..., :, None, :], xq[..., :, None, :], rows(lengthscale), rows(outputscale))[..., 0, 0]
    var_f = kqq_diag - (v * v).sum(dim=-2)
    if isinstance(noise, torch.Tensor) and noise.ndim >= 2:
        noise = noise[..., 0]
    return mean, var_f.clamp_min(0.0) + noise
