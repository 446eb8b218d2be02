"""Numerical-fidelity audit of the grid GP sampler at the Fig-3a scale.

Port of ``experiments/grid_fidelity.py``. The grid sampler
(ops/gp_sample.py:gp_sample_paths_grid) factors the latent's covariance once
in float64 on the host; only the (B, M) FFT or the (B, G) x (G, G) matmul
runs in f32 on the device. This script measures what that leaves, so that
a long run can be scored against the nominal-noise oracle:

  1. duplicate-pair noise estimate: with T = 2010 draws over G grid points,
     ~T^2/(2G) pairs within a dataset share an x. A repeated x gets the same
     latent f, so var((y_i - y_j)/sqrt(2)) over such pairs estimates the
     total effective observation noise directly (no oracle involved).
  2. latent numerical error: the f32 latent draw on the device (the
     circulant FFT, or ``--method chol`` for the dense factor) against the
     same draw recomputed in float64 on the host from the same normals, in
     units of the nominal noise's std.
  3. the prior's moments (the port's addition, a check of the sampler it
     draws from): the mean and variance of y against 0 and outputscale +
     noise, and the latent fields' covariance at grid lags against the RBF
     kernel, each with a 95 % CI from the spread across datasets.

    python -m pfn_tpu_torch.experiments.grid_fidelity [--method chol] [--device cpu]

It writes ``--out`` (default results/grid_fidelity.json; the JAX script's
default, docs/results/grid_fidelity.json, holds the reference's TPU
measurement).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from pfn_tpu_torch.experiments.common import GP_HP, add_device_argument, resolve_device
from pfn_tpu_torch.ops.gp_sample import (
    _circulant_size,
    _grid_factor,
    grid_latent_from_normals,
    grid_normals,
    gp_sample_paths_grid,
)

LATENT_FIELDS = 8
# Grid lags of the covariance audit, as fractions of the grid.
LAG_FRACTIONS = (0.0, 1 / 16, 1 / 8, 1 / 4, 1 / 2)


def duplicate_pair_noise(x: np.ndarray, y: np.ndarray):
    """The effective noise from pairs of equal x within a dataset: x, y (B, T).
    Returns (the estimate, its pair count and 95 % CI; the CI's relative
    half-width)."""
    diffs = []
    for b in range(x.shape[0]):
        order = np.argsort(x[b], kind="stable")
        xs, ys = x[b][order], y[b][order]
        same = xs[1:] == xs[:-1]  # adjacent duplicates after the sort
        diffs.append((ys[1:] - ys[:-1])[same])
    d = np.concatenate(diffs)
    n_pairs = int(d.size)
    noise_eff = float(np.mean(d**2) / 2.0)  # y_i - y_j at one x is N(0, 2 noise_eff)
    rel_hw = 1.96 * np.sqrt(2.0 / max(n_pairs, 1))  # chi^2 95 % band
    return {"duplicate_pairs": n_pairs, "effective_noise": noise_eff,
            "effective_noise_ci95": [noise_eff * (1 - rel_hw), noise_eff * (1 + rel_hw)]}, rel_hw


def latent_f64(latent, grid_size: int, method: str, fields: int) -> np.ndarray:
    """The latent fields recomputed in float64 on the host from the same
    normals (for "chol", the same f32 factor, so that only the matmul's
    error is measured)."""
    hp = GP_HP
    if method == "fft":
        h = 1.0 / (grid_size - 1)
        M = _circulant_size(grid_size)
        j = np.arange(M)
        d = np.minimum(j, M - j) * h
        c = hp["outputscale"] * np.exp(-0.5 * (d / hp["lengthscale"]) ** 2)
        sqrt_lam = np.sqrt(np.maximum(np.fft.fft(c).real, 0.0))
        a, b = (t.double().cpu().numpy() for t in latent)
        w = np.fft.ifft(sqrt_lam * (a + 1j * b), axis=-1) * np.sqrt(M)
        return np.concatenate([w.real, w.imag], axis=0)[:fields, :grid_size]
    _, L32 = _grid_factor(grid_size, hp["lengthscale"], hp["outputscale"])
    return latent.double().cpu().numpy() @ L32.double().numpy().T


def _mean_ci(per_dataset: np.ndarray) -> list:
    m = float(per_dataset.mean())
    hw = 1.96 * float(per_dataset.std(ddof=1)) / np.sqrt(len(per_dataset))
    return [m - hw, m + hw]


def prior_moments(y: np.ndarray, f: np.ndarray, grid_size: int) -> dict:
    """y (B, T) and latent fields f (B, G) against the prior's moments; each
    CI from the per-dataset estimates' spread (datasets are independent)."""
    hp = GP_HP
    var_want = hp["outputscale"] + hp["noise"]
    y_mean, y_var = y.mean(axis=1), (y**2).mean(axis=1)
    out = {"y_mean": float(y_mean.mean()), "y_mean_ci95": _mean_ci(y_mean), "y_var": float(y_var.mean()),
           "y_var_ci95": _mean_ci(y_var), "y_var_expected": var_want, "cov": []}
    held = [out["y_mean_ci95"][0] <= 0.0 <= out["y_mean_ci95"][1],
            out["y_var_ci95"][0] <= var_want <= out["y_var_ci95"][1]]
    h = 1.0 / (grid_size - 1)
    for frac in LAG_FRACTIONS:
        lag = int(round(frac * (grid_size - 1)))
        per = (f[:, : grid_size - lag] * f[:, lag:]).mean(axis=1)
        want = hp["outputscale"] * float(np.exp(-0.5 * (lag * h / hp["lengthscale"]) ** 2))
        ci = _mean_ci(per)
        out["cov"].append({"lag": lag, "distance": lag * h, "empirical": float(per.mean()), "ci95": ci,
                           "kernel": want})
        held.append(ci[0] <= want <= ci[1])
    out["verdict"] = "consistent" if all(held) else "inconsistent"
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(p)
    p.add_argument("--grid", type=int, default=8192)
    p.add_argument("--bptt", type=int, default=2010)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--method", default="fft", choices=["fft", "chol"])
    p.add_argument("--out", default="results/grid_fidelity.json")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    hp = GP_HP

    # 1. The duplicate-pair effective-noise estimate.
    g = torch.Generator(device=device).manual_seed(0)
    x, y = gp_sample_paths_grid(args.batch, args.bptt, args.grid, hp["lengthscale"], hp["outputscale"], hp["noise"],
                                method=args.method, generator=g, device=device)
    x, y = x[..., 0].cpu().numpy(), y.cpu().numpy()
    pairs, rel_hw = duplicate_pair_noise(x, y)

    # 2. The latent's f32 error against the f64 recomputation.
    g = torch.Generator(device=device).manual_seed(1)
    _, latent, _ = grid_normals(LATENT_FIELDS, 1, args.grid, args.method, generator=g, device=device)
    _, f32 = grid_latent_from_normals(latent, LATENT_FIELDS, args.grid, hp["lengthscale"], hp["outputscale"],
                                      args.method)
    err = f32.double().cpu().numpy() - latent_f64(latent, args.grid, args.method, LATENT_FIELDS)
    noise_sd = float(np.sqrt(hp["noise"]))
    rms = float(np.sqrt(np.mean(err**2)))

    # 3. The prior's moments, on the batch of step 1 and on as many latent
    # fields.
    g = torch.Generator(device=device).manual_seed(2)
    _, latent_b, _ = grid_normals(args.batch, 1, args.grid, args.method, generator=g, device=device)
    _, f_b = grid_latent_from_normals(latent_b, args.batch, args.grid, hp["lengthscale"], hp["outputscale"],
                                      args.method)
    moments = prior_moments(y.astype(np.float64), f_b.double().cpu().numpy(), args.grid)

    out = {
        "grid": args.grid,
        "bptt": args.bptt,
        "batch": args.batch,
        "method": args.method,
        "backend": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        "nominal_noise": hp["noise"],
        **pairs,
        "latent_err_rms": rms,
        "latent_err_max": float(np.abs(err).max()),
        "latent_err_rms_over_noise_sd": rms / noise_sd,
        "verdict": ("nominal" if abs(pairs["effective_noise"] - hp["noise"]) <= rel_hw * hp["noise"]
                    and rms < 0.1 * noise_sd else "inflated"),
        "prior_moments": moments,
    }
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
