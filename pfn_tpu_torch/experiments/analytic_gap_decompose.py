"""Decompose the analytic Fig-3a KL into interior and tail contributions.

Port of ``experiments/analytic_gap_decompose.py``. Part of the oracle
posterior's mass lies outside the equal-mass borders' span, where the
FullSupport head models it with half-normal tails. This script attributes a
scored run's KL to the two regions, per context size, from the analytic-gap
intermediates (``pfn_logits.npy``, ``oracle_moments.npz``, ``borders.npy``
and ``analytic_gap.json`` of ``fig3a_analytic_gap``):

    KL_total    = gaussian_kl(logits, mu, var)   (the bar head's closed form)
    KL_interior = sum_inner int_bucket f log(f / (p_k / w_k))
    KL_tail     = KL_total - KL_interior

KL_total runs in float64 on ``--device`` (float64 borders, as the JAX script
runs under x64); the interior integral is numpy. Also reports how
concentrated the per-dataset KL is (the share of the sum held by the worst 8
datasets).

    python -m pfn_tpu_torch.experiments.analytic_gap_decompose \\
        --dir results/fig3a/analytic_gap --out results/analytic_gap_decompose.json
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np
import torch
from scipy.special import erf

from pfn_tpu_torch.distributions import FullSupportBarDistribution
from pfn_tpu_torch.experiments.common import add_device_argument, resolve_device


def interior_kl(mu: float, sigma: float, borders: np.ndarray,
                log_p: np.ndarray, pts_per_bucket: int = 9) -> float:
    """int over the INNER buckets of f log(f / (p_k/w_k)).

    Inner = buckets 1..K-2 (bucket 0 and K-1 are the half-normal tails in
    FullSupportBarDistribution; their in-span parts are negligible by
    construction — equal-mass edge buckets carry ~1/K mass).
    """
    borders = np.asarray(borders, np.float64)
    a = max(1, np.searchsorted(borders, mu - 10 * sigma) - 1)
    b = min(len(borders) - 2, np.searchsorted(borders, mu + 10 * sigma) + 1)
    if a >= b:
        return 0.0
    bl, br = borders[a:b], borders[a + 1:b + 1]
    widths = br - bl
    z = lambda t: (t - mu) / (sigma * math.sqrt(2.0))
    masses = 0.5 * (erf(z(br)) - erf(z(bl)))
    t = (np.arange(pts_per_bucket) + 0.5) / pts_per_bucket
    ys = bl[:, None] + widths[:, None] * t[None, :]
    f = np.exp(-0.5 * ((ys - mu) / sigma) ** 2) / (
        sigma * math.sqrt(2 * math.pi))
    # log model density per bucket: log p_k - log w_k.
    log_q = (log_p[a:b] - np.log(widths))[:, None]
    flogf = np.where(f > 0, f * np.log(np.maximum(f, 1e-300)), 0.0)
    integrand = flogf - f * log_q
    kl = float(np.sum(integrand.mean(axis=1) * widths))
    # Subtracting two integrals; tiny negative numerical residue possible
    # only where masses ~ 0.
    del masses
    return kl


def total_kl(logits: np.ndarray, borders: np.ndarray, mus: np.ndarray, vars_: np.ndarray, device) -> tuple:
    """(KL_total (P, N), log p (P, N, K)): the closed-form KL of each
    (position, dataset) and the head's log-probabilities, in float64 on
    ``device``."""
    dist = FullSupportBarDistribution(np.asarray(borders, np.float64), dtype=torch.float64).to(device)
    lg = torch.as_tensor(logits, device=device).double()
    total = dist.gaussian_kl(lg, *(torch.as_tensor(a, device=device).double() for a in (mus, vars_)))
    return total.cpu().numpy(), torch.log_softmax(lg, dim=-1).cpu().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(ap)
    ap.add_argument("--dir", default="results/fig3a/analytic_gap")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="results/analytic_gap_decompose.json")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    borders = np.load(os.path.join(args.dir, "borders.npy")).astype(np.float64)
    mom = np.load(os.path.join(args.dir, "oracle_moments.npz"))
    logits = np.load(os.path.join(args.dir, "pfn_logits.npy"))
    with open(os.path.join(args.dir, "analytic_gap.json")) as f:
        gap = json.load(f)
    positions = gap["positions"]
    mus, vars_ = mom["effective_mean"], mom["effective_var"]
    P, N = mus.shape

    total, log_p = total_kl(logits, borders, mus, vars_, device)
    # Cross-check against the scored run's aggregates.
    err = float(np.max(np.abs(total.mean(1) - np.asarray(gap["kl_mean_effective"]))))
    if err >= 1e-6:
        raise ValueError(f"total-KL mismatch vs the run's analytic_gap.json: {err}")

    interior = np.zeros((P, N))
    for p in range(P):
        for n in range(N):
            interior[p, n] = interior_kl(float(mus[p, n]), float(np.sqrt(vars_[p, n])), borders, log_p[p, n])
    tail = total - interior

    # Concentration: share of sum held by the worst 8 datasets.
    srt = np.sort(total, axis=1)
    top8_share = srt[:, -8:].sum(1) / np.maximum(srt.sum(1), 1e-300)

    result = {
        "label": args.label, "positions": positions, "n_datasets": int(N),
        "kl_total_mean": [float(x) for x in total.mean(1)],
        "kl_interior_mean": [float(x) for x in interior.mean(1)],
        "kl_tail_mean": [float(x) for x in tail.mean(1)],
        "kl_total_median": [float(x) for x in np.median(total, 1)],
        "kl_interior_median": [float(x) for x in np.median(interior, 1)],
        "top8of128_share_of_total": [float(x) for x in top8_share],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)

    print(f"{'ctx':>5} {'total':>8} {'interior':>9} {'tail':>8} {'top8%':>6}")
    for i, ctx in enumerate(positions):
        print(f"{ctx:>5} {result['kl_total_mean'][i]:8.4f} "
              f"{result['kl_interior_mean'][i]:9.4f} "
              f"{result['kl_tail_mean'][i]:8.4f} "
              f"{100 * result['top8of128_share_of_total'][i]:5.1f}%")
    print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
