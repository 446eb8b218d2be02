"""Bar-head resolution floor: the KL no model with this head can beat.

Port of ``experiments/bar_resolution_floor.py``. The analytic-gap estimator
(``fig3a_analytic_gap``) measures E_D[KL(oracle posterior || PFN bar head)].
Part of that KL is not model error: a piecewise-constant density on fixed
borders cannot represent a continuous Gaussian exactly, so even the best
logits leave a residual KL(N(mu, sigma^2) || best bar fit). This script
computes that floor per context size from a scored run's oracle moments, for
the 1000-bucket and the 10 000-bucket heads (the notebook's two grid points).

Method: for each (position, dataset) oracle moment (mu, sigma), the optimal
in-support bar density puts mass m_i = Phi((b_{i+1}-mu)/sigma) -
Phi((b_i-mu)/sigma) uniformly over bucket i, giving

    KL_floor = sum_i  int_bucket f log(f w_i / m_i)

by quadrature restricted to the borders' span. The FullSupport half-normal
tails' best-case contribution is bounded below by 0, so the floor is a lower
bound (tight where the out-of-support mass, reported beside it, is small).

Borders: a 1000-bucket head without ``--seq_cap`` takes the run's own
``borders.npy`` (``--check_borders``), as the JAX script does; every other
head is rebuilt as ``fig3a_longrun`` builds its criterion (equal-mass from
100k ys of the exact GP prior, seed 7) on ``--device``, and, where the run's
``borders.npy`` has as many buckets, the largest shift against them is
written beside the floor.

    python -m pfn_tpu_torch.experiments.bar_resolution_floor \\
        --moments results/fig3a/analytic_gap/oracle_moments.npz \\
        --analytic results/fig3a/analytic_gap/analytic_gap.json \\
        --check_borders results/fig3a/analytic_gap/borders.npy --seq_cap 128
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np
from scipy.special import erf

from pfn_tpu_torch.experiments.common import GP_HP, add_device_argument, resolve_device


def gaussian_bar_floor(mu: float, sigma: float, borders: np.ndarray,
                       pts_per_bucket: int = 9) -> tuple[float, float]:
    """(lower-bound KL floor, out-of-support mass) for N(mu, sigma^2)."""
    # float64 throughout: float32 borders would drag the whole pipeline to
    # float32, where the 1e-300 clamps underflow to 0 and produce inf KLs.
    borders = np.asarray(borders, np.float64)
    lo, hi = borders[0], borders[-1]
    # Only buckets within mu +- 10 sigma contribute measurably.
    a = np.searchsorted(borders, mu - 10 * sigma) - 1
    b = np.searchsorted(borders, mu + 10 * sigma) + 1
    a = max(0, a)
    b = min(len(borders) - 1, b)
    if a >= b:  # posterior entirely outside the support span
        out = 1.0
        return 0.0, out
    bl = borders[a:b]
    br = borders[a + 1:b + 1]
    z = lambda t: (t - mu) / (sigma * math.sqrt(2.0))
    masses = 0.5 * (erf(z(br)) - erf(z(bl)))
    widths = br - bl
    # Quadrature nodes per bucket (midpoint-composite; buckets are narrow
    # relative to sigma wherever mass is non-negligible).
    t = (np.arange(pts_per_bucket) + 0.5) / pts_per_bucket
    ys = bl[:, None] + widths[:, None] * t[None, :]
    f = np.exp(-0.5 * ((ys - mu) / sigma) ** 2) / (
        sigma * math.sqrt(2 * math.pi))
    q = np.maximum(masses / np.maximum(widths, 1e-300), 1e-300)[:, None]
    integrand = np.where(f > 0, f * (np.log(np.maximum(f, 1e-300))
                                     - np.log(q)), 0.0)
    kl = float(np.sum(integrand.mean(axis=1) * widths))
    out_mass = 0.5 * (2.0 - erf(z(hi)) + erf(z(lo)))
    # Clamp tiny negative quadrature noise.
    return max(kl, 0.0), float(np.clip(out_mass, 0.0, 1.0))


def make_borders(num_buckets: int, bptt: int, device, seq_cap: int | None = None) -> np.ndarray:
    """The equal-mass borders of ``fig3a_longrun``'s criterion on the exact
    GP prior (``common.bucket_criterion``'s recipe, seed 7), on ``device``."""
    from pfn_tpu_torch.distributions import get_bucket_limits
    from pfn_tpu_torch.priors import GPPrior, sample_y_for_buckets

    prior = GPPrior(num_features=1, **GP_HP)
    ys = sample_y_for_buckets(prior, 100_000, bptt, seed=7, max_seq_len=seq_cap, device=device)
    return get_bucket_limits(num_buckets, ys=ys).numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(ap)
    ap.add_argument("--moments", default="results/fig3a/analytic_gap/oracle_moments.npz")
    ap.add_argument("--analytic", default="results/fig3a/analytic_gap/analytic_gap.json")
    ap.add_argument("--check_borders", default="results/fig3a/analytic_gap/borders.npy")
    ap.add_argument("--bptt", type=int, default=2010)
    ap.add_argument("--buckets", type=int, nargs="+", default=[1000, 10000])
    ap.add_argument("--seq_cap", type=int, default=None,
                    help="build borders from a decorrelated bucket sample (sample_y_for_buckets max_seq_len); "
                         "implies rebuilt borders for every bucket count")
    ap.add_argument("--out", default="results/bar_resolution_floor.json")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    mom = np.load(args.moments)
    mus = mom["effective_mean"]     # (P, N)
    sigmas = np.sqrt(mom["effective_var"])
    with open(args.analytic) as f:
        gap = json.load(f)
    positions = gap["positions"]
    if mus.shape[0] != len(positions):
        raise ValueError(f"{args.moments}: {mus.shape[0]} positions, {args.analytic}: {len(positions)}")
    run_borders = np.load(args.check_borders) if args.check_borders and os.path.exists(args.check_borders) else None

    result = {
        "positions": positions,
        "n_datasets": int(mus.shape[1]),
        "measured_kl_mean_effective": gap["kl_mean_effective"],
        "measured_kl_median_effective": gap["kl_median_effective"],
        "note": ("floor is a LOWER bound: optimal half-normal tail "
                 "contribution bounded by 0; out_of_support_mass_mean "
                 "reports where that matters"),
    }
    if args.seq_cap:
        result["seq_cap"] = args.seq_cap
    for nb in args.buckets:
        if nb == 1000 and args.check_borders and not args.seq_cap:
            # The model's own borders, saved by the analytic-gap pipeline from
            # the checkpointed criterion.
            borders = np.load(args.check_borders)
            result["borders_1000b"] = "committed (exact)"
        else:
            # The same prior and equal-mass recipe; floors depend on the
            # bucket-width scale, not the exact placement.
            borders = make_borders(nb, args.bptt, device, seq_cap=args.seq_cap)
            result[f"borders_{nb}b"] = "rebuilt on the device (equivalent in law)"
            if run_borders is not None and len(run_borders) == len(borders):
                result[f"borders_{nb}b_max_shift_vs_run"] = float(np.abs(
                    borders.astype(np.float64) - run_borders.astype(np.float64)).max())
        floors = np.zeros_like(mus)
        outs = np.zeros_like(mus)
        for p in range(mus.shape[0]):
            for n in range(mus.shape[1]):
                floors[p, n], outs[p, n] = gaussian_bar_floor(
                    float(mus[p, n]), float(sigmas[p, n]), borders)
        result[f"floor_mean_{nb}b"] = [float(x) for x in floors.mean(1)]
        result[f"floor_median_{nb}b"] = [float(x) for x in np.median(floors, 1)]
        result[f"out_of_support_mass_mean_{nb}b"] = [float(x) for x in outs.mean(1)]

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)

    print(f"{'ctx':>5} {'measured':>9} " + " ".join(f"floor_{nb}b" for nb in args.buckets))
    for i, ctx in enumerate(positions):
        floors_str = " ".join(f"{result[f'floor_mean_{nb}b'][i]:9.5f}" for nb in args.buckets)
        print(f"{ctx:>5} {gap['kl_mean_effective'][i]:9.5f} {floors_str}")
    print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
