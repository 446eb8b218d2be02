"""The Fig-3a experiments of the port (``pfn_tpu_torch.experiments``) on the CPU.

  * Phase C of the analytic gap against the JAX script's stats pass
    (``experiments/fig3a_analytic_gap.py --stats_only``, run in a subprocess
    because it switches JAX to x64 for its process) on the same logits and
    moments, drawn from a numpy seed: the port's KL (torch f64) against the
    JAX KL (jnp f64) at 1e-9 relative (closed forms of erf and log in two
    libraries; the KL is a difference of terms of order 1); the statistics,
    which both compute in numpy with ``np.random.default_rng(0)``, bitwise
    equal on the JAX KL; and the port's whole pass at 1e-9 relative with
    equal n_for_1e3 and verdicts.
  * Each script's CLI at a tiny size with ``--device cpu`` (2 layers, emsize
    32, T 64, the model sizes patched in the experiment modules): the long run's
    1 epoch, then a resume, bitwise equal to an uninterrupted run; the oracle
    pass; the analytic gap and the robust eval on its checkpoint, their
    resumes; gp_fitting's quick config; grid_fidelity with both methods.
  * Without ``--device`` each script needs a card and raises without one.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.special import ndtr

from pfn_tpu_torch.experiments import (
    fig3a_analytic_gap,
    fig3a_longrun,
    fig3a_robust_eval,
    gp_fitting,
    grid_fidelity,
)
from pfn_tpu_torch.train import restore_checkpoint, save_checkpoint, seeded_flax_params, state_dict_from_flax_params

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TINY = dict(emsize=32, nhid=64, nlayers=2, nhead=2)
T, BUCKETS = 64, 50
POSITIONS = [1, 5, 20, 50]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: its small CPU ops take as long
    alone, and they do not thrash against the OpenMP threads of the tests
    that other workers run at the same time (several minutes lost there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

_JAX_STATS = """
import runpy, sys
import numpy as np
out, data = sys.argv[1], sys.argv[2]
script = runpy.run_path("experiments/fig3a_analytic_gap.py")  # its functions, not its main
script["stats_pass"](out, "parity", data)  # switches JAX to x64 on the CPU
import jax.numpy as jnp
from pfn_tpu.distributions import FullSupportBarDistribution
dist = FullSupportBarDistribution.create(np.load(out + "/borders.npy"))
logits = jnp.asarray(np.load(out + "/pfn_logits.npy"), jnp.float64)
mom = np.load(out + "/oracle_moments.npz")
np.savez(out + "/jax_kl.npz", **{w: np.asarray(dist.gaussian_kl(logits, jnp.asarray(mom[w + "_mean"]),
                                                                jnp.asarray(mom[w + "_var"])))
                                 for w in ("nominal", "effective")})
"""


def _stats_inputs(tmp_path):
    """Logits of 4 context sizes x 40 datasets x 400 buckets: the exact
    Gaussian bucket masses (KL ~ 0: "met"), randomly perturbed (KL ~ 0.04:
    "unmet"), perturbed for a tenth of the datasets (a wide CI over 1e-3:
    "unmeasurable-at-this-n"), and random (KL ~ 1.7). The effective moments
    shift the mean at two of the sizes. A robust_eval directory on the same
    datasets feeds the variance comparison."""
    rng = np.random.default_rng(0)
    P, N, K = len(POSITIONS), 40, 400
    borders = np.linspace(-4, 4, K + 1).astype(np.float32)
    mu, var = rng.normal(0, 0.3, (P, N)), np.exp(rng.normal(-1.0, 0.2, (P, N)))
    cdf = ndtr((borders[None, None, :] - mu[..., None]) / np.sqrt(var)[..., None])
    logits = np.log(np.maximum(np.diff(cdf, axis=-1), 1e-300))
    logits[1] += rng.normal(0, 0.3, (N, K))
    logits[2] += rng.normal(0, 0.2, (N, K)) * (rng.random((N, 1)) < 0.1)
    logits[3] = rng.normal(0, 1, (N, K))
    out, sampled = tmp_path / "agap", tmp_path / "robust"
    out.mkdir()
    sampled.mkdir()
    np.save(out / "pfn_logits.npy", logits.astype(np.float32))
    np.save(out / "borders.npy", borders)
    np.savez(out / "oracle_moments.npz", effective_noise=np.asarray(1e-3), nominal_mean=mu, nominal_var=var,
             effective_mean=mu + np.array([0.0, 0.01, 0.0, 0.01])[:, None], effective_var=var)
    np.savez(out / "eval_data.npz", x=np.zeros((N, T, 1), np.float32), y=np.zeros((N, T), np.float32),
             positions=np.asarray(POSITIONS))
    np.save(sampled / "pfn_per_dataset.npy", rng.normal(0.5, 0.4, (P, N)))
    np.savez(sampled / "oracle_per_dataset.npz", nominal=rng.normal(0, 0.3, (P, N)),
             effective=rng.normal(0, 0.3, (P, N)))
    return out, sampled


def test_phase_c_statistics_match_the_jax_script(tmp_path):
    out, sampled = _stats_inputs(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_STATS, str(out), str(sampled)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = json.loads((out / "analytic_gap.json").read_text())
    jax_kl = dict(np.load(out / "jax_kl.npz"))
    assert want["verdict_effective"] == ["met", "unmet", "unmeasurable-at-this-n", "unmet"]

    # Bitwise where both are numpy: the port's statistics of the JAX KL.
    mom = np.load(out / "oracle_moments.npz")
    sampled_gap = np.load(sampled / "pfn_per_dataset.npy") - np.load(sampled / "oracle_per_dataset.npz")["effective"]
    stats = fig3a_analytic_gap.statistics(jax_kl, POSITIONS, "parity", mom["effective_noise"], sampled_gap)
    assert json.loads(json.dumps(stats)) == want

    # The port's whole pass: its KL (torch f64) and the statistics of it.
    got = fig3a_analytic_gap.main(["--device", "cpu", "--stats_only", "--out", str(out), "--data", str(sampled),
                                   "--label", "parity"])
    for which in ("nominal", "effective"):
        np.testing.assert_allclose(got["kl"][which], jax_kl[which], rtol=1e-9, atol=1e-12)
        assert got[f"n_for_1e3_{which}"] == want[f"n_for_1e3_{which}"]
        for key in ("kl_mean", "kl_median", "kl_ci95", "kl_std"):
            np.testing.assert_allclose(got[f"{key}_{which}"], want[f"{key}_{which}"], rtol=1e-9, atol=1e-12)
    assert got["verdict_effective"] == want["verdict_effective"]
    for key in ("sampled_gap_std", "variance_reduction"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9)
    assert got["sampled_n_for_1e3"] == want["sampled_n_for_1e3"]
    assert json.loads((out / "analytic_gap.json").read_text())["verdict_effective"] == want["verdict_effective"]


@pytest.fixture
def tiny(monkeypatch):
    for module in (fig3a_longrun, fig3a_analytic_gap, fig3a_robust_eval):
        monkeypatch.setattr(module, "FIG3A_MODEL", TINY)
    monkeypatch.setattr(gp_fitting, "QUICK", dict(TINY, batch_size=16, steps_per_epoch=20, warmup_epochs=1,
                                                  updates_per_call=10))


def _state(ck):
    return restore_checkpoint(str(ck), map_location="cpu")


def _assert_same_state(a, b):
    assert a["epoch"] == b["epoch"] and a["step"] == b["step"]
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    assert torch.equal(a["generator"], b["generator"])
    for sa, sb in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        assert all(torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq"))


def test_experiment_clis_run_resume_and_score(tmp_path, tiny, capsys):
    init = tmp_path / "init"
    save_checkpoint(str(init / "epoch_0"), {"model": state_dict_from_flax_params(
        seeded_flax_params(1, TINY["emsize"], TINY["nhid"], TINY["nlayers"], BUCKETS, seed=0), TINY["nlayers"])})
    common = ["--device", "cpu", "--bptt", str(T), "--num_buckets", str(BUCKETS)]
    run = common + ["--checkpoint_every", "1", "--init_from", str(init), "--eval_pos_sampler", "mixture"]

    # The long run: 1 epoch, then a resume to 2, against 2 uninterrupted.
    first = fig3a_longrun.main(run + ["--out", str(tmp_path / "run"), "--epochs", "1", "--skip_eval"])
    assert first["done"] and [s["epoch"] for s in first["epoch_stats"]] == [1]
    resumed = fig3a_longrun.main(run + ["--out", str(tmp_path / "run"), "--epochs", "2", "--eval_batch", "4"])
    assert "resumed from" in capsys.readouterr().out
    straight = fig3a_longrun.main(run + ["--out", str(tmp_path / "straight"), "--epochs", "2", "--skip_eval"])
    assert [s["epoch"] for s in resumed["epoch_stats"]] == [2]
    assert all(np.isfinite(s["mean_loss"]) for s in first["epoch_stats"] + resumed["epoch_stats"])
    _assert_same_state(_state(tmp_path / "run/ck/epoch_2"), _state(tmp_path / "straight/ck/epoch_2"))
    curves = json.loads((tmp_path / "run/curves.json").read_text())
    assert set(curves) == {"positions", "pfn_nll", "oracle_nll", "oracle_nll_noise1e-3", "final_train_loss",
                           "oracle_seconds", "epochs", "bucket_seq_cap", "grid", "effective_noise", "note"}
    assert curves["positions"] == [1, 2, 5, 10, 20, 50] and curves["effective_noise"] == 1e-3
    assert np.isfinite(curves["pfn_nll"] + curves["oracle_nll"] + curves["oracle_nll_noise1e-3"]).all()
    oracle = fig3a_longrun.main(common + ["--out", str(tmp_path / "run"), "--oracle_pass"])
    assert oracle["oracle_nll"] == curves["oracle_nll"]

    # The robust eval, then the analytic gap on its datasets.
    ck = str(tmp_path / "run/ck")
    score = common + ["--ck", ck, "--chunks", "2", "--chunk_batch", "3"]
    robust = fig3a_robust_eval.main(score + ["--out", str(tmp_path / "robust")])
    assert robust["n_datasets"] == 6 and robust["checkpoint"].endswith("epoch_2")
    assert np.isfinite(np.asarray(robust["gap_ci95_effective"])).all()
    again = fig3a_robust_eval.main(score + ["--out", str(tmp_path / "robust"), "--stats_only"])
    assert again["gap_ci95_nominal"] == robust["gap_ci95_nominal"]
    gap = fig3a_analytic_gap.main(score + ["--out", str(tmp_path / "agap"), "--data", str(tmp_path / "robust")])
    kl = np.stack([gap["kl"]["nominal"], gap["kl"]["effective"]])
    assert kl.shape == (2, 6, 6) and np.isfinite(kl).all() and kl.min() >= -1e-6
    assert len(gap["verdict_effective"]) == 6 and len(gap["variance_reduction"]) == 6
    data = np.load(tmp_path / "agap/eval_data.npz")
    np.testing.assert_array_equal(data["x"], np.load(tmp_path / "robust/eval_data.npz")["x"])
    # A rerun finds phases A and B on disk and recomputes only C.
    mtime = os.path.getmtime(tmp_path / "agap/pfn_logits.npy")
    rerun = fig3a_analytic_gap.main(score + ["--out", str(tmp_path / "agap"), "--data", str(tmp_path / "robust")])
    assert os.path.getmtime(tmp_path / "agap/pfn_logits.npy") == mtime
    assert rerun["kl_ci95_effective"] == gap["kl_ci95_effective"]


def test_gp_fitting_quick_cli(tmp_path, tiny):
    out = gp_fitting.main(["--device", "cpu", "--quick", "--bptt", str(T), "--epochs", "2", "--num_buckets",
                           str(BUCKETS), "--out", str(tmp_path / "fit"), "--checkpoint", str(tmp_path / "ck")])
    curves = json.loads((tmp_path / "fit/curves.json").read_text())
    assert set(curves) == {"positions", "pfn_nll", "oracle_nll", "final_train_loss", "oracle_seconds"}
    assert curves["positions"] == list(range(1, T, T // 50))
    assert np.isfinite(curves["pfn_nll"] + curves["oracle_nll"]).all()
    losses = [s["mean_loss"] for s in out["epoch_stats"]]
    assert len(losses) == 2 and np.isfinite(losses).all() and losses[1] < losses[0]
    names = state_dict_from_flax_params(seeded_flax_params(1, 32, 64, 2, BUCKETS), TINY["nlayers"])
    assert set(restore_checkpoint(str(tmp_path / "ck"))["model"]) == set(names)


@pytest.mark.parametrize("method", ["fft", "chol"])
def test_grid_fidelity_cli(tmp_path, method):
    out = grid_fidelity.main(["--device", "cpu", "--grid", "512", "--bptt", "200", "--batch", "16", "--method",
                              method, "--out", str(tmp_path / "gf.json")])
    assert json.loads((tmp_path / "gf.json").read_text()) == json.loads(json.dumps(out))
    assert out["duplicate_pairs"] > 100 and out["verdict"] == "nominal"
    lo, hi = out["effective_noise_ci95"]
    assert lo <= 1e-4 <= hi and out["latent_err_rms_over_noise_sd"] < 1e-3
    assert out["prior_moments"]["verdict"] == "consistent"
    assert [c["lag"] for c in out["prior_moments"]["cov"]] == [0, 32, 64, 128, 256]


@pytest.mark.parametrize("script", [gp_fitting, fig3a_longrun, fig3a_analytic_gap, fig3a_robust_eval, grid_fidelity])
def test_experiments_need_a_card_by_default(monkeypatch, script):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main([])
