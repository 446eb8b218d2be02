"""The two Fig-3a gap analyses of the port and its prior data loader, on the CPU.

  * ``gaussian_bar_floor`` and ``interior_kl`` of
    ``pfn_tpu_torch.experiments.{bar_resolution_floor,analytic_gap_decompose}``
    against the JAX scripts' functions (``experiments/*.py``) on 20 (mu,
    sigma) pairs and 200 borders, within 1e-12.
  * The decomposition's KL_total (the port's ``FullSupportBarDistribution``
    on float64 borders, in float64) against the JAX package's ``gaussian_kl``
    under x64, run in a subprocess because x64 holds for its whole process,
    on random logits of (P 3, N 4, K 50), within 1e-10 relative.
  * The port's ``get_bucket_limits`` on the same numpy ys as JAX's, within
    1e-6.
  * Each ported CLI end to end with ``--device cpu`` on small intermediates:
    every JSON field equal to the JAX script's on the same files (floats
    within 1e-12, the decomposition's KL terms within 1e-10 relative); the
    floor's rebuilt borders equal ``fig3a_longrun``'s criterion, and their
    shift against the run's borders is written; without ``--device`` each CLI
    needs a card and raises.
  * ``PriorDataLoader``: length, yield structure and shapes against the JAX
    loader on a ``GPPrior``, equal batches from two loaders of one seed.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pfn_tpu_torch.distributions import FullSupportBarDistribution, get_bucket_limits
from pfn_tpu_torch.experiments import analytic_gap_decompose, bar_resolution_floor
from pfn_tpu_torch.experiments.common import GP_HP, bucket_criterion
from pfn_tpu_torch.priors import GPPrior, PriorDataLoader, make_dataloader

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
POSITIONS = [1, 5, 20, 50]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file, as the other Fig-3a test files:
    small CPU ops beside other workers' OpenMP threads thrash."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_script(name: str):
    """The module of ``experiments/<name>.py`` (JAX is imported inside its
    functions only, so loading it imports none)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", ROOT / "experiments" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")


@pytest.mark.parametrize("layout", ["equal_mass", "equal_width"])
def test_floor_and_interior_kl_match_the_jax_scripts(layout):
    rng = np.random.default_rng(3)
    if layout == "equal_mass":
        borders = np.sort(rng.normal(0.0, 1.0, 200)).astype(np.float32)
    else:
        borders = np.linspace(-2.5, 2.5, 200, dtype=np.float32)
    log_p = torch.log_softmax(torch.as_tensor(rng.normal(0, 2, 199)), 0).numpy()
    mus = rng.uniform(-3.0, 3.0, 20)  # some near and past the span's ends
    sigmas = np.exp(rng.uniform(np.log(0.01), np.log(1.0), 20))
    jax_floor, jax_dec = _jax_script("bar_resolution_floor"), _jax_script("analytic_gap_decompose")
    for mu, sigma in zip(mus, sigmas):
        kl, out = bar_resolution_floor.gaussian_bar_floor(float(mu), float(sigma), borders)
        want_kl, want_out = jax_floor.gaussian_bar_floor(float(mu), float(sigma), borders)
        assert abs(kl - want_kl) <= 1e-12 and abs(out - want_out) <= 1e-12
        got = analytic_gap_decompose.interior_kl(float(mu), float(sigma), borders, log_p)
        assert abs(got - jax_dec.interior_kl(float(mu), float(sigma), borders, log_p)) <= 1e-12
    # Past the span the floor reports all of the mass outside it.
    assert bar_resolution_floor.gaussian_bar_floor(50.0, 0.1, borders) == (0.0, 1.0)


_JAX_X64 = """
import runpy, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from pfn_tpu.distributions import FullSupportBarDistribution
root, agap = sys.argv[1], sys.argv[2]
d = np.load(root + "/kl_in.npz")
dist = FullSupportBarDistribution(jnp.asarray(d["borders"].astype(np.float64)))
kl = dist.gaussian_kl(jnp.asarray(d["logits"], jnp.float64), jnp.asarray(d["mu"]), jnp.asarray(d["var"]))
np.savez(root + "/kl_jax.npz", kl=np.asarray(kl), log_p=np.asarray(jax.nn.log_softmax(jnp.asarray(d["logits"]), axis=-1)))
sys.argv = ["analytic_gap_decompose.py", "--dir", agap, "--label", "parity", "--out", root + "/decompose_jax.json"]
runpy.run_path("experiments/analytic_gap_decompose.py", run_name="__main__")
"""


@pytest.fixture(scope="module")
def jax_x64(tmp_path_factory):
    """One subprocess under JAX x64 (it holds for the whole process): the
    JAX ``gaussian_kl`` of random logits of (P 3, N 4, K 50) on float64
    borders, and the JAX decomposition script on ``_intermediates``."""
    root = tmp_path_factory.mktemp("jax_x64")
    rng = np.random.default_rng(5)
    P, N, K = 3, 4, 50
    borders = np.sort(rng.normal(0.0, 1.0, K + 1)).astype(np.float32)
    logits = rng.normal(0.0, 2.0, (P, N, K))
    mu = rng.uniform(-2.5, 2.5, (P, N))  # past the span too: the tails carry mass
    var = np.exp(rng.uniform(np.log(1e-4), np.log(1.0), (P, N)))
    np.savez(root / "kl_in.npz", borders=borders, logits=logits, mu=mu, var=var)
    agap = _intermediates(root)
    proc = subprocess.run([sys.executable, "-c", _JAX_X64, str(root), str(agap)], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return root, agap


def test_kl_total_matches_jax_gaussian_kl_under_x64(jax_x64):
    root, _ = jax_x64
    d, want = np.load(root / "kl_in.npz"), np.load(root / "kl_jax.npz")
    total, log_p = analytic_gap_decompose.total_kl(d["logits"], d["borders"], d["mu"], d["var"], CPU)
    assert total.dtype == np.float64 and total.shape == (3, 4)
    assert np.abs(total - want["kl"]).max() <= 1e-10 * np.abs(want["kl"]).max()
    assert np.abs(log_p - want["log_p"]).max() <= 1e-12
    # The float64 borders survive a move (the tails' scales stay float64).
    dist = FullSupportBarDistribution(d["borders"].astype(np.float64), dtype=torch.float64).to(CPU)
    assert dist.borders.dtype == torch.float64


def test_bucket_limits_match_jax():
    from pfn_tpu.distributions import get_bucket_limits as jax_limits

    ys = np.random.default_rng(7).normal(0.0, 1.0, 20_000).astype(np.float32)
    for num in (50, 1000):
        got = get_bucket_limits(num, ys=ys).numpy()
        want = np.asarray(jax_limits(num, ys=ys))
        assert got.shape == want.shape == (num + 1,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _intermediates(root: Path, K: int = 1000, N: int = 12, seed: int = 11) -> Path:
    """An analytic-gap directory of 4 context sizes x N datasets: equal-mass
    borders of K buckets, random logits, oracle moments (one mean past the
    span), and analytic_gap.json with the KL statistics the decomposition
    cross-checks."""
    rng = np.random.default_rng(seed)
    out = root / "agap"
    out.mkdir(parents=True)
    borders = get_bucket_limits(K, ys=rng.normal(0.0, 1.0, 50 * K).astype(np.float32)).numpy()
    P = len(POSITIONS)
    logits = rng.normal(0.0, 1.5, (P, N, K)).astype(np.float32)
    mu = rng.normal(0.0, 1.0, (P, N))
    mu[0, 0] = 5.0
    var = np.exp(rng.uniform(np.log(1e-3), np.log(0.5), (P, N)))
    np.save(out / "borders.npy", borders)
    np.save(out / "pfn_logits.npy", logits)
    np.savez(out / "oracle_moments.npz", effective_noise=np.asarray(1e-4), nominal_mean=mu, nominal_var=var,
             effective_mean=mu, effective_var=var)
    total, _ = analytic_gap_decompose.total_kl(logits, borders, mu, var, CPU)
    gap = {"positions": POSITIONS, "n_datasets": N, "kl_mean_effective": total.mean(1).tolist(),
           "kl_median_effective": np.median(total, 1).tolist()}
    (out / "analytic_gap.json").write_text(json.dumps(gap))
    return out


def _assert_same_fields(got: dict, want: dict, rtol: float) -> None:
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, list) and value and isinstance(value[0], float):
            np.testing.assert_allclose(got[key], value, rtol=rtol, atol=1e-12, err_msg=key)
        else:
            assert got[key] == value, key


def test_floor_cli_matches_the_jax_script(tmp_path):
    agap = _intermediates(tmp_path)
    files = ["--moments", str(agap / "oracle_moments.npz"), "--analytic", str(agap / "analytic_gap.json"),
             "--check_borders", str(agap / "borders.npy"), "--buckets", "1000"]
    proc = subprocess.run([sys.executable, "experiments/bar_resolution_floor.py", *files,
                           "--out", str(tmp_path / "jax.json")], cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = bar_resolution_floor.main(["--device", "cpu", *files, "--out", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert got["borders_1000b"] == "committed (exact)"
    _assert_same_fields(got, want, rtol=1e-12)
    assert got["out_of_support_mass_mean_1000b"][0] > 0  # the mean past the span


def test_floor_cli_rebuilds_the_longrun_borders(tmp_path):
    """With --seq_cap the borders are rebuilt as fig3a_longrun's criterion on
    the exact prior; against the run's own borders.npy the shift is written
    (0 when the run's borders are that criterion's)."""
    agap = _intermediates(tmp_path, K=50, N=4)
    run = bucket_criterion(GPPrior(num_features=1, **GP_HP), 50, 64, CPU, seed=7, max_seq_len=16)
    np.save(agap / "borders.npy", run.bar.borders.numpy())
    got = bar_resolution_floor.main([
        "--device", "cpu", "--moments", str(agap / "oracle_moments.npz"), "--analytic",
        str(agap / "analytic_gap.json"), "--check_borders", str(agap / "borders.npy"), "--bptt", "64",
        "--seq_cap", "16", "--buckets", "50", "20", "--out", str(tmp_path / "floor.json")])
    assert got["seq_cap"] == 16
    assert got["borders_50b_max_shift_vs_run"] == 0.0
    assert "borders_20b_max_shift_vs_run" not in got  # a bucket count the run's borders do not have
    for nb in (50, 20):
        floors = np.asarray(got[f"floor_mean_{nb}b"])
        assert floors.shape == (len(POSITIONS),) and np.isfinite(floors).all() and (floors >= 0).all()
    # Fewer buckets, a coarser head: a higher floor.
    assert np.mean(got["floor_mean_20b"]) > np.mean(got["floor_mean_50b"])


def test_decompose_cli_matches_the_jax_script(jax_x64, tmp_path):
    root, agap = jax_x64
    got = analytic_gap_decompose.main(["--device", "cpu", "--dir", str(agap), "--label", "parity",
                                       "--out", str(tmp_path / "port.json")])
    want = json.loads((root / "decompose_jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == got
    _assert_same_fields(got, want, rtol=1e-10)
    tail = np.asarray(got["kl_tail_mean"])
    assert tail[0] > 0.1 * got["kl_total_mean"][0]  # the mean past the span: its KL sits in the tails


@pytest.mark.parametrize("cli", [bar_resolution_floor, analytic_gap_decompose])
def test_the_analyses_need_a_card_without_device(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--out", str(tmp_path / "x.json")])


def test_prior_data_loader_against_the_jax_loader():
    from pfn_tpu.priors.gp import GPPrior as JaxGPPrior
    from pfn_tpu.priors import make_dataloader as jax_make_dataloader

    hp = dict(noise=1e-4, outputscale=1.0, lengthscale=0.6)
    want_loader = jax_make_dataloader(JaxGPPrior(num_features=1, **hp), 3, 2, 16, seed=4)
    loader = make_dataloader(GPPrior(num_features=1, **hp), 3, 2, 16, seed=4, device="cpu")
    assert isinstance(loader, PriorDataLoader)
    assert len(loader) == len(want_loader) == 3
    assert (loader.num_features, loader.num_outputs) == (want_loader.num_features, want_loader.num_outputs)
    assert loader.validate(None) is None and want_loader.validate(None) is None
    got, want = list(loader), list(want_loader)
    assert len(got) == len(want) == 3
    for ((x, y), ty), ((wx, wy), wty) in zip(got, want):
        assert (tuple(x.shape), tuple(y.shape), tuple(ty.shape)) == (wx.shape, wy.shape, wty.shape) == (
            (2, 16, 1), (2, 16), (2, 16))
        assert x.device == CPU and torch.isfinite(y).all()
    # One seed, equal batches (again on a second pass); another seed, others.
    again = make_dataloader(GPPrior(num_features=1, **hp), 3, 2, 16, seed=4, device="cpu")
    for ((x, y), ty), ((x2, y2), ty2) in zip(got, again):
        assert torch.equal(x, x2) and torch.equal(y, y2) and torch.equal(ty, ty2)
    assert all(torch.equal(a[0][1], b[0][1]) for a, b in zip(got, loader))
    other = next(iter(make_dataloader(GPPrior(num_features=1, **hp), 1, 2, 16, seed=5, device="cpu")))
    assert not torch.equal(other[0][1], got[0][0][1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PriorDataLoader(GPPrior(num_features=1, **hp), 1, 2, 16)
