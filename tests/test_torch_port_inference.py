"""The port's approximate-inference oracles (``pfn_tpu_torch.evals.inference``)
against the JAX package's and against known posteriors, on the CPU.

  * ``svgd`` against the JAX ``svgd`` from the same initial particles (both
    deterministic: the JAX key is unused), 50 steps, at 1e-4 (f32 through 50
    steps of kernel sums). 16 particles give 256 pairwise distances, an even
    count, where the true median (the JAX rule) and ``torch.median``'s lower
    middle value differ: the same run with the lower value misses the JAX
    particles by more than the tolerance.
  * ``svi`` and ``hmc`` recover the conjugate and the correlated Gaussian of
    ``tests/test_inference.py`` at that file's tolerances (the random
    streams differ, so the comparison is with the posterior, not with JAX).
  * A batched ``svi`` of one problem equals the unbatched one bitwise. A
    batched ``hmc`` keeps a problem whose first trajectories diverge apart
    from the others (each adapts its own step size; the others keep their
    posterior moments), and a problem whose log density is NaN away from its
    start rejects every trajectory (acceptance 0, the start kept: the NaN
    rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.evals.inference import svgd as jax_svgd
from pfn_tpu_torch.evals import inference
from pfn_tpu_torch.evals.inference import hmc, svgd, svi


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many tiny ops, which other workers' OpenMP
    threads would otherwise thrash."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _conjugate():
    """mu ~ N(0, 1); 20 observations of 1.0 with noise variance 0.25."""
    n, sigma2 = 20, 0.25
    y = torch.full((n,), 1.0)
    post_var = 1.0 / (1.0 + n / sigma2)
    post_mean = post_var * n / sigma2

    def log_joint(theta):
        mu = theta["mu"]
        return -0.5 * mu ** 2 - 0.5 * ((y - mu[..., None]) ** 2).sum(-1) / sigma2

    return log_joint, post_mean, post_var


_MEAN = np.array([2.0, -1.0], np.float32)
_PREC = np.array([[1.5, 0.4], [0.4, 0.8]], np.float32)


def _svgd_inputs():
    return np.random.default_rng(0).standard_normal((16, 2)).astype(np.float32)


def _svgd_port(init):
    prec, mean = torch.as_tensor(_PREC), torch.as_tensor(_MEAN)
    return svgd(lambda x: -0.5 * (((x - mean) @ prec) * (x - mean)).sum(-1), torch.as_tensor(init), num_steps=50,
                lr=0.3).numpy()


def test_svgd_matches_jax():
    init = _svgd_inputs()
    want = np.asarray(jax_svgd(lambda x: -0.5 * (x - _MEAN) @ _PREC @ (x - _MEAN), jnp.asarray(init),
                               jax.random.PRNGKey(1), num_steps=50, lr=0.3))
    np.testing.assert_allclose(_svgd_port(init), want, atol=1e-4, rtol=1e-4)


def test_svgd_lower_median_would_show(monkeypatch):
    """The hazard the test above guards: torch.median's lower middle value
    in place of the true median moves the particles past 1e-4."""
    init = _svgd_inputs()
    good = _svgd_port(init)
    monkeypatch.setattr(inference, "median", lambda d: d.median(dim=1, keepdim=True).values)
    assert np.abs(_svgd_port(init) - good).max() > 1e-4


def test_svi_recovers_conjugate_gaussian():
    log_joint, post_mean, post_var = _conjugate()
    res = svi(log_joint, {"mu": torch.zeros(())}, torch.Generator().manual_seed(0), num_steps=2000, lr=2e-2,
              num_particles=8)
    assert abs(float(res.mu["mu"]) - post_mean) < 0.05
    assert abs(float(res.log_sigma["mu"].exp() ** 2) - post_var) < 0.02
    assert float(res.losses[-50:].mean()) < float(res.losses[:50].mean())  # the ELBO improved
    assert res.sample(torch.Generator().manual_seed(1), 64)["mu"].shape == (64,)


def test_svi_batch_of_one_is_the_unbatched_fit():
    log_joint, _, _ = _conjugate()
    one = svi(log_joint, {"mu": torch.zeros(())}, torch.Generator().manual_seed(3), num_steps=50, lr=2e-2)
    batched = svi(log_joint, {"mu": torch.zeros(1)}, torch.Generator().manual_seed(3), num_steps=50, lr=2e-2,
                  batch_shape=(1,))
    assert batched.losses.shape == (50, 1)
    assert torch.equal(batched.mu["mu"][0], one.mu["mu"]) and torch.equal(batched.losses[:, 0], one.losses)


def test_hmc_recovers_conjugate_gaussian():
    log_joint, post_mean, post_var = _conjugate()
    samples, accept = hmc(log_joint, {"mu": torch.zeros(())}, torch.Generator().manual_seed(0), num_samples=1500,
                          num_warmup=500, num_leapfrog=10)
    mu = samples["mu"].numpy()
    assert mu.shape == (1500,)
    assert 0.4 < float(accept) < 1.0
    assert abs(mu.mean() - post_mean) < 0.05
    assert abs(mu.var() - post_var) < 0.03


def test_hmc_correlated_gaussian():
    cov = np.array([[1.0, 0.8], [0.8, 1.0]], np.float32)
    prec = torch.as_tensor(np.linalg.inv(cov))
    samples, _ = hmc(lambda th: -0.5 * th["x"] @ prec @ th["x"], {"x": torch.zeros(2)},
                     torch.Generator().manual_seed(1), num_samples=2000, num_warmup=500, num_leapfrog=15)
    np.testing.assert_allclose(np.cov(samples["x"].numpy().T), cov, atol=0.25)


def test_batched_hmc_keeps_a_diverging_problem_apart():
    """Problems 0 and 2: the conjugate Gaussian shifted by 0 and by +3;
    problem 1: N(0, 1e-6), where the initial step size 0.1 is 100x its
    scale, so that its first trajectories overflow to inf and NaN energies
    (rejected). Its own step size adapts; the others keep their moments."""
    log_joint, post_mean, post_var = _conjugate()
    shift = torch.tensor([0.0, 0.0, 3.0])
    stiff = torch.arange(3) == 1

    def log_prob(theta):
        mu = theta["mu"]
        return torch.where(stiff, -0.5e6 * mu ** 2, log_joint({"mu": mu - shift}))

    samples, accept = hmc(log_prob, {"mu": torch.zeros(3)}, torch.Generator().manual_seed(2), num_samples=1500,
                          num_warmup=500, num_leapfrog=10, batch_shape=(3,))
    mu = samples["mu"].numpy()
    assert mu.shape == (1500, 3) and np.isfinite(mu).all()
    assert abs(mu[:, 1].mean()) < 2e-4 and 0.5e-6 < mu[:, 1].var() < 2e-6
    for i in (0, 2):
        assert 0.4 < float(accept[i]) < 1.0
        assert abs(mu[:, i].mean() - post_mean - float(shift[i])) < 0.05
        assert abs(mu[:, i].var() - post_var) < 0.03


def test_hmc_rejects_nan_energies():
    """Without warm-up the step size stays 0.1: problem 1, whose log density
    is NaN away from its start, rejects every trajectory (acceptance 0, the
    start kept), beside a problem that samples."""
    log_joint, post_mean, _ = _conjugate()

    def log_prob(theta):
        mu = theta["mu"]
        return torch.where((torch.arange(2) == 1) & (mu != 0), torch.nan, log_joint(theta))

    samples, accept = hmc(log_prob, {"mu": torch.zeros(2)}, torch.Generator().manual_seed(4), num_samples=300,
                          num_warmup=0, num_leapfrog=10, batch_shape=(2,))
    mu = samples["mu"].numpy()
    assert float(accept[1]) == 0.0 and (mu[:, 1] == 0.0).all()
    assert float(accept[0]) > 0.4 and abs(mu[:, 0].mean() - post_mean) < 0.05
