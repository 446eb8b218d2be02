"""The inference slice end to end, JAX package against the port.

numpy GP data -> JAX eval_positional_logits_per_dataset (Pallas flash
attention in interpret mode) -> JAX f64 exact-GP oracle -> analytic KL, and
the same chain in the port (on the CPU its attention takes the dense path;
on the card the same code launches the kernel, which chip_smoke.py checks).
The scoring protocol is experiments/fig3a_analytic_gap.py's.

Tolerances: logits 1e-4 (atol and rtol), two f32 layers of summation-order
differences; KL 1e-3 relative, since the reference's f64 oracle carries an
f32-rounded distance term (see tests/test_torch_port_gp.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from pfn_tpu.distributions import FullSupportBarDistribution as JaxFullBar
from pfn_tpu.distributions import get_bucket_limits as jax_bucket_limits
from pfn_tpu.evals import eval_positional_logits_per_dataset as jax_positional_logits
from pfn_tpu.evals import gp_exact_posterior_moments as jax_moments
from pfn_tpu.models.transformer import PFNTransformer as JaxPFN
from pfn_tpu.models.transformer import TransformerConfig as JaxConfig
from pfn_tpu_torch.distributions import get_bucket_limits
from pfn_tpu_torch.evals import eval_positional_logits_per_dataset, gp_exact_posterior_moments
from pfn_tpu_torch.models import PFNTransformer, TransformerConfig
from pfn_tpu_torch.train import full_support_bar_criterion, seeded_flax_params, state_dict_from_flax_params

HP = dict(noise=1e-4, outputscale=1.0, lengthscale=0.6)
EMSIZE, NHEAD, NHID, NLAYERS, BUCKETS = 256, 2, 256, 2, 100
B, T, POSITIONS = 2, 150, [1, 40, 120]


def _numpy_gp_data(n, seed):
    """(x (n, T, 1), y (n, T)) from a numpy f64 Cholesky of the RBF kernel."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, T, 1))
    d2 = (x - np.swapaxes(x, 1, 2)) ** 2
    K = HP["outputscale"] * np.exp(-0.5 * d2 / HP["lengthscale"] ** 2) + HP["noise"] * np.eye(T)
    y = np.einsum("bij,bj->bi", np.linalg.cholesky(K + 1e-10 * np.eye(T)), rng.standard_normal((n, T)))
    return x.astype(np.float32), y.astype(np.float32)


def test_slice_matches_jax():
    _, ys = _numpy_gp_data(40, seed=7)
    borders = get_bucket_limits(BUCKETS, ys=ys)
    np.testing.assert_array_equal(borders.numpy(), np.asarray(jax_bucket_limits(BUCKETS, ys=ys)))
    x, y = _numpy_gp_data(B, seed=991)
    params = seeded_flax_params(1, EMSIZE, NHID, NLAYERS, BUCKETS, seed=0)

    jcfg = JaxConfig(num_features=1, n_out=BUCKETS, emsize=EMSIZE, nhead=NHEAD, nhid=NHID, nlayers=NLAYERS,
                     attention_impl="flash")
    with pltpu.force_tpu_interpret_mode():
        want_logits = np.asarray(jax_positional_logits(
            JaxPFN(jcfg), jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y), jnp.asarray(POSITIONS)))
    with jax.enable_x64(True):
        mu, var = jax_moments(jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64), HP,
                              positions=jnp.asarray(POSITIONS), dtype=jnp.float64)
        want_kl = np.asarray(JaxFullBar.create(np.asarray(borders)).gaussian_kl(
            jnp.asarray(want_logits, jnp.float64), mu, var))

    model = PFNTransformer(TransformerConfig(num_features=1, n_out=BUCKETS, emsize=EMSIZE, nhead=NHEAD, nhid=NHID,
                                             nlayers=NLAYERS)).eval()
    model.load_state_dict(state_dict_from_flax_params(params, NLAYERS), strict=True)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    logits = eval_positional_logits_per_dataset(model, xt, yt, POSITIONS)
    mu_t, var_t = gp_exact_posterior_moments(xt, yt, HP, positions=POSITIONS, dtype=torch.float64)
    kl = full_support_bar_criterion(borders).bar.gaussian_kl(logits.double(), mu_t, var_t)

    assert logits.shape == (len(POSITIONS), B, BUCKETS)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=1e-4, rtol=1e-4)
    assert kl.dtype == torch.float64 and bool(torch.isfinite(kl).all()) and float(kl.min()) >= -1e-6
    np.testing.assert_allclose(kl.numpy(), want_kl, rtol=1e-3, atol=1e-6)
