"""The ridge, module and stroke priors of the port against the JAX package's,
and the grid sampler's clipped-mass check, on the CPU.

Every port sampler is ``draw(generator)`` plus a deterministic
``from_draws``; the tests feed ``from_draws`` with the JAX priors' draws,
replayed from their key trees (the ``split`` and ``fold_in`` calls of
``pfn_tpu/priors/{ridge,module,stroke}.py``), and compare with the JAX
``sample`` on the same key. Tolerances: ridge 1e-6 (atol and rtol: an f32
einsum in another order), module 1e-6 (the same per-dataset z-score),
stroke images 1e-5 (cos, sin and square roots of f32 coordinates up to
28 through the capsule cover, then the blur), labels and targets equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.ops import gp_sample as jgp
from pfn_tpu.priors.module import ModulePrior as JaxModulePrior
from pfn_tpu.priors.ridge import RidgePrior as JaxRidgePrior
from pfn_tpu.priors.stroke import StrokePrior as JaxStrokePrior
from pfn_tpu_torch.ops import gp_sample as tgp
from pfn_tpu_torch.priors import GPPrior, ModulePrior, RidgePrior, StrokePrior

RIDGE_TOL, MODULE_TOL, STROKE_TOL = 1e-6, 1e-6, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small CPU ops, beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


# ---- ridge ---------------------------------------------------------------------


@pytest.mark.parametrize("num_features", [1, 5])
def test_ridge_from_jax_draws(num_features):
    B, T = 4, 30
    jprior = JaxRidgePrior(num_features=num_features, noisy_std=0.2, weight_std=0.3)
    key = jax.random.PRNGKey(num_features)
    want = jprior.sample(key, B, T)
    k_w, k_x, k_n = jax.random.split(key, 3)
    draws = {"w": _t(jax.random.normal(k_w, (B, num_features))), "x": _t(jax.random.uniform(k_x, (B, T, num_features))),
             "noise": _t(jax.random.normal(k_n, (B, T)))}
    got = RidgePrior(num_features=num_features, noisy_std=0.2, weight_std=0.3).from_draws(draws)
    for g, w in zip(got, want):
        _close(g, w, RIDGE_TOL)


def test_ridge_sample_shapes_and_noise_free_target():
    prior = RidgePrior(num_features=3)
    x, y, y_clean = prior.sample(5, 40, generator=torch.Generator().manual_seed(0))
    assert x.shape == (5, 40, 3) and y.shape == y_clean.shape == (5, 40)
    assert float(x.min()) >= 0.0 and float(x.max()) < 1.0
    resid = (y - y_clean).flatten()
    assert 0.05 < float(resid.std()) < 0.15  # noisy_std 0.1
    again = prior.sample(5, 40, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(again[1], y, atol=0, rtol=0)


# ---- module ----------------------------------------------------------------------

F_MOD = 2


def _jax_sample_fn(model_key, data_key, seq_len):
    slope = jax.random.normal(model_key, (F_MOD,))
    x = 3.0 * jax.random.uniform(data_key, (seq_len, F_MOD)) + 1.0
    y = x @ slope + 0.1 * jax.random.normal(jax.random.fold_in(data_key, 1), (seq_len,))
    return x, y


@pytest.mark.parametrize("normalize_x", [True, False])
def test_module_prior_from_jax_draws(normalize_x):
    """The JAX prior's datasets, drawn by its per-dataset callable on its
    replayed model and data keys, laid out as the port's batched callable
    returns them: the port's grouping and normalisation give the JAX
    prior's batch."""
    B, T, g = 8, 20, 4
    key = jax.random.PRNGKey(7)
    jprior = JaxModulePrior(_jax_sample_fn, num_features=F_MOD, batch_size_per_model=g, normalize_x=normalize_x)
    want = jprior.sample(key, B, T)
    k_models, k_data = jax.random.split(key)
    model_keys = jnp.repeat(jax.random.split(k_models, B // g), g, axis=0)
    data_keys = jax.random.split(k_data, B)
    raw = [_jax_sample_fn(mk, dk, T) for mk, dk in zip(model_keys, data_keys)]
    xs, ys = np.stack([np.asarray(r[0]) for r in raw]), np.stack([np.asarray(r[1]) for r in raw])
    seen = []

    def replayed(generator, num_models, group_size, seq_len):
        seen.append((num_models, group_size, seq_len))
        return _t(xs).reshape(num_models, group_size, seq_len, F_MOD), _t(ys).reshape(num_models, group_size, seq_len)

    prior = ModulePrior(replayed, num_features=F_MOD, batch_size_per_model=g, normalize_x=normalize_x)
    got = prior.sample(B, T, generator=torch.Generator().manual_seed(0))
    assert seen == [(B // g, g, T)]
    for a, b in zip(got, want):
        _close(a, b, MODULE_TOL)


def test_module_prior_groups_share_their_model():
    """A batched callable on the generator: the datasets of one group share
    the model drawn for it (here a slope), and the groups differ; the
    default group size is the JAX package's default_group_size(B, 16)."""

    def linear(generator, num_models, group_size, seq_len):
        slope = torch.randn(num_models, 1, 1, generator=generator)
        x = torch.rand(num_models, group_size, seq_len, 1, generator=generator)
        return x, (slope * x[..., 0])

    prior = ModulePrior(linear, num_features=1, batch_size_per_model=3, normalize_x=False)
    x, y, target = prior.sample(6, 10, generator=torch.Generator().manual_seed(1))
    slopes = (y / x[..., 0]).mean(dim=1)
    torch.testing.assert_close(slopes[:3], slopes[:1].expand(3))
    torch.testing.assert_close(slopes[3:], slopes[3:4].expand(3))
    assert not torch.allclose(slopes[0], slopes[3])
    assert torch.equal(y, target)
    assert ModulePrior(linear, num_features=1).group_size(64) == 4
    with pytest.raises(ValueError, match="divisible"):
        prior.sample(7, 10, generator=torch.Generator().manual_seed(1))


# ---- stroke ----------------------------------------------------------------------


def jax_stroke_draws(prior: JaxStrokePrior, key, B: int, T: int) -> dict:
    """The draws of pfn_tpu's StrokePrior.sample(key, B, T), replayed, in the
    layout of the port's StrokePrior.draw (one jitted call)."""
    return {k: _t(v) for k, v in jax.jit(lambda k: _stroke_draws(prior, k, B, T))(key).items()}


def _stroke_draws(prior: JaxStrokePrior, key, B: int, T: int) -> dict:
    size, C, S, K = prior.size, prior.num_outputs, prior.min_max_strokes[1], prior.num_direction_candidates
    k_prog, k_lab, k_render = jax.random.split(key, 3)
    ks = jax.random.split(k_prog, 5)
    lead = (B, C, S)
    d = {
        "num_strokes": jax.random.randint(ks[0], (B, C), prior.min_max_strokes[0], S + 1),
        "starts": jax.random.randint(ks[1], lead + (K, 2), int(size * prior.min_max_start[0]),
                                     int(size * prior.min_max_start[1]) + 1).astype(jnp.float32),
        "lengths": jax.random.randint(ks[2], lead + (K,), int(size * prior.min_max_len[0]),
                                      int(size * prior.min_max_len[1]) + 1).astype(jnp.float32),
        "angles": jax.random.uniform(ks[3], lead + (K,)) * (2 * math.pi),
    }
    lab_keys = jax.random.split(k_lab, B)
    if prior.only_train_for_last_idx:
        support = jnp.tile(jnp.arange(C), (T - 1) // C)
        pairs = [jax.random.split(k) for k in lab_keys]
        d["support"] = jnp.stack([jax.random.permutation(kp, support) for kp, _ in pairs])
        d["query"] = jnp.stack([jax.random.randint(kq, (), 0, C) for _, kq in pairs])
    else:
        d["labels"] = jnp.stack([jax.random.randint(k, (T,), 0, C) for k in lab_keys])
    off_max, tgt_max = int(size * prior.max_offset), int(size * prior.max_target_offset)

    def render_draws(rkey):
        k_w, k_off, k_jit, k_bright = jax.random.split(rkey, 4)
        return (jax.random.randint(k_w, (), int(size * prior.min_max_width[0]),
                                   int(size * prior.min_max_width[1]) + 1).astype(jnp.float32),
                jax.random.randint(k_off, (2,), -off_max, off_max + 1).astype(jnp.float32),
                jax.random.randint(k_jit, (S, 2), -tgt_max, tgt_max + 1).astype(jnp.float32),
                jax.random.uniform(k_bright, (size, size), minval=200.0 / 255.0, maxval=1.0))

    rkeys = jax.random.split(k_render, B * T).reshape(B, T, -1)
    d["width"], d["offset"], d["jitter"], d["brightness"] = jax.vmap(jax.vmap(render_draws))(rkeys)
    return d


# The default blur (sigma 0.2) moves a pixel by at most ~4e-6, under the
# tolerance, so one case blurs at sigma 1 to hold the blur itself.
STROKE_CASES = [dict(num_features=100), dict(num_features=784, only_train_for_last_idx=True),
                dict(num_features=196, num_outputs=3, normalize_x=True, blur_sigma=1.0)]


@pytest.mark.parametrize("fields", STROKE_CASES, ids=["100", "784_last_idx", "196_3way_normalized_blurred"])
def test_stroke_from_jax_draws(fields):
    B, T = 2, 13 if fields.get("num_outputs") == 3 else 11
    jprior = JaxStrokePrior(**fields)
    key = jax.random.PRNGKey(3)
    want_x, want_y, want_t = jax.jit(lambda k: jprior.sample(k, B, T))(key)
    x, y, t = StrokePrior(**fields).from_draws(jax_stroke_draws(jprior, key, B, T))
    assert x.shape == want_x.shape and x.dtype == torch.float32
    _close(x, want_x, STROKE_TOL)
    np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(t.numpy(), np.asarray(want_t))


@pytest.fixture(scope="module")
def stroke_batch():
    prior = StrokePrior(num_features=100, num_outputs=2)
    return prior, *prior.sample(8, 11, generator=torch.Generator().manual_seed(0))


def test_stroke_shapes_and_ranges(stroke_batch):
    """After tests/test_stroke.py: pixels in [0, ~1] (a ToTensor of a uint8
    render), strokes cover some but not all of the canvas, labels are the
    classes and equal the targets."""
    _, x, y, t = stroke_batch
    assert x.shape == (8, 11, 100) and y.shape == t.shape == (8, 11)
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.01
    assert 0.02 < float((x > 0).float().mean()) < 0.9
    assert set(torch.unique(y).tolist()) <= {0.0, 1.0}
    assert torch.equal(y, t)


def test_stroke_only_train_for_last_idx():
    """A balanced support set and one query; targets -100 except the last."""
    prior = StrokePrior(num_features=100, num_outputs=2, only_train_for_last_idx=True)
    x, y, t = prior.sample(6, 11, generator=torch.Generator().manual_seed(1))
    assert bool((y[:, :-1].sum(dim=1) == 5).all())
    assert bool((t[:, :-1] == -100).all())
    assert torch.equal(t[:, -1], y[:, -1])
    with pytest.raises(ValueError, match="seq_len"):
        prior.sample(2, 12, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="square"):
        StrokePrior(num_features=99).sample(1, 3)


# ---- the grid sampler's clip -------------------------------------------------------


@pytest.mark.parametrize("lengthscale", [1.0, 2.0])
def test_grid_sampler_raises_on_clipped_mass(lengthscale):
    """The circulant embedding's negative eigenvalues hold 7.7e-5 (1.0) and
    3.0e-2 (2.0) of its trace, which the JAX sampler clips silently
    (pfn_tpu/ops/gp_sample.py:242: a distorted covariance, ROADMAP.md queue 3
    item 2); the port raises above MAX_CLIPPED_SHARE, through GPPrior too."""
    G = 2048
    lam = np.fft.fft(1.0 * np.exp(-0.5 * (np.minimum(np.arange(tgp._circulant_size(G)),
                                                   tgp._circulant_size(G) - np.arange(tgp._circulant_size(G)))
                                        / (G - 1) / lengthscale) ** 2)).real
    assert -lam[lam < 0].sum() / lam.sum() > tgp.MAX_CLIPPED_SHARE
    jgp._circulant_sqrt_eigs(G, lengthscale, 1.0)  # the JAX package clips without a word
    with pytest.raises(ValueError, match="negative eigenvalues"):
        tgp._circulant_sqrt_eigs(G, lengthscale, 1.0)
    with pytest.raises(ValueError, match="negative eigenvalues"):
        GPPrior(lengthscale=lengthscale, grid=G).sample(2, 10, generator=torch.Generator().manual_seed(0))


def test_grid_sampler_keeps_parity_at_the_fig3a_lengthscale():
    """At lengthscale 0.6 the clipped share is ~5e-11: no error, and the f32
    spectrum is the JAX package's bit for bit at the Fig-3a grid (G 8192);
    tests/test_torch_port_gp.py holds the samples from the same normals."""
    g_j, lam_j, M_j = jgp._circulant_sqrt_eigs(8192, 0.6, 1.0)
    g_t, lam_t, M_t = tgp._circulant_sqrt_eigs(8192, 0.6, 1.0)
    assert M_t == M_j
    np.testing.assert_array_equal(lam_t.numpy(), np.asarray(lam_j))
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
