"""The JAX side of the MLP-prior parity tests
(tests/test_torch_port_mlp_prior.py, tests/test_torch_port_mlp_causal.py):
the JAX MLPPrior's draws replayed from its key tree, and the port's prior
with the same fields.

``pfn_tpu/priors/mlp.py:_sample_one_group`` and ``_discretize_categoricals``
draw inside ``jax.random``; :func:`jax_draws` makes the same ``split`` and
``fold_in`` calls and returns those draws stacked on a leading groups axis,
the layout of the port's ``MLPPrior.from_draws``. Tolerance of the
comparisons: 1e-5 (atol and rtol) for x and real-valued y (f32 matmuls
summed in another order through up to 4 layers, then z-scored); binarized
labels exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pfn_tpu.priors import hyper as jhyper
from pfn_tpu.priors.mlp import MLPPrior as JaxMLPPrior
from pfn_tpu_torch.priors import hyper
from pfn_tpu_torch.priors.mlp import MLPPrior

TOL = 1e-5
SMALL = dict(num_features=5, max_hidden=16, max_layers=4, batch_size_per_sample=4)
B, T = 8, 40


def t(a):
    return torch.from_numpy(np.array(a))


def jax_group_draws(prior, gk, seq_len, group_size):
    """The draws of pfn_tpu's MLPPrior._sample_one_group(gk, ...), replayed."""
    L, H, F = prior.max_layers, prior.max_hidden, prior.num_features
    C = F
    ks = jax.random.split(gk, 12)
    d = {name: getattr(prior, name).sample(ks[i]) for i, name in enumerate(
        ("num_layers", "hidden_dim", "init_std", "noise_std", "dropout_prob", "num_features_used"))
        if getattr(prior, name) is not None}

    def normal(k, shape):
        return jax.random.normal(k, shape, dtype=jnp.float32)

    def keep(k, shape):
        return jax.random.uniform(jax.random.fold_in(k, 1), shape, dtype=jnp.float32)

    for name, k, shape in (("w_in", ks[6], (C, H)), ("b_in", jax.random.fold_in(ks[6], 2), (H,)),
                           ("w_hidden", ks[7], (L - 2, H, H)), ("b_hidden", jax.random.fold_in(ks[7], 2), (L - 2, H)),
                           ("w_out", ks[8], (H, 1)), ("b_out", jax.random.fold_in(ks[8], 2), (1,))):
        d[name] = normal(k, shape)
        d[name + "_keep"] = keep(k, shape)
    if prior.pre_sample_weights:
        d["noise_scale"] = normal(ks[9], (L - 1, H))
    per_ds = {k: [] for k in ("causes", "noise_hidden", "noise_out", "x_scores", "y_scores")}
    for dkey in jax.random.split(ks[10], group_size):
        dk = jax.random.split(dkey, 4)
        per_ds["causes"].append(normal(dk[0], (seq_len, C)) if prior.sampling == "normal"
                                else jax.random.uniform(dk[0], (seq_len, C), dtype=jnp.float32))
        nk = jax.random.split(dk[1], L - 1)
        per_ds["noise_hidden"].append(jnp.stack([normal(k, (seq_len, H)) for k in nk[:-1]]))
        per_ds["noise_out"].append(normal(nk[-1], (seq_len,)))
        per_ds["x_scores"].append(jax.random.uniform(dk[2], ((L - 2) * H,)))
        per_ds["y_scores"].append(jax.random.uniform(dk[3], ((L - 2) * H,)))
    d.update({k: jnp.stack(v) for k, v in per_ds.items()})
    d.update(jax_categorical_draws(prior, gk))
    return d


def jax_categorical_draws(prior, gk):
    """The draws of pfn_tpu's MLPPrior._discretize_categoricals for the group
    key ``gk``, replayed."""
    kc = jax.random.split(jax.random.split(gk, 12)[11], 6)
    F, maxc = prior.num_features, prior.max_categorical_classes_ordinal
    return dict(num_cat=jax.random.beta(kc[0], 0.5, 0.8), cat_scores=jax.random.uniform(kc[1], (F,)),
                ordinal=jax.random.uniform(kc[2], (F,)), classes_ordinal=jax.random.beta(kc[3], 0.1, 2.0, (F,)),
                classes_nominal=jax.random.beta(kc[5], 0.1, 2.0, (F,)),
                thresholds=jax.random.uniform(kc[4], (F, maxc)))


def jax_draws(prior, key, batch_size, seq_len):
    """Every group's draws stacked on a leading groups axis, as torch tensors:
    :func:`jax_group_draws` vmapped over the group keys, jitted (compiling
    it once is quicker than running its ops one by one)."""
    g = prior.batch_size_per_sample
    draws = jax.jit(jax.vmap(functools.partial(jax_group_draws, prior, seq_len=seq_len, group_size=g)))(
        jax.random.split(key, batch_size // g))
    return {k: t(v) for k, v in draws.items()}


def port_prior(jax_prior):
    """The port's MLPPrior with the same fields (specs mapped by name)."""
    kw = {}
    for f in jax_prior.__dataclass_fields__:
        v = getattr(jax_prior, f)
        if isinstance(v, jhyper.HyperSpec):
            v = getattr(hyper, type(v).__name__)(**vars(v))
        kw[f] = v
    return MLPPrior(**kw)




def check_against_jax(case_fields: dict, seed: int = 11):
    """The port's MLPPrior.from_draws on the replayed draws against the JAX
    sampler, and the port's own sampler seeded twice."""
    jp = JaxMLPPrior(**SMALL, **case_fields)
    key = jax.random.PRNGKey(seed)
    want_x, want_y, want_t = jax.jit(jp.sample, static_argnums=(1, 2))(key, B, T)
    prior = port_prior(jp)
    x, y = prior.from_draws(jax_draws(jp, key, B, T))
    assert x.shape == (B, T, SMALL["num_features"]) and y.shape == (B, T) and x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), np.asarray(want_x), atol=TOL, rtol=TOL)
    if jp.is_binary_classification:
        np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))
        assert set(np.unique(y.numpy())) <= {0.0, 1.0}
    else:
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(np.asarray(want_t), np.asarray(want_y))
    a = prior.sample(B, T, generator=torch.Generator().manual_seed(5))
    b = prior.sample(B, T, generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert bool(torch.isfinite(a[0]).all()) and bool(torch.isfinite(a[1]).all())
