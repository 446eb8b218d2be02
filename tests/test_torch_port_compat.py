"""The port's reference-API shim (``pfn_tpu_torch.compat``) against the JAX
package's ``pfn_tpu.compat``, on the CPU.

  * The namespace the reference notebooks touch, name for name.
  * The module docstring's workflow at a tiny size (get_batch, the bucket
    borders, a full-support bar criterion, the weighted sampler and the
    cosine schedule through ``train``); the Gaussian loss with the uniform
    sampler on the ridge prior; a torch state_dict warm start, also one
    that the JAX package exports from its own params.
  * What is not supported raises, with the JAX shim's exception types and
    messages.
  * The three defects of the JAX shim that the port does not carry over,
    each shown on both: two ``get_batch`` calls differ (JAX's are equal:
    ``PRNGKey(0)`` each time); an unknown hyperparameter key raises
    ``ValueError`` (JAX's drops it); ``priors.fast_gp_mix`` builds its prior
    (JAX's raises ``ImportError``: it imports ``GPHyperpriorMixture``, which
    ``pfn_tpu/priors/gp_mix.py`` does not define).
"""

import jax
import numpy as np
import pytest
import torch

from pfn_tpu import compat as jref
from pfn_tpu.models.transformer import PFNTransformer as JaxPFN
from pfn_tpu.models.transformer import TransformerConfig as JaxConfig
from pfn_tpu.train.checkpoints import export_torch_state_dict
from pfn_tpu_torch import compat as ref
from pfn_tpu_torch.priors import GPMixPrior
from pfn_tpu_torch.train import TrainResult

HPS = {"noise": 1e-4, "outputscale": 1.0, "lengthscale": 0.1, "fast_computations": (False, False, False)}
CPU = dict(gpu_device="cpu", verbose=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_namespace_matches_jax():
    assert callable(ref.train)
    assert ref.Losses.gaussian.name == "gaussian"
    assert callable(ref.Losses.get_BarDistribution)
    for space in ("encoders", "positional_encodings", "bar_distribution", "utils"):
        assert sorted(vars(getattr(ref, space))) == sorted(vars(getattr(jref, space))), space
    for name in ("fast_gp", "fast_gp_mix", "ridge", "mlp"):
        assert hasattr(getattr(ref.priors, name), "DataLoader")
        assert sorted(vars(getattr(ref.priors, name))) == sorted(vars(getattr(jref.priors, name))), name
    assert sorted(n for n in vars(ref.Losses) if not n.startswith("_")) == sorted(
        n for n in vars(jref.Losses) if not n.startswith("_"))


def test_docstring_workflow_runs():
    """The module docstring's snippet (the GP-fitting notebook's), at a tiny
    size."""
    ys = ref.priors.fast_gp.get_batch(512, 12, 1, hyperparameters=HPS, device="cpu")[1]
    criterion = ref.bar_distribution.FullSupportBarDistribution(
        ref.bar_distribution.get_bucket_limits(20, ys=ys.ravel()))
    total_loss, pos_losses, result = ref.train(
        ref.priors.fast_gp.DataLoader, criterion, ref.encoders.Linear,
        emsize=32, nhead=4, nhid=64, nlayers=2,
        y_encoder_generator=ref.encoders.Linear,
        pos_encoder_generator=ref.positional_encodings.NoPositionalEncoding,
        extra_prior_kwargs_dict={"num_features": 1, "fuse_x_y": False, "hyperparameters": HPS},
        single_eval_pos_gen=ref.utils.get_weighted_single_eval_pos_sampler(12),
        bptt=12, batch_size=8, aggregate_k_gradients=1, epochs=2, steps_per_epoch=4, lr=1e-3, warmup_epochs=1,
        scheduler=ref.utils.get_cosine_schedule_with_warmup, **CPU)
    assert np.isfinite(total_loss)
    assert len(pos_losses) == 12 and np.isfinite(np.nanmean(pos_losses))
    assert isinstance(result, TrainResult) and result.model is not None
    assert result.config.eval_pos_sampler == "weighted" and result.config.eval_pos_max == 12
    assert result.config.dropout == 0.2  # the reference signature's default
    assert result.criterion.kind == "full_bar"


def test_gaussian_loss_and_uniform_sampler():
    total_loss, _, result = ref.train(
        ref.priors.ridge.DataLoader, ref.Losses.gaussian, ref.encoders.Linear,
        emsize=32, nhead=4, nhid=64, nlayers=2, y_encoder_generator=ref.encoders.Linear,
        extra_prior_kwargs_dict={"num_features": 2, "hyperparameters": {"noisy_std": 0.1}},
        single_eval_pos_gen=ref.utils.get_uniform_single_eval_pos_sampler(), bptt=10, batch_size=8, epochs=1,
        steps_per_epoch=4, lr=1e-3, warmup_epochs=1, **CPU)
    assert np.isfinite(total_loss) and result.criterion.kind == "gaussian"
    _, _, fixed = ref.train(ref.priors.ridge.DataLoader, ref.Losses.mse, ref.encoders.Linear, emsize=16, nhead=2,
                            nhid=16, nlayers=1, single_eval_pos_gen=5, bptt=10, batch_size=4, epochs=1,
                            steps_per_epoch=1, **CPU)
    assert fixed.config.eval_pos_sampler == "fixed" and fixed.config.fixed_eval_pos == 5


def _warm_start(sd, nlayers, emsize, nhead, nhid, n_out):
    """One epoch at LR 0 (warmup epoch 0) from ``sd``: the trained model."""
    ys = np.linspace(-2, 2, 512)
    criterion = ref.bar_distribution.BarDistribution(ref.bar_distribution.get_bucket_limits(n_out, ys=ys))
    total_loss, _, result = ref.train(
        ref.priors.fast_gp.DataLoader, criterion, ref.encoders.Linear, emsize=emsize, nhead=nhead, nhid=nhid,
        nlayers=nlayers, y_encoder_generator=ref.encoders.Linear,
        extra_prior_kwargs_dict={"num_features": 1, "hyperparameters": HPS}, load_weights_from_this_state_dict=sd,
        bptt=10, batch_size=8, epochs=1, steps_per_epoch=2, lr=1e-4, warmup_epochs=1, dropout=0.0, **CPU)
    assert np.isfinite(total_loss)
    return result.model


def test_warm_start_from_a_torch_state_dict():
    """The reference's warm start (train.py:46-47): a torch state_dict of the
    model, the port's own or one the JAX package exports."""
    nlayers, emsize, nhead, nhid, n_out = 2, 32, 4, 64, 20
    jmodel = JaxPFN(JaxConfig(emsize=emsize, nhead=nhead, nhid=nhid, nlayers=nlayers, num_features=1, n_out=n_out))
    exported = export_torch_state_dict(jmodel.init_params(jax.random.PRNGKey(0), seq_len=10), nlayers)
    sd = {k: torch.as_tensor(np.array(v)) for k, v in exported.items()}
    model = _warm_start(sd, nlayers, emsize, nhead, nhid, n_out)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())  # LR 0: the weights stay
    again = _warm_start(model.state_dict(), nlayers, emsize, nhead, nhid, n_out)
    assert all(torch.equal(again.state_dict()[k], v) for k, v in sd.items())


def _raised(fn):
    try:
        fn()
    except Exception as e:  # the exception itself is what is compared
        return e
    raise AssertionError("no exception")


def test_unsupported_surface_raises_as_jax():
    cases = [
        dict(priordataloader_class=object(), criterion=ref.Losses.mse, encoder_generator=ref.encoders.Linear),
        dict(priordataloader_class="handle", criterion=ref.Losses.mse, encoder_generator=None,
             extra_prior_kwargs_dict={"num_features": 1, "fuse_x_y": True, "hyperparameters": HPS}),
        dict(priordataloader_class="handle", criterion="not a criterion", encoder_generator=None,
             extra_prior_kwargs_dict={"num_features": 1, "hyperparameters": HPS}),
        dict(priordataloader_class="handle", criterion=ref.Losses.mse, encoder_generator=None,
             extra_prior_kwargs_dict={"num_features": 1, "hyperparameters": HPS}, scheduler=lambda *a: None),
    ]
    for case in cases:
        port_case = {**case, "priordataloader_class": ref.priors.fast_gp.DataLoader
                     if case["priordataloader_class"] == "handle" else case["priordataloader_class"]}
        jax_case = {**case, "priordataloader_class": jref.priors.fast_gp.DataLoader
                    if case["priordataloader_class"] == "handle" else case["priordataloader_class"],
                    "criterion": jref.Losses.mse if case["criterion"] is ref.Losses.mse else case["criterion"]}
        got = _raised(lambda: ref.train(**port_case, **CPU))
        want = _raised(lambda: jref.train(**jax_case, verbose=False))
        assert type(got) is type(want) and type(got) in (TypeError, NotImplementedError)
        assert str(got).replace("pfn_tpu_torch", "pfn_tpu") == str(want)
    with pytest.raises(NotImplementedError, match="single_eval_pos_gen"):
        ref.train(ref.priors.fast_gp.DataLoader, ref.Losses.mse, ref.encoders.Linear,
                  single_eval_pos_gen=lambda: 3, **CPU)
    with pytest.raises(TypeError, match="flax variables tree"):
        ref.train(ref.priors.fast_gp.DataLoader, ref.Losses.mse, ref.encoders.Linear,
                  load_weights_from_this_state_dict={"params": {}}, **CPU)


def test_get_batch_advances_between_calls():
    """Deviation 1: the JAX shim's get_batch returns the same batch on every
    call; the port's draws from a generator that advances."""
    first = ref.priors.fast_gp.get_batch(4, 6, 1, hyperparameters=HPS, device="cpu")
    second = ref.priors.fast_gp.get_batch(4, 6, 1, hyperparameters=HPS, device="cpu")
    assert not torch.equal(first[1], second[1]) and not torch.equal(first[0], second[0])
    j1, j2 = (jref.priors.fast_gp.get_batch(4, 6, 1, hyperparameters=HPS) for _ in range(2))
    assert np.array_equal(np.asarray(j1[1]), np.asarray(j2[1]))  # the defect, on the JAX side
    g = torch.Generator().manual_seed(3)
    seeded = ref.priors.fast_gp.DataLoader.get_batch_method(4, 6, 1, hyperparameters=HPS, device="cpu", generator=g)
    again = ref.priors.fast_gp.get_batch(4, 6, 1, hyperparameters=HPS, device="cpu",
                                         generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(seeded, again))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ref.priors.fast_gp.get_batch(4, 6, 1, hyperparameters=HPS)


def test_unknown_hyperparameter_key_raises():
    """Deviation 2: the JAX shim drops hyperparameter keys its GP prior does
    not take; the port's raises ValueError naming them."""
    bad = {**HPS, "lengthscal": 0.5}
    with pytest.raises(ValueError, match="lengthscal"):
        ref.priors.fast_gp.get_batch(2, 4, 1, hyperparameters=bad, device="cpu")
    with pytest.raises(ValueError, match="lengthscal"):
        ref.train(ref.priors.fast_gp.DataLoader, ref.Losses.mse, ref.encoders.Linear,
                  extra_prior_kwargs_dict={"num_features": 1, "hyperparameters": bad}, **CPU)
    with pytest.raises(ValueError, match="weight_sd"):
        ref.priors.ridge.DataLoader.make(num_features=2, hyperparameters={"weight_sd": 1.0})
    assert jref.priors.fast_gp.get_batch(2, 4, 1, hyperparameters=bad)[1].shape == (2, 4)  # silently dropped


def test_fast_gp_mix_builds():
    """Deviation 3: the JAX shim's fast_gp_mix handle raises ImportError at
    first use; the port's builds its GPMixPrior and trains on it."""
    with pytest.raises(ImportError, match="GPHyperpriorMixture"):
        jref.priors.fast_gp_mix.DataLoader.make(num_features=1)
    prior = ref.priors.fast_gp_mix.DataLoader.make(num_features=2, hyperparameters={"noise_rate": 0.1})
    assert isinstance(prior, GPMixPrior) and prior.num_features == 2 and prior.noise_rate == 0.1
    total_loss, _, _ = ref.train(ref.priors.fast_gp_mix.DataLoader, ref.Losses.mse, ref.encoders.Linear,
                                 emsize=16, nhead=2, nhid=16, nlayers=1, extra_prior_kwargs_dict={"num_features": 1},
                                 bptt=10, batch_size=10, epochs=1, steps_per_epoch=2, **CPU)
    assert np.isfinite(total_loss)
