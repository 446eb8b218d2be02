"""Reference-API compatibility shim.

Port of ``pfn_tpu/compat.py``: the upstream module surface, ``train(...)``
(reference train.py:22-135), ``Losses`` (train.py:15-20), the
``priors.fast_gp`` / ``fast_gp_mix`` / ``ridge`` / ``mlp`` handles,
``encoders`` (encoders.py), ``positional_encodings``
(positional_encodings.py), ``bar_distribution`` (bar_distribution.py) and
the ``utils`` sampler and schedule helpers (utils.py:46-73), on the port, so
that reference-style driver code runs unchanged:

    from pfn_tpu_torch import compat as ref

    hps = {"noise": 1e-4, "outputscale": 1.0, "lengthscale": 0.6,
           "fast_computations": (False, False, False)}
    ys = ref.priors.fast_gp.get_batch(100_000, 20, 1, hyperparameters=hps)[1]
    total_loss, pos_losses, result = ref.train(
        ref.priors.fast_gp.DataLoader,
        ref.bar_distribution.FullSupportBarDistribution(
            ref.bar_distribution.get_bucket_limits(1000, ys=ys)),
        ref.encoders.Linear,
        emsize=512, nhead=4, nhid=1024, nlayers=6,
        y_encoder_generator=ref.encoders.Linear,
        pos_encoder_generator=ref.positional_encodings.NoPositionalEncoding,
        extra_prior_kwargs_dict={'num_features': 1, 'fuse_x_y': False,
                                 'hyperparameters': hps},
        single_eval_pos_gen=ref.utils.get_weighted_single_eval_pos_sampler(2000),
        bptt=2010, batch_size=4, aggregate_k_gradients=25, epochs=1250,
        lr=1e-4, scheduler=ref.utils.get_cosine_schedule_with_warmup)

In torch the shim is close to the identity: the reference's encoder and
positional-encoding generators are the port's modules (they take the input
width first, as the reference's do), its bar distributions are the port's,
and a torch state_dict warm-starts the model as it is. The third return
value is the port's ``TrainResult`` (``result.model`` is the trained
``PFNTransformer``; the reference returns the module itself).

It runs on the current CUDA device unless ``gpu_device`` (the reference's
argument) or ``device=`` says otherwise, and raises without a card.

Three defects of the JAX shim are not carried over, each a deviation that
``tests/test_torch_port_compat.py`` names:
  * ``get_batch`` draws from a generator that advances between calls (the
    JAX shim draws every batch from ``PRNGKey(0)``, so every call returns the
    same batch);
  * an unknown hyperparameter key raises ``ValueError`` (the JAX shim drops
    the keys its GP prior does not take, silently);
  * ``priors.fast_gp_mix`` builds the port's ``GPMixPrior`` (the JAX shim
    imports ``GPHyperpriorMixture``, which its package does not define, so
    the handle raises ``ImportError`` at first use).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Callable

import torch

from pfn_tpu_torch import distributions as _dist
from pfn_tpu_torch.device import require_cuda
from pfn_tpu_torch.models import encoders as _enc
from pfn_tpu_torch.models import positional as _pos
from pfn_tpu_torch.priors import GPMixPrior, GPPrior, MLPPrior, RidgePrior
from pfn_tpu_torch.train import loop as _loop
from pfn_tpu_torch.train import losses as _losses
from pfn_tpu_torch.utils import schedules as _sched

__all__ = ["train", "Losses", "priors", "encoders", "positional_encodings", "bar_distribution", "utils"]


# ---- losses namespace (reference train.py:15-20) ---------------------------

class _LossMarker:
    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"<compat loss {self.name}>"


class Losses:
    """Stand-ins for the reference's torch loss instances."""

    gaussian = _LossMarker("gaussian")
    mse = _LossMarker("mse")
    ce = _LossMarker("ce")
    bce = _LossMarker("bce")
    get_BarDistribution = _dist.BarDistribution


# ---- bar_distribution namespace --------------------------------------------

bar_distribution = SimpleNamespace(
    get_bucket_limits=_dist.get_bucket_limits,
    BarDistribution=_dist.BarDistribution,
    FullSupportBarDistribution=_dist.FullSupportBarDistribution,
)


# ---- encoders / positional encodings ----------------------------------------
# The reference's generators are called (num_features, emsize), as the port's
# module factories are.

encoders = SimpleNamespace(
    Linear=_enc.LinearEncoder,
    Normalize=_enc.Normalize,
    NormalizedUniform=_enc.NormalizedUniformEncoder,
    MLP=_enc.MLPEncoder,
    Embedding=_enc.EmbeddingEncoder,
    CanonicalEmbedding=_enc.CanonicalEmbedding,
)

positional_encodings = SimpleNamespace(
    NoPositionalEncoding=_pos.NoPositionalEncoding,
    PositionalEncoding=_pos.SinusoidalPositionalEncoding,
    LearnedPositionalEncoding=_pos.LearnedPositionalEncoding,
    PairedScrambledPositionalEncodings=_pos.PairedScrambledPositionalEncodings,
)


# ---- eval-position samplers and schedules (reference utils.py:46-73) --------

@dataclasses.dataclass(frozen=True)
class _EvalPosSampler:
    kind: str
    max_len: int | None = None


def get_weighted_single_eval_pos_sampler(max_len: int) -> _EvalPosSampler:
    return _EvalPosSampler("weighted", max_len)


def get_uniform_single_eval_pos_sampler(max_len: int | None = None) -> _EvalPosSampler:
    return _EvalPosSampler("uniform", max_len)


utils = SimpleNamespace(
    get_weighted_single_eval_pos_sampler=get_weighted_single_eval_pos_sampler,
    get_uniform_single_eval_pos_sampler=get_uniform_single_eval_pos_sampler,
    get_cosine_schedule_with_warmup=_sched.cosine_schedule_with_warmup,
    get_openai_lr=_sched.get_openai_lr,
)


# ---- prior handles -----------------------------------------------------------

# The generator of get_batch on each device: seeded 0 at first use, then
# advancing from call to call.
_GET_BATCH_GENERATORS: dict = {}


def _batch_device(device) -> torch.device:
    device = require_cuda() if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _get_batch_generator(device: torch.device) -> torch.Generator:
    if device not in _GET_BATCH_GENERATORS:
        _GET_BATCH_GENERATORS[device] = torch.Generator(device=device).manual_seed(0)
    return _GET_BATCH_GENERATORS[device]


def _check_keys(name: str, given: dict, known) -> None:
    unknown = sorted(set(given) - set(known))
    if unknown:
        raise ValueError(f"{name}: unknown hyperparameters {unknown}; known: {sorted(known)}")


# The GP handle's hyperparameters: the three the prior takes, and the
# reference's gpytorch switch, which has no counterpart here.
_GP_KEYS = ("noise", "outputscale", "lengthscale")
_GP_IGNORED_KEYS = ("fast_computations",)


def _make_gp(num_features=1, hyperparameters=None, **kw):
    hp = dict(hyperparameters or {})
    _check_keys("fast_gp", hp, _GP_KEYS + _GP_IGNORED_KEYS)
    values = dict(noise=0.1, outputscale=0.1, lengthscale=0.1)  # the reference's defaults
    values.update({k: hp[k] for k in _GP_KEYS if k in hp})
    return GPPrior(num_features=num_features, **values, **kw)


def _dataclass_prior(name: str, cls):
    """The handle's factory of a prior dataclass: its hyperparameters and
    keywords are the class's fields, and any other key raises."""

    def make(num_features=1, hyperparameters=None, **kw):
        hp = dict(hyperparameters or {})
        fields = {f.name for f in dataclasses.fields(cls)} - {"num_features"}
        _check_keys(name, {**hp, **kw}, fields)
        return cls(num_features=num_features, **hp, **kw)

    return make


@dataclasses.dataclass(frozen=True)
class _PriorHandle:
    """Stands in for a reference DataLoader class (priors/utils.py:14-42):
    ``train`` builds its prior from ``extra_prior_kwargs_dict``."""

    name: str
    make: Callable[..., Any]
    num_outputs: int = 1
    fuse_x_y: bool = False

    def get_batch_method(self, batch_size, seq_len, num_features, hyperparameters=None, device=None,
                         generator: torch.Generator | None = None, **kw):
        """(x, y, target_y) of one batch on ``device`` (None: the card),
        drawn from ``generator`` or else from the handle's generator on that
        device, which advances from call to call."""
        prior = self.make(num_features=num_features, hyperparameters=hyperparameters, **kw)
        device = _batch_device(device)
        generator = generator or _get_batch_generator(device)
        return prior.sample(batch_size, seq_len, generator=generator, device=device)


def _fast_gp_get_batch(batch_size, seq_len, num_features, device=None, hyperparameters=None,
                       generator: torch.Generator | None = None, **kw):
    """The reference's ``priors.fast_gp.get_batch``: (x, y, target_y) of one
    batch of the GP prior on ``device`` (None: the card)."""
    return _FAST_GP.get_batch_method(batch_size, seq_len, num_features, hyperparameters=hyperparameters,
                                     device=device, generator=generator, **kw)


_FAST_GP = _PriorHandle("fast_gp", _make_gp)

priors = SimpleNamespace(
    fast_gp=SimpleNamespace(DataLoader=_FAST_GP, get_batch=_fast_gp_get_batch),
    fast_gp_mix=SimpleNamespace(DataLoader=_PriorHandle("fast_gp_mix", _dataclass_prior("fast_gp_mix", GPMixPrior))),
    ridge=SimpleNamespace(DataLoader=_PriorHandle("ridge", _dataclass_prior("ridge", RidgePrior))),
    mlp=SimpleNamespace(DataLoader=_PriorHandle("mlp", _dataclass_prior("mlp", MLPPrior))),
)


# ---- criterion mapping -------------------------------------------------------

def _to_criterion(criterion, num_classes_hint: int | None = None) -> _losses.Criterion:
    if isinstance(criterion, _losses.Criterion):
        return criterion
    if isinstance(criterion, _dist.FullSupportBarDistribution):
        return _losses.full_support_bar_criterion(criterion.borders)
    if isinstance(criterion, _dist.BarDistribution):
        return _losses.bar_criterion(criterion.borders)
    if isinstance(criterion, _LossMarker):
        if criterion.name == "gaussian":
            return _losses.gaussian_nll_criterion()
        if criterion.name == "mse":
            return _losses.mse_criterion()
        if criterion.name == "bce":
            return _losses.bce_criterion()
        if criterion.name == "ce":
            return _losses.ce_criterion(num_classes_hint or 2)
    raise TypeError(
        f"unsupported criterion {criterion!r}: pass a pfn_tpu_torch Criterion, a "
        "(FullSupport)BarDistribution, or a compat.Losses member"
    )


# ---- the train() shim ---------------------------------------------------------

def train(priordataloader_class, criterion, encoder_generator, emsize=200, nhid=200, nlayers=6, nhead=2,
          dropout=0.2, epochs=10, steps_per_epoch=100, batch_size=200, bptt=10, lr=None, warmup_epochs=10,
          input_normalization=False, y_encoder_generator=None, pos_encoder_generator=None, decoder=None,
          extra_prior_kwargs_dict={}, scheduler=None, load_weights_from_this_state_dict=None,
          validation_period=10, single_eval_pos_gen=None, gpu_device=None, aggregate_k_gradients=1,
          verbose=True, num_classes=None, **train_config_overrides):
    """The reference ``train`` signature (train.py:22-27) on the port's loop.

    Differences, all stated here rather than silent:
      * ``gpu_device`` is the training device (None: the current CUDA
        device; an error without a card); ``device=`` says the same.
      * ``scheduler`` takes the compat cosine handle or None (the loop's
        schedule is warmup + cosine); anything else raises.
      * ``single_eval_pos_gen`` is a compat sampler handle, an int (a fixed
        position) or None (uniform); the two reference samplers
        (utils.py:59-73) are built in, and a host callable raises.
      * ``load_weights_from_this_state_dict`` is a torch state_dict of the
        model (the reference's warm start, train.py:46-47), loaded strictly.
      * Further keyword arguments go to the port's ``TrainConfig``
        (checkpoint_dir, dtype, attention_impl, ...).
    Returns ``(final_mean_loss, positional_losses, result)``, ``result``
    the port's ``TrainResult`` (``result.model`` the trained module).
    """
    if not isinstance(priordataloader_class, _PriorHandle):
        raise TypeError("priordataloader_class must be a compat prior handle, e.g. compat.priors.fast_gp.DataLoader")
    pk = dict(extra_prior_kwargs_dict)
    num_features = pk.pop("num_features", 1)
    if pk.pop("fuse_x_y", False):
        raise NotImplementedError(
            "fuse_x_y=True (the deprecated fused-token input path, reference "
            "transformer.py:49-51) is not carried over; use the default "
            "separate x/y encoders"
        )
    prior = priordataloader_class.make(num_features=num_features, **pk)

    crit = _to_criterion(criterion, num_classes_hint=num_classes)

    if scheduler is not None and scheduler is not _sched.cosine_schedule_with_warmup:
        raise NotImplementedError("only the warmup+cosine schedule is supported "
                                  "(compat.utils.get_cosine_schedule_with_warmup)")

    if single_eval_pos_gen is None:
        sampler_kind, eval_pos_max = "uniform", None
    elif isinstance(single_eval_pos_gen, _EvalPosSampler):
        sampler_kind, eval_pos_max = single_eval_pos_gen.kind, single_eval_pos_gen.max_len
    elif isinstance(single_eval_pos_gen, int):
        sampler_kind, eval_pos_max = "fixed", single_eval_pos_gen
    else:
        raise NotImplementedError(
            "single_eval_pos_gen must be a compat sampler handle, an int, or "
            "None: a host callable cannot draw the train step's sep"
        )

    device = train_config_overrides.pop("device", gpu_device)
    cfg = _loop.TrainConfig(
        emsize=emsize, nhid=nhid, nlayers=nlayers, nhead=nhead, dropout=dropout, epochs=epochs,
        steps_per_epoch=steps_per_epoch, batch_size=batch_size, bptt=bptt, lr=lr, warmup_epochs=warmup_epochs,
        input_normalization=input_normalization, aggregate_k_gradients=aggregate_k_gradients,
        eval_pos_sampler=sampler_kind, eval_pos_max=eval_pos_max,
        fixed_eval_pos=eval_pos_max if sampler_kind == "fixed" else None, validation_period=validation_period,
        verbose=verbose, encoder=encoder_generator, y_encoder=y_encoder_generator,
        pos_encoder=pos_encoder_generator, decoder=decoder, device=device, **train_config_overrides,
    )

    init_params = None
    if load_weights_from_this_state_dict is not None:
        sd = load_weights_from_this_state_dict
        if "params" in sd:
            raise TypeError("load_weights_from_this_state_dict is a flax variables tree; pass the model's torch "
                            "state_dict (pfn_tpu_torch.train.state_dict_from_flax_params converts one)")
        init_params = sd

    result = _loop.train(prior, crit, cfg, init_params=init_params)
    return result.final_loss, result.positional_losses, result
