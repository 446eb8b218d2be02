"""Named registries for priors, criterions, encoders, positional encodings
and eval-position samplers.

Port of ``pfn_tpu/registries.py``, with the same five registries and the
same built-in names. The reference wires these through if/elif chains in its
train.py (priors :193-202, losses :221-237, encoders :244-250, positional
encodings :253-269, eval-position samplers :271-280); here each is a table
that the CLI, configs and user code share, and ``register`` adds an entry.

The entries are the port's: torch priors, criterion builders on the port's
``sample_y_for_buckets`` and ``get_bucket_limits``, and module factories with
the port's protocols (``encoder(in_features, emsize)``,
``pos_encoder(emsize, max_len=)``; see ``models/``). An eval-position
sampler is ``max_len -> unnormalised weights`` (a tensor or array of
max_len entries); the train loop resolves ``TrainConfig.eval_pos_sampler``
here, so a registered sampler changes training.
"""

from __future__ import annotations

from typing import Any, Dict


class Registry:
    """A named table of constructors with decorator-style registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: str, obj: Any = None):
        if obj is None:  # decorator form

            def deco(f):
                self._entries[name] = f
                return f

            return deco
        self._entries[name] = obj
        return obj

    def get(self, name: str) -> Any:
        if name not in self._entries:
            raise KeyError(f"unknown {self.kind} {name!r}; available: {sorted(self._entries)}")
        return self._entries[name]

    def names(self):
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries


PRIORS = Registry("prior")
CRITERIONS = Registry("criterion")
ENCODERS = Registry("encoder")
POS_ENCODERS = Registry("positional encoding")
EVAL_POS_SAMPLERS = Registry("eval-pos sampler")


def _register_builtins():
    from pfn_tpu_torch.priors.binarize import binarized_gp_mix_prior, binarized_gp_prior
    from pfn_tpu_torch.priors.gp import GPPrior
    from pfn_tpu_torch.priors.gp_mix import GPMixPrior
    from pfn_tpu_torch.priors.mlp import MLPPrior
    from pfn_tpu_torch.priors.ridge import RidgePrior
    from pfn_tpu_torch.priors.stroke import StrokePrior

    PRIORS.register("gp", GPPrior)
    PRIORS.register("stroke", StrokePrior)
    PRIORS.register("ridge", RidgePrior)
    PRIORS.register("mix_gp", GPMixPrior)
    PRIORS.register("mlp", MLPPrior)
    PRIORS.register("bnn", MLPPrior)
    PRIORS.register("binarized_gp", binarized_gp_prior)
    PRIORS.register("binarized_mix_gp", binarized_gp_mix_prior)

    # Criterion builders ``(prior, **kwargs) -> Criterion``, so that the
    # adaptive bucket estimation (the reference's throwaway data loader,
    # train.py:214-219) lives behind the registry too.
    from pfn_tpu_torch.distributions.bar import get_bucket_limits
    from pfn_tpu_torch.priors.base import sample_y_for_buckets
    from pfn_tpu_torch.train.losses import (
        bar_criterion,
        bce_criterion,
        ce_criterion,
        full_support_bar_criterion,
        gaussian_nll_criterion,
        mse_criterion,
    )

    def _adaptive_borders(prior, num_buckets, y_sample_size, seq_len, full_range):
        ys = sample_y_for_buckets(prior, y_sample_size, seq_len)
        return get_bucket_limits(num_buckets, full_range=full_range, ys=ys)

    def _make_ce(prior, **kw):
        # The head width defaults to the prior's class count: a fixed 2
        # would clip labels >= 2 of an n-way prior.
        num_classes = kw.get("num_classes", getattr(prior, "num_outputs", 2))
        if num_classes < 2:
            raise ValueError(
                f"'ce' needs num_classes >= 2, resolved {num_classes} (the prior reports "
                f"num_outputs={getattr(prior, 'num_outputs', '?')} — a regression prior? pass --set "
                "criterion.kwargs.num_classes=K or use a classification prior/criterion)")
        return ce_criterion(num_classes)

    def _adaptive(make):
        return lambda prior, **kw: make(_adaptive_borders(
            prior, kw.get("num_buckets", 100), kw.get("y_sample_size", 100_000), kw.get("seq_len", 100),
            kw.get("full_range")))

    CRITERIONS.register("ce", _make_ce)
    CRITERIONS.register("gaussnll", lambda prior, **kw: gaussian_nll_criterion())
    CRITERIONS.register("mse", lambda prior, **kw: mse_criterion())
    CRITERIONS.register("bce", lambda prior, **kw: bce_criterion())
    CRITERIONS.register("barnll", lambda prior, **kw: bar_criterion(
        get_bucket_limits(kw.get("num_buckets", 100), full_range=kw.get("full_range", (-4.0, 4.0)))))
    CRITERIONS.register("adaptivebarnll", _adaptive(bar_criterion))
    CRITERIONS.register("adaptivefullsupportbarnll", _adaptive(full_support_bar_criterion))

    from pfn_tpu_torch.models.encoders import (
        CanonicalEmbedding,
        EmbeddingEncoder,
        LinearEncoder,
        MLPEncoder,
        NormalizedUniformEncoder,
    )

    ENCODERS.register("linear", LinearEncoder)
    ENCODERS.register("normalized_uniform", NormalizedUniformEncoder)
    ENCODERS.register("mlp", MLPEncoder)
    ENCODERS.register("canonical", CanonicalEmbedding)
    ENCODERS.register("embedding", EmbeddingEncoder)

    from pfn_tpu_torch.models.positional import (
        LearnedPositionalEncoding,
        NoPositionalEncoding,
        PairedScrambledPositionalEncodings,
        SinusoidalPositionalEncoding,
    )

    POS_ENCODERS.register("none", NoPositionalEncoding)
    POS_ENCODERS.register("sinus", SinusoidalPositionalEncoding)
    POS_ENCODERS.register("learned", LearnedPositionalEncoding)
    POS_ENCODERS.register("paired_scrambled_learned", PairedScrambledPositionalEncodings)

    from pfn_tpu_torch.utils.samplers import make_eval_pos_weights

    for kind in ("uniform", "weighted", "mixture"):
        EVAL_POS_SAMPLERS.register(kind, lambda max_len, kind=kind: make_eval_pos_weights(max_len, kind))


_register_builtins()
