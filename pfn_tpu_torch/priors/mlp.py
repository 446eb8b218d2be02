"""BNN / random-MLP prior (the TabPFN-ancestor tabular prior).

Port of ``pfn_tpu/priors/mlp.py`` (reference priors/mlp.py:62-203): per group
of ``batch_size_per_sample`` datasets, a random MLP whose depth, width, init
std, per-unit noise and weight dropout are themselves sampled; Gaussian or
uniform causes pushed through it; x and y read off the network (non-causal:
x = causes, y = the output; causal: x = a random subset of the hidden
activations, y = the output or a random activation). Then a sampled subset of
features becomes categorical, x and y are z-scored per dataset, y is
optionally binarized at its median, and the features beyond the group's
``num_features_used`` are zeroed and the rest rescaled.

The sampler is split in two, as the port's GP samplers are:
:meth:`MLPPrior.draw` takes every random number a batch needs from the
caller's ``torch.Generator``, and :meth:`MLPPrior.from_draws` is the
deterministic map from those draws to (x, y), which the tests feed with the
JAX package's own draws. Where the JAX package ``vmap``s a group sampler over
groups and a dataset sampler within each group, the port batches both axes:
tensors are laid out (groups, datasets, T, ...), each group's weights multiply
all its datasets in one batched matmul, and a Python loop walks the
``max_layers - 2`` hidden layers with the per-group depth mask. Depth and
width are static maxima with the sampled ones applied as masks, so the
function equals the smaller sampled network.

Categorical discretization counts, for every cell, the active thresholds
strictly below its z-scored value. The JAX package's broadcast
compare-and-reduce over (groups, T, F, 200) is fused by XLA; in eager torch it
would materialise hundreds of millions of booleans. Here each feature's
thresholds are sorted with the inactive ones set to +inf, and
``torch.searchsorted(side="left")`` gives the same count.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F_

from pfn_tpu_torch.priors.base import default_group_size
from pfn_tpu_torch.priors.hyper import Constant, HyperSpec, LogUniform, UniformInt, sample_beta
from pfn_tpu_torch.priors.transforms import binarize_by_median, normalize_by_used_features, normalize_data

_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "elu": F_.elu,
    "identity": lambda h: h,
}

_HYPERS = ("num_layers", "hidden_dim", "init_std", "noise_std", "dropout_prob", "num_features_used")


def _group_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (NG, G, T, K) @ w (NG, K, N) -> (NG, G, T, N): each group's weights
    applied to all its datasets in one batched product."""
    NG, G, T, K = a.shape
    return torch.bmm(a.reshape(NG, G * T, K), w).reshape(NG, G, T, w.shape[-1])


def _scaled_beta(u: torch.Tensor, scale, minimum: int) -> torch.Tensor:
    """minimum + clip(floor(u * (scale - minimum + 1)), 0, scale - minimum)
    as int32, the reference's scaled_beta (priors/utils.py:70) given the Beta
    draw ``u``; ``scale`` is an int or an int tensor broadcasting against u."""
    top = scale - minimum
    n = torch.floor(u * (top + 1)).clamp_min(0)
    n = torch.minimum(n, top.to(n.dtype)) if isinstance(top, torch.Tensor) else n.clamp_max(top)
    return minimum + n.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class MLPPrior:
    num_features: int = 1
    num_outputs: int = 1
    # Static architecture bounds (sampled effective depth and width are masks).
    max_layers: int = 6
    max_hidden: int = 128
    # Hyper-hyperparameter specs (defaults of reference priors/mlp.py:23-28).
    num_layers: HyperSpec = UniformInt(3, 6)
    hidden_dim: HyperSpec = UniformInt(16, 128)
    init_std: HyperSpec = LogUniform(0.01, 1.0)
    noise_std: HyperSpec = LogUniform(0.001, 0.3)
    dropout_prob: HyperSpec = Constant(0.0)
    num_features_used: HyperSpec | None = None  # default: all features
    activation: str = "relu"
    sampling: str = "normal"  # 'normal' | 'uniform' causes (mlp.py:132-141)
    is_causal: bool = False
    y_is_effect: bool = True
    pre_sample_causes: bool = False
    pre_sample_weights: bool = False
    is_binary_classification: bool = False
    normalize_by_used_features_flag: bool = True
    batch_size_per_sample: int | None = None
    # Categorical features (reference mlp.py:47-59, 160-170): per group a
    # scaled-Beta(0.5, 0.8) share of the used features, each ordinal w.p. 1/2
    # (the rank-bin count is the value) else nominal (count % classes).
    categorical_x: bool = False
    max_categorical_classes: int = 10  # nominal cap (mlp.py:51)
    max_categorical_classes_ordinal: int = 200  # ordinal cap (mlp.py:52)

    def group_size(self, batch_size: int) -> int:
        g = self.batch_size_per_sample or default_group_size(batch_size, 8)
        if batch_size % g:
            raise ValueError(f"batch_size {batch_size} is not divisible by the group size {g}")
        return g

    def check_causal_capacity(self) -> None:
        """Causal mode draws x columns from valid (active layer, active unit)
        hidden activations; a network sampled at the spec minima must still
        have >= num_features of them, else +inf-scored columns would be
        selected silently."""
        if not self.is_causal:
            return
        min_depth = getattr(self.num_layers, "low", None)
        min_width = getattr(self.hidden_dim, "low", None)
        if isinstance(self.num_layers, Constant):
            min_depth = int(self.num_layers.value)
        if isinstance(self.hidden_dim, Constant):
            min_width = int(self.hidden_dim.value)
        if min_depth is None or min_width is None:
            return  # a custom spec without bounds: the caller's responsibility
        worst = max(0, int(min_depth) - 2) * int(min_width)
        if worst < self.num_features:
            raise ValueError(
                f"causal mode: the smallest sampled network has only {worst} hidden activations "
                f"(< num_features={self.num_features}); raise the num_layers/hidden_dim lower bounds "
                "or lower num_features")

    def draw(self, num_groups: int, group_size: int, seq_len: int, generator: torch.Generator | None = None,
             device=None) -> dict:
        """Every random number of ``num_groups`` groups of ``group_size``
        datasets of length ``seq_len``, as a dict of tensors with a leading
        groups axis (see :meth:`from_draws` for what each is)."""
        NG, G, T = num_groups, group_size, seq_len
        L, H, F = self.max_layers, self.max_hidden, self.num_features
        C = F  # the JAX package's _num_causes(): num_features in both modes

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=device)

        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=device)

        d = {name: getattr(self, name).sample(generator, (NG,), device) for name in _HYPERS
             if getattr(self, name) is not None}
        d.update(w_in=normal(NG, C, H), b_in=normal(NG, H),
                 w_hidden=normal(NG, L - 2, H, H), w_hidden_keep=uniform(NG, L - 2, H, H),
                 b_hidden=normal(NG, L - 2, H), b_hidden_keep=uniform(NG, L - 2, H),
                 w_out=normal(NG, H, 1), w_out_keep=uniform(NG, H, 1),
                 b_out=normal(NG, 1), b_out_keep=uniform(NG, 1))
        if self.pre_sample_weights:
            d["noise_scale"] = normal(NG, L - 1, H)
        if self.sampling == "normal":
            d["causes"] = normal(NG, G, T, C)
        elif self.sampling == "uniform":
            d["causes"] = uniform(NG, G, T, C)
        else:
            raise ValueError(f"invalid sampling {self.sampling!r}")
        d.update(noise_hidden=normal(NG, G, L - 2, T, H), noise_out=normal(NG, G, T))
        if self.is_causal:
            d["x_scores"] = uniform(NG, G, (L - 2) * H)
            if not self.y_is_effect:
                d["y_scores"] = uniform(NG, G, (L - 2) * H)
        if self.categorical_x:
            d.update(num_cat=sample_beta(0.5, 0.8, (NG,), generator, device), cat_scores=uniform(NG, F),
                     ordinal=uniform(NG, F),
                     classes_ordinal=sample_beta(0.1, 2.0, (NG, F), generator, device),
                     classes_nominal=sample_beta(0.1, 2.0, (NG, F), generator, device),
                     thresholds=uniform(NG, F, self.max_categorical_classes_ordinal))
        return d

    def _discretize_categoricals(self, d: dict, x: torch.Tensor, n_used: torch.Tensor) -> torch.Tensor:
        """Discretize a sampled subset of each group's features (reference
        mlp.py:160-170). x: (NG, G, T, F); n_used: (NG,) int32.

        ``num_cat ~ scaled_beta(0.5, 0.8, n_used, 0)`` of the used columns
        (the lowest-ranked by ``cat_scores``) become categorical; each is
        ordinal where ``ordinal < 1/2``, with a class count from
        scaled_beta(0.1, 2.0, 200, 1) (ordinal) or (..., 10, 1) (nominal)
        and thresholds ``U(0, 1) - 0.5`` against the per-dataset z-scored
        column. The value is the count of active thresholds strictly below z
        (ordinal) or that count modulo the class count (nominal, the
        reference's hash ``count * (127 n + 1) % n``)."""
        NG, G, T, F = x.shape
        maxc = self.max_categorical_classes_ordinal
        features = torch.arange(F, device=x.device)
        num_cat = _scaled_beta(d["num_cat"], n_used, 0)  # (NG,)
        scores = torch.where(features < n_used[:, None], d["cat_scores"], torch.inf)
        rank = torch.argsort(torch.argsort(scores, dim=1, stable=True), dim=1, stable=True)
        is_cat = rank < num_cat[:, None]  # (NG, F)
        is_ordinal = d["ordinal"] < 0.5
        n_cls = torch.where(is_ordinal, _scaled_beta(d["classes_ordinal"], maxc, 1),
                            _scaled_beta(d["classes_nominal"], self.max_categorical_classes, 1))  # (NG, F)
        active = torch.arange(maxc, device=x.device) < n_cls[..., None]
        thr = torch.where(active, d["thresholds"] - 0.5, torch.inf).sort(dim=-1).values  # (NG, F, maxc)
        z = normalize_data(x, dim=2).permute(0, 3, 1, 2).reshape(NG, F, G * T).contiguous()
        count = torch.searchsorted(thr, z, side="left").to(torch.int32)
        count = count.reshape(NG, F, G, T).permute(0, 2, 3, 1)  # (NG, G, T, F)
        val = torch.where(is_ordinal[:, None, None, :], count, count % n_cls[:, None, None, :]).to(x.dtype)
        return torch.where(is_cat[:, None, None, :], val, x)

    def from_draws(self, d: dict):
        """The deterministic half: draws -> (x (NG * G, T, F), y (NG * G, T)).

        Per group (leading axis NG): ``num_layers``, ``hidden_dim``,
        ``init_std``, ``noise_std``, ``dropout_prob`` and optionally
        ``num_features_used``, the specs' raw samples (cast to int32 and
        clipped here as the JAX package does); standard normals ``w_in`` (C,
        H), ``b_in`` (H,), ``w_hidden`` (L-2, H, H), ``b_hidden`` (L-2, H),
        ``w_out`` (H, 1), ``b_out`` (1,) and the uniforms ``*_keep`` of the
        dropout masks of the last four (keep where u < 1 - p);
        ``noise_scale`` (L-1, H) normals with ``pre_sample_weights``; the
        categorical draws. Per dataset (axes NG, G): ``causes`` (T, C),
        ``noise_hidden`` (L-2, T, H), ``noise_out`` (T,), and in causal mode
        ``x_scores`` and maybe ``y_scores`` ((L-2) H uniforms).
        """
        act = _ACTIVATIONS[self.activation]
        L, H, F = self.max_layers, self.max_hidden, self.num_features
        causes = d["causes"]
        NG, G, T, _ = causes.shape
        device = causes.device
        depth = d["num_layers"].to(torch.int32).clamp(3, L)
        width = d["hidden_dim"].to(torch.int32).clamp(1, H)
        init_std, noise_std, p = (d[k].to(torch.float32) for k in ("init_std", "noise_std", "dropout_prob"))
        if self.num_features_used is None:
            n_used = torch.full((NG,), F, dtype=torch.int32, device=device)
        else:
            n_used = d["num_features_used"].to(torch.int32).clamp(1, F)
        unit = (torch.arange(H, device=device) < width[:, None]).to(torch.float32)  # (NG, H)

        # N(0, init_std / (1 - p)) weights with Bernoulli(1 - p) dropout on the
        # hidden and output layers (mlp.py:126-130); the input layer has p = 0.
        scale = init_std / (1.0 - p)

        def dropped(name, extra_dims):
            shape = (NG,) + (1,) * extra_dims
            w = d[name] * scale.reshape(shape)
            return w * (d[name + "_keep"] < (1.0 - p).reshape(shape)).to(torch.float32)

        w_in = d["w_in"] * init_std[:, None, None] * unit[:, None, :]
        b_in = d["b_in"] * init_std[:, None] * unit
        w_hidden = dropped("w_hidden", 3) * unit[:, None, :, None] * unit[:, None, None, :]
        b_hidden = dropped("b_hidden", 2) * unit[:, None, :]
        w_out = dropped("w_out", 2) * unit[:, :, None]
        b_out = dropped("b_out", 1)
        if self.pre_sample_weights:
            noise_scales = (d["noise_scale"] * noise_std[:, None, None]).abs()
        else:
            noise_scales = noise_std[:, None, None].expand(NG, L - 1, H)

        h = _group_matmul(causes, w_in) + b_in[:, None, None, :]  # (NG, G, T, H)
        hidden = []
        for layer in range(L - 2):
            # Hidden layers 1 .. depth-2 are applied; the output layer follows.
            new_h = _group_matmul(act(h), w_hidden[:, layer]) + b_hidden[:, None, None, layer]
            new_h = new_h + noise_scales[:, None, None, layer] * d["noise_hidden"][:, :, layer]
            h = torch.where((layer < depth - 2)[:, None, None, None], new_h, h)
            hidden.append(new_h)
        y = (_group_matmul(act(h), w_out) + b_out[:, None, None, :])[..., 0]
        y = y + noise_scales[:, None, None, -1, 0] * d["noise_out"]

        if self.is_causal:
            # All hidden activations (mlp.py:146 outputs[2:]); x columns are the
            # F lowest-scored valid (active layer, active unit) positions.
            acts = torch.stack(hidden, dim=3).reshape(NG, G, T, (L - 2) * H)
            layer_ids = torch.arange(L - 2, device=device).repeat_interleave(H)
            unit_ids = torch.arange(H, device=device).repeat(L - 2)
            valid = ((layer_ids < (depth - 2)[:, None]) & (unit_ids < width[:, None]))[:, None, :]  # (NG, 1, .)
            scores = torch.where(valid, d["x_scores"], torch.inf)
            feat_idx = torch.argsort(scores, dim=-1, stable=True)[..., :F]  # (NG, G, F)
            x = torch.gather(acts, 3, feat_idx[:, :, None, :].expand(NG, G, T, F))
            if not self.y_is_effect:
                y_idx = torch.argmin(torch.where(valid, d["y_scores"], torch.inf), dim=-1)
                y = torch.gather(acts, 3, y_idx[:, :, None, None].expand(NG, G, T, 1))[..., 0]
        else:
            x = causes

        # Post-processing (mlp.py:160-189), per dataset over the T axis.
        if self.categorical_x:
            x = self._discretize_categoricals(d, x, n_used)
        x = normalize_data(x, dim=2)
        y = normalize_data(y[..., None], dim=2)[..., 0]
        if self.is_binary_classification:
            y = binarize_by_median(y, dim=2)
        x = x * (torch.arange(F, device=device) < n_used[:, None]).to(torch.float32)[:, None, None, :]
        if self.normalize_by_used_features_flag:
            x = normalize_by_used_features(x, n_used.to(torch.float32)[:, None, None, None], F)
        return x.reshape(NG * G, T, F), y.reshape(NG * G, T)

    def sample(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None, device=None):
        """(x (B, T, F), y (B, T), target_y = y) on ``device``."""
        self.check_causal_capacity()
        g = self.group_size(batch_size)
        x, y = self.from_draws(self.draw(batch_size // g, g, seq_len, generator, device))
        return x, y, y
