"""Input encoders: (B, T, F) -> (B, T, D). Port of
``pfn_tpu/models/encoders.py``.

Factory protocol: the JAX package builds an encoder as ``factory(emsize)``
and flax infers the input width; a torch module needs it up front, so the
port calls ``factory(in_features, emsize)`` (``in_features`` is the prior's
``num_features`` for the x-encoder and 1 for the y-encoder). Parameter names
follow the flax tree (``inner``, ``fc1``/``fc2``, ``embedding``, ``emb``), so
``train.checkpoints.state_dict_from_flax_params`` carries JAX weights over.

``CanonicalEmbedding(num_features, num_classes, emsize)`` and
``EmbeddingEncoder(num_features, emsize, num_embs)`` keep the JAX
constructors. The JAX model cannot build either from its registry entry
alone (``factory(emsize)`` leaves required fields unset); under the port's
protocol ``CanonicalEmbedding`` still cannot (``num_classes`` would be taken
from ``emsize``), while ``EmbeddingEncoder(in_features, emsize)`` can, its
first two fields being exactly what the protocol passes
(tests/test_torch_port_model_options.py names both).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pfn_tpu_torch.models.init import lecun_normal_


class LinearEncoder(nn.Linear):
    """nn.Linear parity (reference encoders.py:8). Its parameters are named
    ``weight`` and ``bias`` directly, as in the reference's state_dict."""

    def __init__(self, num_features: int, emsize: int):
        super().__init__(num_features, emsize)
        lecun_normal_(self.weight)
        nn.init.zeros_(self.bias)


class Normalize(nn.Module):
    """Fixed affine (x - mean) / std (the ``Normalize`` referenced at
    reference encoders.py:18)."""

    def __init__(self, mean: float, std: float):
        super().__init__()
        self.mean, self.std = mean, std

    def forward(self, x):
        return (x - self.mean) / self.std


class NormalizedUniformEncoder(nn.Module):
    """An encoder fed U(0, 1) inputs: (x - 0.5) / sqrt(1/12), then ``inner``
    (reference encoders.py:10-18). The model feeds every encoder the
    compute-dtype-rounded inputs as f32 values, so with a bf16 compute dtype
    this affine runs in f32 where the JAX module runs it in bf16 (in f32 the
    two are the same)."""

    def __init__(self, in_features: int, emsize: int, inner=LinearEncoder):
        super().__init__()
        self.normalize = Normalize(0.5, math.sqrt(1.0 / 12.0))
        self.inner = inner(in_features, emsize)

    def forward(self, x):
        return self.inner(self.normalize(x))


class MLPEncoder(nn.Module):
    """Linear -> GELU (tanh, flax's ``nn.gelu`` default) -> Linear, the
    ``encoders.MLP`` the reference's train.py:247-248 expects."""

    def __init__(self, in_features: int, emsize: int, hidden: int | None = None):
        super().__init__()
        self.fc1 = LinearEncoder(in_features, hidden or emsize)
        self.fc2 = LinearEncoder(hidden or emsize, emsize)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class CanonicalEmbedding(nn.Module):
    """Per-feature categorical embedding splitting emsize across features
    (reference CanEmb, encoders.py:22-33): integer feature f of value c reads
    row ``embedding[c, f]`` of size emsize // F; the F rows are concatenated.
    Init N(0, 1)."""

    def __init__(self, num_features: int, num_classes: int, emsize: int):
        super().__init__()
        if emsize % num_features:
            raise ValueError(f"emsize {emsize} is not divisible by num_features {num_features}")
        self.num_features, self.emsize = num_features, emsize
        self.embedding = nn.Parameter(torch.randn(num_classes, num_features, emsize // num_features))

    def forward(self, x):
        idx = x.to(torch.int64)  # truncation toward zero, as astype(int32)
        gathered = self.embedding[idx, torch.arange(self.num_features, device=x.device)]  # (B, T, F, per)
        return gathered.reshape(*x.shape[:-1], self.emsize)


class EmbeddingEncoder(nn.Module):
    """Binned embedding of features in [0, 1] (the ``EmbeddingEncoder``
    referenced at reference encoders.py:36): ``num_embs`` bins per feature,
    each bin an embedding of size emsize // F, concatenated."""

    def __init__(self, num_features: int, emsize: int, num_embs: int = 100):
        super().__init__()
        self.num_embs = num_embs
        self.emb = CanonicalEmbedding(num_features, num_embs, emsize)

    def forward(self, x):
        bins = torch.clamp((x * self.num_embs).to(torch.int64), 0, self.num_embs - 1)
        return self.emb(bins)
