"""Data transforms shared by priors. Port of the part of
``pfn_tpu/priors/transforms.py`` that the inference front end uses."""

from __future__ import annotations


def normalize_by_used_features(x, num_features_used, num_features: int):
    """Rescale when only a subset of features carries signal and the rest is
    zero-padding (reference priors/utils.py:81-82)."""
    return x / (num_features_used / num_features)
