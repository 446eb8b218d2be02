"""Parity of the port's MLP (BNN) prior with the JAX package in causal mode:
x drawn from the valid hidden activations by masked scores, y the output or
(``y_is_effect=False``) a random activation, with per-unit noise scales,
weight dropout, uniform causes, tanh, categoricals and binarized labels.

The JAX sampler's draws are replayed from its key tree
(tests/torch_port_mlp_replay.py); tolerances as there: x and real-valued y
1e-5 (atol and rtol), binarized labels exactly.
"""

import pytest

from pfn_tpu.priors import hyper as jhyper
from torch_port_mlp_replay import check_against_jax

CASES = {
    "noise_scales_dropout": dict(is_causal=True, hidden_dim=jhyper.UniformInt(6, 16),
                                 num_layers=jhyper.UniformInt(3, 5), pre_sample_weights=True,
                                 dropout_prob=jhyper.Uniform(0.0, 0.5)),
    "y_cause_categorical": dict(is_causal=True, y_is_effect=False, hidden_dim=jhyper.UniformInt(6, 16),
                                categorical_x=True, is_binary_classification=True, sampling="uniform",
                                activation="tanh"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_causal_mlp_prior_matches_jax_on_replayed_draws(case):
    check_against_jax(CASES[case])
