"""Parity of the port's MLP (BNN) prior with the JAX package, non-causal
mode (its categorical discretizer alone: tests/test_torch_port_hyper.py).

The JAX sampler's draws are replayed from its key tree
(tests/torch_port_mlp_replay.py) and fed to the port's deterministic half
``MLPPrior.from_draws``, at F 5, max_hidden 16, max_layers 4, T 40, groups of
4 datasets.

Tolerances: x and real-valued y 1e-5 (atol and rtol: f32 matmuls summed in
another order, then z-scored), binarized labels exactly.
"""

import pytest
import torch

from pfn_tpu.priors import hyper as jhyper
from pfn_tpu_torch.priors import hyper
from pfn_tpu_torch.priors.mlp import MLPPrior
from torch_port_mlp_replay import check_against_jax

CASES = {
    "plain": dict(),
    "categorical_binary": dict(categorical_x=True, is_binary_classification=True,
                               num_features_used=jhyper.UniformInt(1, 6)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mlp_prior_matches_jax_on_replayed_draws(case):
    check_against_jax(CASES[case])


def test_causal_capacity_and_group_size_checks():
    with pytest.raises(ValueError, match="causal mode"):
        MLPPrior(num_features=5, max_hidden=16, max_layers=4, is_causal=True,
                 hidden_dim=hyper.UniformInt(4, 16)).sample(4, 10, generator=torch.Generator())
    with pytest.raises(ValueError, match="divisible"):
        MLPPrior(num_features=2, batch_size_per_sample=3).sample(4, 10, generator=torch.Generator())
    assert MLPPrior(num_features=2).group_size(256) == 32
