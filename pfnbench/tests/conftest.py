"""Tests of the benchmark harness (run them with ``python -m pytest
pfnbench/tests -q``). Tests that need a CUDA card carry the ``card``
marker, registered here, and take the ``card`` fixture, which skips them
where there is none: the decision is made when the test runs, never when a
module is imported."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny(config: dict) -> dict:
    """A configuration cut to a CPU test's size, its kinds kept."""
    from pfnbench import spec

    cfg = copy.deepcopy(spec.config(config))
    cfg["model"].update(emsize=32, nhid=64, nlayers=2, nhead=2)
    if config == "gp_fig3a":
        cfg["prior"]["grid"] = 64
        cfg["criterion"].update(num_buckets=20)
        cfg["criterion"]["borders"].update(prior_ys=2000, seq_cap=16)
        cfg["train"].update(bptt=40, eval_pos_max=30)
    else:
        cfg["train"]["bptt"] = 30
    return cfg


# Each cell at a CPU test's size: its workload file with smaller counts.
TINY_WORKLOADS = {
    "fig3a_recipe_b4x25": dict(batch_size=2, aggregate_k_gradients=3),
    "bnn_ref_b256": dict(batch_size=32),
    "fig3a_score_b32": dict(datasets=3, pool_chunks=2, positions=[1, 5, 20, 39]),
    "fig3a_b100x1": dict(batch_size=4),
}


@pytest.fixture
def tiny_cell():
    """(workload, config) of a cell at a CPU test's size."""
    from pfnbench import spec

    def make(name: str):
        wl = spec.workload(name)
        wl.update(TINY_WORKLOADS[name])
        return wl, tiny(wl["config"])

    return make
