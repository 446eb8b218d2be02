"""The front door on a device mesh: ``config.build`` with ``mesh.enabled``
and ``python -m pfn_tpu_torch.train``'s ``main`` on two gloo ranks.

``config.build`` builds the mesh over the world, dp taking the ranks the
other axes leave (the JAX package's rule over its devices), at world size 1
and 2. The CLI's run of one update on two ranks (dp2) prints from rank 0
only, gives every rank the same one-device model, and equals the one-rank
run of the same arguments within 1e-5 (loss and the parameter vector,
relative L2). Under ``torchrun`` the ranks start from its environment (NCCL,
one card a rank: the chip's ``mesh_nccl`` phase); here each rank starts its
gloo group before ``main``, as ``main`` then finds it started.
"""

import numpy as np
import pytest
import torch

import torch_port_mesh_ranks as R
from pfn_tpu_torch.train import cli

ARGV = ["ridge", "--loss_function", "mse", "--epochs", "1", "--steps_per_epoch", "1", "--batch_size", "4", "--bptt",
        "8", "--emsize", "16", "--nhid", "32", "--nlayers", "1", "--nhead", "2", "--lr", "1e-3", "--warmup_epochs",
        "0", "--cpu", "--set", "train.verbose=true"]


def test_build_makes_the_mesh_at_world_size_one():
    (r,) = R.run_ranks(R.cli_cases, 1, {})
    assert r["shape"] == {"dp": 1, "sp": 1, "tp": 1, "ep": 1} and r["device"] == "cpu"


def test_cli_on_two_ranks_prints_from_rank_zero_and_matches_one_rank(capsys):
    ranks = R.run_ranks(R.cli_cases, 2, {"argv": ARGV + ["--set", "mesh.enabled=true"]})
    assert [r["shape"]["dp"] for r in ranks] == [2, 2] and [r["coords"]["dp"] for r in ranks] == [0, 1]
    assert "final mean loss" in ranks[0]["printed"] and "| epoch   1 |" in ranks[0]["printed"]
    assert ranks[1]["printed"] == ""
    for n, t in ranks[0]["state"].items():
        np.testing.assert_array_equal(ranks[1]["state"][n], t, err_msg=n)
    torch.set_num_threads(1)
    one = cli.main(ARGV)
    assert ranks[0]["final_loss"] == pytest.approx(one.final_loss, rel=1e-5)
    names = list(ranks[0]["state"])
    a = np.concatenate([ranks[0]["state"][n].ravel() for n in names]).astype(np.float64)
    b = np.concatenate([one.model.state_dict()[n].numpy().ravel() for n in names]).astype(np.float64)
    assert float(np.linalg.norm(a - b) / np.linalg.norm(b)) <= 1e-5
