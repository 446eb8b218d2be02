"""The port's device mesh, its sharding rules and its collectives against
the JAX package's.

  * The mesh shapes of tests/test_sharding.py:34-43 at four ranks (four gloo
    ranks on the CPU, one spawn) against JAX ``make_mesh`` on four of the
    eight virtual CPU devices, and each rank's coordinates against its
    device's place in the JAX mesh.
  * ``param_sharding`` on the port's parameter names against JAX's name
    rules (``param_sharding`` / ``_spec_for``) for tp, fsdp and ep, with a
    dim that does not divide its axis staying whole; the port's weights are
    (out, in), so a 2-D kernel's spec is JAX's reversed.
  * ``_validate_mesh_shapes``'s errors: the JAX messages, as ValueError
    (the JAX package asserts).
  * More ranks than cards with no backend named raises; nothing picks gloo
    or the CPU.
  * The collectives' forward and backward on dp2 x tp2: a data axis's
    gather sums the gradient (reduce-scatter), a model axis's takes the
    rank's slice; all_reduce's backward is an all-reduce on dp and the
    identity on tp, copy_to's the converse; ppermute's is the inverse shift.
"""

import jax
import numpy as np
import pytest
import torch

import torch_port_mesh_ranks as R
from pfn_tpu.parallel import make_mesh as jax_make_mesh
from pfn_tpu.parallel import param_sharding as jax_param_sharding
from pfn_tpu.train.loop import TrainConfig as JaxTrainConfig
from pfn_tpu.train.loop import _validate_mesh_shapes as jax_validate
from pfn_tpu_torch.parallel import Mesh, init_distributed, param_sharding
from pfn_tpu_torch.train import TrainConfig, seeded_flax_params, state_dict_from_flax_params
from pfn_tpu_torch.train.loop import _validate_mesh_shapes

MESHES = [{}, {"dp": 2, "tp": 2}, {"dp": 1, "sp": 2, "tp": 2}, {"dp": 2, "ep": 2}, {"tp": 2}]


@pytest.fixture(scope="module")
def ranks():
    return R.run_ranks(R.collective_cases, 4, {"meshes": MESHES})


@pytest.mark.parametrize("kw", MESHES, ids=[str(m) for m in MESHES])
def test_mesh_shapes_and_coordinates_match_jax(ranks, kw, eight_devices):
    devices = eight_devices[:4]
    jmesh = jax_make_mesh(**kw, devices=devices)
    for rank, r in enumerate(ranks):
        shape, coords = r["meshes"][tuple(sorted(kw.items()))]
        assert shape == dict(jmesh.shape)
        where = np.argwhere(np.vectorize(lambda d: d.id)(jmesh.devices) == devices[rank].id)[0]
        assert coords == dict(zip(jmesh.axis_names, map(int, where)))


def test_collectives_forward_and_backward(ranks):
    for rank, r in enumerate(ranks):
        dp, tp = r["coords"]["dp"], r["coords"]["tp"]
        peers_dp = [d * 2 + tp + 1 for d in range(2)]  # the values (rank + 1) along dp
        peers_tp = [dp * 2 + t + 1 for t in range(2)]
        g, grad = r["gather_dp"]
        np.testing.assert_array_equal(g[:, 0], np.repeat(peers_dp, 2))
        np.testing.assert_array_equal(grad[:, 0], 2 * np.arange(1.0, 5.0).reshape(2, 2)[dp])  # summed over dp
        g, grad = r["gather_tp"]
        np.testing.assert_array_equal(g[:, 0], np.repeat(peers_tp, 2))
        np.testing.assert_array_equal(grad[:, 0], np.arange(1.0, 5.0).reshape(2, 2)[tp])  # the rank's slice
        s, grad = r["reduce_dp"]
        assert s[0] == sum(peers_dp) and grad[0] == 1 + 2
        s, grad = r["reduce_tp"]
        assert s[0] == sum(peers_tp) and grad[0] == tp + 1
        assert r["copy_tp"][0] == 1 + 2
        y, grad = r["ppermute"]
        assert y[0] == (tp - 1) % 2 and grad[0] == (tp + 1) % 2 + 10


def _fake_mesh(**sizes):
    shape = {"dp": 1, "sp": 1, "tp": 1, "ep": 1, **sizes}
    return Mesh(shape=shape, coords={a: 0 for a in shape}, groups={}, device=torch.device("cpu"))


def _specs_by_name(flax, nlayers, jax_specs):
    """{port name: JAX spec in the port's layout} through the weight bridge,
    each flax leaf marked by its index."""
    leaves, tree = jax.tree_util.tree_flatten(flax)
    marked = jax.tree_util.tree_unflatten(tree, [np.full(np.shape(a), i, np.float32) for i, a in enumerate(leaves)])
    paths = jax.tree_util.tree_flatten_with_path(jax_specs)[0]
    out = {}
    for name, t in state_dict_from_flax_params(marked, nlayers).items():
        i = int(t.flatten()[0])
        spec = tuple(paths[i][1].spec) + (None,) * (t.dim() - len(paths[i][1].spec))
        transposed = t.dim() == 2 and str(paths[i][0][-1].key) == "kernel"  # the bridge transposes kernels
        out[name] = spec[::-1] if transposed else spec
    return out


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("tree", ["default", "options", "moe"])
def test_param_sharding_rules_match_jax(eight_devices, fsdp, tree):
    kw = {"options": dict(encoder="mlp", decoder="scaled"), "moe": dict(num_experts=4)}.get(tree, {})
    flax = seeded_flax_params(3, 32, 64, 2, 10, seed=0, **kw)
    sizes = {"dp": 2, "ep": 4} if tree == "moe" else {"dp": 4, "tp": 2}
    jax_specs = jax_param_sharding(flax, jax_make_mesh(**sizes), fsdp=fsdp)
    want = _specs_by_name(flax, 2, jax_specs)
    sd = state_dict_from_flax_params(flax, 2)
    port = param_sharding(sd, _fake_mesh(**sizes), fsdp=fsdp)
    assert set(port) == set(want)
    for name, spec in want.items():
        assert tuple(port[name]) + (None,) * (sd[name].dim() - len(port[name])) == spec, name
    axes = {a for s in port.values() for a in s if a}
    assert "tp" in axes and ("dp" in axes) == fsdp and ("ep" in axes) == (tree == "moe")


@pytest.mark.parametrize("field,value,sizes", [
    ("batch_size", 5, {"dp": 2}), ("bptt", 7, {"sp": 2}), ("nhead", 3, {"tp": 2}), ("num_experts", 3, {"ep": 2}),
])
def test_validate_mesh_shapes_raises_with_the_jax_message(eight_devices, field, value, sizes):
    base = dict(batch_size=8, bptt=8, nhead=4, num_experts=4)
    base[field] = value
    with pytest.raises(AssertionError) as jax_error:
        jax_validate(JaxTrainConfig(**base), jax_make_mesh(**sizes, devices=eight_devices[:2]))
    with pytest.raises(ValueError) as port_error:
        _validate_mesh_shapes(TrainConfig(**base), _fake_mesh(**sizes))
    assert str(port_error.value) == str(jax_error.value)


def test_the_fused_path_refuses_a_mesh():
    """As ``pfn_tpu/models/fused_apply.py:40``: the fused layers run on one
    device only."""
    from pfn_tpu_torch.models import TransformerConfig
    from pfn_tpu_torch.models.fused_apply import fused_supported

    cfg = TransformerConfig(num_features=1, n_out=4, emsize=32, nhead=4, nhid=64, nlayers=1)
    assert fused_supported(cfg) is None
    assert fused_supported(TransformerConfig(**{**cfg.__dict__, "mesh": _fake_mesh(dp=2)})) == "multi-device mesh"


def test_no_backend_named_needs_a_card_a_rank(monkeypatch):
    """NCCL is the default and takes one card a rank: on the CPU, without a
    card, or with fewer cards than ranks it raises instead of falling back
    to gloo or the CPU; an unknown backend raises."""
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        init_distributed(device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        init_distributed(backend="mpi", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="2 ranks on this host and 1 CUDA cards"):
        init_distributed()
    assert not torch.distributed.is_initialized()
