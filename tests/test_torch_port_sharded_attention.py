"""Sequence-sharded PFN attention of the port against the JAX package.

``pfn_sharded_attention`` on four gloo ranks on the CPU (one spawn), on dp2 x
sp2 and sp2 x tp2: each rank holds its rows, heads and positions of q, k and
v, gathers K and V over sp and runs the prefix pass (its plain dense
version on the CPU) plus the exact self merge. The assembled output is held
against JAX ``pfn_attention_reference`` at sep 0, 64, 100 and 255 (255: the
last position, inside the second shard; 100 inside the first) within 2e-5
(tests/test_sharding.py:124); the gradients of q, k and v, assembled from the
ranks, against ``jax.grad`` of the reference within 1e-4 (:157).
``pfn_attention(impl="auto", mesh=)`` takes the same path. The merge's
``prefix_impl`` ("dense", and "flash", whose plain version runs on a CPU
tensor) against JAX's merge on a sequence shard.

Deviation held here: where global shapes do not divide the mesh the JAX
package falls back to the dense reference (its B=1 init tracer); the port
has no tracer and raises ``ValueError`` at the model's entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_mesh_ranks as R
from pfn_tpu.ops.attention import pfn_attention_prefix_merge as jax_merge
from pfn_tpu.ops.attention import pfn_attention_reference as jax_reference
from pfn_tpu_torch.ops.attention import _mesh_divisible, pfn_attention_prefix_merge

SPEC = ("dp", "tp", "sp", None)
SEPS = [0, 64, 100, 255]
FWD_SHAPE, GRAD_SHAPE, GRAD_SEP = (4, 4, 256, 64), (2, 2, 128, 32), 77
LAYOUTS = {"dp2_sp2": {"dp": 2, "sp": 2}, "sp2_tp2": {"sp": 2, "tp": 2}}


def _normal(seed, shape, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def ranks():
    payload = {"layouts": LAYOUTS, "fwd": _normal(0, FWD_SHAPE), "seps": SEPS, "grad": _normal(1, GRAD_SHAPE),
               "w": _normal(2, GRAD_SHAPE, 1)[0], "grad_sep": GRAD_SEP}
    return payload, R.run_ranks(R.sharded_attention_cases, 4, payload)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("sep", SEPS)
def test_forward_matches_jax_reference(ranks, layout, sep):
    payload, results = ranks
    want = np.asarray(jax_reference(*(jnp.asarray(a) for a in payload["fwd"]), jnp.asarray(sep)))
    got = R.assemble(results, (layout, "fwd", sep), FWD_SHAPE, SPEC)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_dispatch_with_a_mesh_takes_the_sharded_path(ranks, layout):
    payload, results = ranks
    sep = SEPS[2]
    want = np.asarray(jax_reference(*(jnp.asarray(a) for a in payload["fwd"]), jnp.asarray(sep)))
    np.testing.assert_allclose(R.assemble(results, (layout, "dispatch"), FWD_SHAPE, SPEC), want, atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_gradients_match_jax_grad(ranks, layout):
    payload, results = ranks
    w = jnp.asarray(payload["w"])

    def loss(q, k, v):
        return jnp.sum(w * jax_reference(q, k, v, jnp.asarray(GRAD_SEP)))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in payload["grad"]))
    for name, ref in zip("qkv", want):
        got = R.assemble(results, (layout, "grad", name), GRAD_SHAPE, SPEC)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_indivisible_shapes_raise_where_jax_falls_back_to_dense(ranks, layout):
    _, results = ranks
    assert all("do not divide the mesh" in r[(layout, "indivisible")] for r in results)
    sp2 = R.types.SimpleNamespace(axis_size=lambda a: 2 if a == "sp" else 1)
    assert not _mesh_divisible((1, 2, 7, 4), sp2) and _mesh_divisible((2, 2, 8, 4), sp2)


@pytest.mark.parametrize("prefix_impl", ["dense", "flash"])
@pytest.mark.parametrize("sep", [0, 20, 40, 63])
def test_prefix_merge_on_a_shard_matches_jax(prefix_impl, sep):
    """q is the second half of the sequence (q_global_start 32) against all
    64 keys; JAX's merge on the CPU runs its dense prefix pass."""
    q, k, v = _normal(3, (2, 2, 64, 16))
    start = 32
    want = jax_merge(*(jnp.asarray(a) for a in (q[:, :, start:], k, v, k[:, :, start:], v[:, :, start:])),
                     jnp.asarray(sep), start, prefix_impl="dense")
    got = pfn_attention_prefix_merge(*(torch.from_numpy(a) for a in (q[:, :, start:], k, v, k[:, :, start:],
                                                                       v[:, :, start:])),
                                     sep, start, prefix_impl=prefix_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="prefix_impl"):
        pfn_attention_prefix_merge(*(torch.from_numpy(a) for a in (q, k, v, k, v)), sep, 0, prefix_impl="nope")
