"""The port's MoE FFN against the JAX package's, and under expert and
sequence parallelism.

  * ``MoEFFN`` against JAX ``MoEFFN`` on the same weights (JAX's init, w2
    moved off zero so the experts reach the output): the output, the
    load-balancing loss and the rows of dropped tokens (exactly zero in
    both) within 1e-5.
  * One expert with capacity >= T is the dense FFN; a capacity far below
    T / E drops all but E * C tokens a batch row.
  * On four gloo ranks (one spawn), dp2 x ep2 and sp2 x ep2: the forward's
    rows against the one-rank forward (1e-5), the aux shares of the dp and
    sp ranks summing to the one-rank loss (the queue positions and the
    capacity run over the global sequence), and one update of an MoE PFN
    (num_experts 4, capacity 7 of T 24, so tokens drop) against the port's
    one-rank update: the whole parameter and clipped gradient vectors
    within 1e-5 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_port_mesh_ranks as R
from pfn_tpu.models.moe import MoEFFN as JaxMoE
from pfn_tpu_torch.models.moe import MoEFFN
from pfn_tpu_torch.train import seeded_flax_params, state_dict_from_flax_params

D, H = 16, 32


def _jax_moe(E, cf, x, bump=0.1):
    moe = JaxMoE(D, H, num_experts=E, capacity_factor=cf)
    params = jax.jit(moe.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: a + bump, params) if bump else params
    out, mut = jax.jit(lambda p, x: moe.apply({"params": p}, x, mutable=["moe_aux"]))(params, jnp.asarray(x))
    (aux,) = jax.tree.leaves(mut["moe_aux"])
    return jax.device_get(params), np.asarray(out), float(aux)


def _port_weights(params) -> dict:
    return {"router.weight": torch.from_numpy(np.asarray(params["router"]["kernel"]).T.copy()),
            "router.bias": torch.from_numpy(np.asarray(params["router"]["bias"])),
            **{n: torch.from_numpy(np.asarray(params[n])) for n in ("w1", "b1", "w2", "b2")}}


def _port_moe(E, cf, params):
    moe = MoEFFN(D, H, E, capacity_factor=cf)
    moe.load_state_dict(_port_weights(params), strict=True)
    return moe


def _x(B, T, seed=0):
    return np.random.default_rng(seed).standard_normal((B, T, D)).astype(np.float32)


@pytest.mark.parametrize("E,cf", [(4, 1.25), (4, 0.5), (2, 2.0)])
def test_moe_matches_jax(E, cf):
    x = _x(3, 20)
    params, want, want_aux = _jax_moe(E, cf, x)
    got, aux = _port_moe(E, cf, params)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    assert float(aux) == pytest.approx(want_aux, rel=1e-5, abs=1e-6)
    np.testing.assert_array_equal(np.abs(got.detach().numpy()).sum(-1) == 0, np.abs(want).sum(-1) == 0)


def test_single_expert_equals_the_dense_ffn():
    x = _x(3, 10)
    params, _, _ = _jax_moe(1, 1.0, x)
    got, _ = _port_moe(1, 1.0, params)(torch.from_numpy(x))
    w = _port_weights(params)
    ref = F.gelu(torch.from_numpy(x) @ w["w1"][0] + w["b1"][0], approximate="tanh") @ w["w2"][0] + w["b2"][0]
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), atol=1e-5)


def test_capacity_truncation_drops_the_overflow():
    E, T = 2, 32
    x = _x(2, T)
    params, want, _ = _jax_moe(E, 0.1, x)  # C = 1
    got, _ = _port_moe(E, 0.1, params)(torch.from_numpy(x))
    zero_rows = (got.detach().abs().sum(-1) == 0).numpy()
    assert zero_rows.sum(axis=1).min() >= T - E
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


NFEAT, EMSIZE, NHEAD, NHID, NLAYERS, BUCKETS, E = 2, 32, 4, 64, 2, 20, 4
B, T, SEP = 4, 24, 9
BORDERS = np.linspace(-3.0, 3.0, BUCKETS + 1).astype(np.float32)
LAYOUTS = {"dp2_ep2": {"dp": 2, "ep": 2}, "sp2_ep2": {"sp": 2, "ep": 2}}


def _update_case(name, layout):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, B, T, NFEAT)).astype(np.float32)
    y = rng.standard_normal((1, B, T)).astype(np.float32)
    flax = seeded_flax_params(NFEAT, EMSIZE, NHID, NLAYERS, BUCKETS, seed=11, num_experts=E)
    cfg = dict(emsize=EMSIZE, nhid=NHID, nlayers=NLAYERS, nhead=NHEAD, bptt=T, batch_size=B, epochs=4,
               steps_per_epoch=1, lr=1e-3, warmup_epochs=0, eval_pos_sampler="fixed", fixed_eval_pos=SEP,
               attention_impl="auto", verbose=False, device="cpu", num_experts=E)
    return {"name": name, "layout": layout, "cfg": cfg, "batch": (x, y, y.copy()), "borders": BORDERS,
            "weights": {n: t.numpy() for n, t in state_dict_from_flax_params(flax, NLAYERS).items()}}


@pytest.fixture(scope="module")
def mesh_runs():
    x = _x(4, 24, seed=5)
    params, _, _ = _jax_moe(E, 1.25, x)
    cases = [_update_case(name, layout) for name, layout in LAYOUTS.items()]
    payload = {"layouts": LAYOUTS, "D": D, "H": H, "E": E, "cf": 1.25, "x": x, "cases": cases,
               "moe": {n: t.numpy() for n, t in _port_weights(params).items()}}
    ranks = R.run_ranks(R.moe_forward_cases, 4, payload)
    torch.set_num_threads(1)
    with torch.no_grad():
        want, want_aux = _port_moe(E, 1.25, params)(torch.from_numpy(x))
    one = {c["name"]: R.one_update(c, None) for c in cases}
    return ranks, want.numpy(), float(want_aux), one


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_moe_forward_on_a_mesh_matches_one_rank(mesh_runs, layout):
    ranks, want, want_aux, _ = mesh_runs
    got = R.assemble(ranks, (layout, "y"), want.shape, ("dp", "sp", None))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    shares = [r[(layout, "aux")] for r in ranks if r[(layout, "y")][0]["ep"] == 0]
    assert sum(shares) == pytest.approx(want_aux, rel=1e-5)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_moe_update_on_a_mesh_matches_one_rank(mesh_runs, layout):
    ranks, _, _, one = mesh_runs
    got, want = ranks[0]["updates"][layout], one[layout]
    names = list(want["params"])

    def rel(a, b):
        a, b = (np.concatenate([np.asarray(t[n], np.float64).ravel() for n in names]) for t in (a, b))
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert rel(got["params"], want["params"]) <= 1e-5
    assert rel(got["grads"], want["grads"]) <= 1e-5
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
