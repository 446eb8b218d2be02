"""The main path's bf16 agreement checks of ``chip_smoke.py`` on the CPU, at
a small size (2 layers, emsize 64, nhid 64, 2 heads, T 64, 16 buckets).

  * ``bf16_update_vs_dense`` (phase ``train``): one update on the kernel
    path against the dense path, loss, grad norm and the whole clipped
    gradient vector, beside a probe (the attention output scaled by 1 +
    ``FUSED_BF16_PROBE``). On the CPU the "kernel" path at T 64 is the dense
    one, so identical paths differ by exactly 0 and the check passes. With
    the 2 % probe's weights on the kernel side the check fails, its vector
    entry over budget at every seed tried; at some of those seeds the loss
    and the grad norm stay inside their budgets, so a check of those two
    alone (the check before the vector) passes an attention error of 2 %.
  * ``logits_vs_dense`` (phase ``slice``): the positional logits, max-abs
    and relative L2, beside the same probe, the same way.
"""

import importlib.util
import math
import sys
from pathlib import Path

import pytest
import torch

from pfn_tpu_torch.distributions import get_bucket_limits
from pfn_tpu_torch.evals import eval_positional_logits_per_dataset
from pfn_tpu_torch.models import PFNTransformer, TransformerConfig
from pfn_tpu_torch.priors import GPPrior, sample_y_for_buckets
from pfn_tpu_torch.train import TrainConfig, full_support_bar_criterion, seeded_flax_params, state_dict_from_flax_params

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SIZE = dict(emsize=64, nhid=64, nlayers=2, nhead=2)
T, BUCKETS, BATCH = 64, 16, 4
SEEDS = [0, 1, 2, 3]
POSITIONS = [1, 10, 32, 63]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file, as the other driver test files:
    small CPU ops beside other workers' OpenMP threads thrash."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py as a module (its top-level imports are the standard
    library's; nothing of it runs on import)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module
    try:
        spec.loader.exec_module(module)
        yield module
    finally:
        sys.modules.pop("chip_smoke", None)


@pytest.fixture(scope="module")
def prior():
    return GPPrior(num_features=1, noise=1e-4, outputscale=1.0, lengthscale=0.6)


@pytest.fixture(scope="module")
def criterion(prior):
    ys = sample_y_for_buckets(prior, 10_000, T, seed=7, device=CPU)
    return full_support_bar_criterion(get_bucket_limits(BUCKETS, ys=ys))


def _weights(seed: int) -> dict:
    return state_dict_from_flax_params(
        seeded_flax_params(1, SIZE["emsize"], SIZE["nhid"], SIZE["nlayers"], BUCKETS, seed=seed), SIZE["nlayers"])


def _train_cfg() -> TrainConfig:
    return TrainConfig(**SIZE, bptt=T, batch_size=BATCH, lr=1e-4, warmup_epochs=2, eval_pos_sampler="mixture",
                       dtype=torch.bfloat16, device=CPU, seed=0, verbose=False)


@pytest.fixture(scope="module")
def probed_updates(smoke, prior, criterion):
    """The update check with the 2 % probe's weights on the kernel side, a
    weight seed each."""
    out = {}
    for seed in SEEDS:
        w = _weights(seed)
        out[seed] = smoke.bf16_update_vs_dense(prior, criterion, _train_cfg(), w, CPU,
                                               kernel_weights=smoke._value_probe(w, SIZE["emsize"], 2e-2))
    return out


def test_update_check_passes_on_identical_paths(smoke, prior, criterion):
    got = smoke.bf16_update_vs_dense(prior, criterion, _train_cfg(), _weights(0), CPU)
    assert got["diff"] == {"loss": 0.0, "grad_norm": 0.0, "grads": 0.0}
    assert set(got["budget"]) == {"loss", "grad_norm", "grads"}
    assert all(0 < b < 0.1 for b in got["budget"].values())
    assert got["checks"] == {"kernel_vs_dense_update": True, "bf16_check_sees_the_probe": True}
    assert math.isfinite(got["probe_rel_change"]) and got["probe_rel_change"] > got["budget"]["grads"] > 0
    # The loss and grad norm budgets: 2x the dense bf16 path's own
    # difference + 1e-3 of the f32 value, as before the vector joined them.
    for key in ("loss", "grad_norm"):
        bf16, f32 = got["one"]["dense_bf16"][key], got["one"]["dense_f32"][key]
        assert got["budget"][key] == 2 * abs(bf16 - f32) + 1e-3 * abs(f32)


@pytest.mark.parametrize("seed", SEEDS)
def test_update_check_fails_on_the_probe_weights(seed, probed_updates):
    got = probed_updates[seed]
    assert got["checks"]["kernel_vs_dense_update"] is False
    assert got["diff"]["grads"] > got["budget"]["grads"]
    assert math.isfinite(got["probe_rel_change"]) and got["probe_rel_change"] > 0


def test_loss_and_grad_norm_alone_miss_the_probe(probed_updates):
    """Where the vector's entry alone is over budget: the loss and grad norm
    check, the one the train phase had, passes a 2 % attention error."""
    vector_only = [seed for seed, got in probed_updates.items()
                   if got["diff"]["loss"] <= got["budget"]["loss"]
                   and got["diff"]["grad_norm"] <= got["budget"]["grad_norm"]]
    assert vector_only
    for seed in vector_only:
        assert probed_updates[seed]["diff"]["grads"] > probed_updates[seed]["budget"]["grads"]


def _slice_inputs(prior):
    cfg = TransformerConfig(num_features=1, n_out=BUCKETS, emsize=SIZE["emsize"], nhead=SIZE["nhead"],
                            nhid=SIZE["nhid"], nlayers=SIZE["nlayers"], dtype=torch.bfloat16)
    x, y, _ = prior.sample(BATCH, T, generator=torch.Generator().manual_seed(991), device=CPU)
    return cfg, x, y


def _logits(cfg, weights, x, y):
    model = PFNTransformer(cfg).eval()
    model.load_state_dict(weights, strict=True)
    return eval_positional_logits_per_dataset(model, x, y, POSITIONS)


def test_logits_check_passes_on_identical_paths(smoke, prior):
    cfg, x, y = _slice_inputs(prior)
    w = _weights(0)
    readings, checks = smoke.logits_vs_dense(cfg, w, x, y, POSITIONS, _logits(cfg, w, x, y), CPU)
    assert readings["err_kernel_vs_dense"] == 0.0 and readings["rel_l2_kernel_vs_dense"] == 0.0
    assert readings["err_kernel_vs_f32"] == readings["err_dense_vs_f32"] > 0
    assert readings["logits_budget"]["max_abs"] == 2 * readings["err_dense_vs_f32"] + 1e-3
    assert readings["probe_scale"] == smoke.FUSED_BF16_PROBE
    for key in ("max_abs", "rel_l2"):
        reach = readings["probe_change"][key]
        assert math.isfinite(reach) and reach > readings["logits_budget"][key] > 0
    assert checks == {"kernel_vs_dense": True, "kernel_vs_dense_rel_l2": True, "max_abs_check_sees_the_probe": True,
                      "rel_l2_check_sees_the_probe": True}


def test_logits_check_fails_on_the_probe_logits(smoke, prior):
    cfg, x, y = _slice_inputs(prior)
    w = _weights(0)
    probed = _logits(cfg, smoke._value_probe(w, SIZE["emsize"], 2e-2), x, y)
    readings, checks = smoke.logits_vs_dense(cfg, w, x, y, POSITIONS, probed, CPU)
    assert readings["rel_l2_kernel_vs_dense"] > readings["logits_budget"]["rel_l2"]
    assert checks["kernel_vs_dense_rel_l2"] is False
    assert checks["max_abs_check_sees_the_probe"] and checks["rel_l2_check_sees_the_probe"]
