"""The port's debug checks, trace and spans
(``pfn_tpu_torch.utils.profiling``) against the JAX package's, on the CPU.

JAX's four ``tests/test_debug_checks.py`` cases: out-of-support bar targets
are clamped (finite NLL, and a step that trains) unless
``pfn_debug_checks()`` is on, which poisons them with NaN and raises
``FloatingPointError``; in-support targets are unaffected. JAX traps a NaN at
the op that makes it (``jax_debug_nans``); PyTorch cannot trap a forward op,
so the port raises where the NaN is first seen: in the backward
(``detect_anomaly(check_nan=True)``) or in the loss the train loop reads. That
deviation is named in the module and held here: the forward NLL under the
checks returns NaN (the value JAX's op would carry) and the train loop
raises. With the flag off the NLL runs no support-check op.

Then ``trace`` writes a Chrome trace of the block, and a ``span`` inside it
names its ops there.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfn_tpu.distributions import BarDistribution as JaxBar
from pfn_tpu.distributions import get_bucket_limits as jax_bucket_limits
from pfn_tpu_torch.distributions import BarDistribution, get_bucket_limits
from pfn_tpu_torch.train import TrainConfig, bar_criterion, train
from pfn_tpu_torch.utils import profiling
from pfn_tpu_torch.utils.profiling import debug_checks_enabled, debug_nans, pfn_debug_checks, recorded, span, trace


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@dataclasses.dataclass
class _MisScaledPrior:
    """A custom prior emitting y far beyond the bar borders: the failure the
    debug check exists to catch."""

    num_features: int = 1
    num_outputs: int = 1

    def sample(self, batch_size, seq_len, generator=None, device=None):
        x = torch.rand((batch_size, seq_len, 1), generator=generator, device=device)
        y = 100.0 + torch.randn((batch_size, seq_len), generator=generator, device=device)
        return x, y, y


def _one_step_loss() -> float:
    cfg = TrainConfig(emsize=16, nhid=32, nlayers=1, nhead=2, bptt=8, batch_size=4, epochs=1, steps_per_epoch=1,
                      attention_impl="dense", verbose=False, device="cpu", lr=0.0)
    return train(_MisScaledPrior(), bar_criterion(get_bucket_limits(10, full_range=(-3.0, 3.0))), cfg).final_loss


def test_nll_poisons_out_of_support_only_in_debug_mode():
    borders = (-3.0, 3.0)
    bar, jbar = BarDistribution(get_bucket_limits(10, full_range=borders)), JaxBar.create(
        jax_bucket_limits(10, full_range=borders))
    logits = torch.zeros(3, 10)
    y = torch.tensor([0.5, 99.0, -99.0])
    plain = bar.nll(logits, y)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jbar.nll(jnp.zeros((3, 10)), jnp.asarray(y.numpy()))),
                               rtol=1e-6)
    assert torch.isfinite(plain).all(), "the fast path clamps and stays finite"
    with pfn_debug_checks():
        assert debug_checks_enabled()
        dbg = bar.nll(logits, y)
    assert not debug_checks_enabled()
    assert torch.equal(dbg[0], plain[0]) and bool(torch.isnan(dbg[1:]).all())
    assert bar.check_support(y).tolist() == [True, False, False]


def test_out_of_support_trains_silently_without_debug_mode():
    assert np.isfinite(_one_step_loss())


def test_out_of_support_raises_under_debug_mode():
    with pfn_debug_checks():
        with pytest.raises(FloatingPointError, match="nan"):
            _one_step_loss()
    assert not debug_checks_enabled() and not profiling.debug_nans_enabled()
    assert np.isfinite(_one_step_loss())  # the scope is over


def test_in_support_targets_unaffected_by_debug_mode():
    bar = BarDistribution(get_bucket_limits(10, full_range=(-5.0, 5.0)))
    logits = torch.randn(2, 10, generator=torch.Generator().manual_seed(0))
    y = torch.tensor([0.1, -0.2])
    plain = bar.nll(logits, y)
    with pfn_debug_checks():
        dbg = bar.nll(logits, y)
    assert torch.equal(dbg, plain)


def test_debug_checks_off_adds_no_op():
    from torch.profiler import ProfilerActivity, profile

    bar = BarDistribution(get_bucket_limits(10, full_range=(-3.0, 3.0)))
    logits, y = torch.zeros(3, 10), torch.tensor([0.5, 99.0, -99.0])

    def ops(enable: bool) -> set:
        with pfn_debug_checks(enable), profile(activities=[ProfilerActivity.CPU]) as prof:
            bar.nll(logits, y)
        return {e.key for e in prof.key_averages()}

    off, on = ops(False), ops(True)
    assert "aten::ge" in on and "aten::le" in on
    assert "aten::ge" not in off and "aten::le" not in off


@pytest.mark.filterwarnings("ignore:Error detected in SqrtBackward0")
def test_debug_nans_raises_on_a_nan_backward():
    x = torch.zeros(3, requires_grad=True)
    (torch.sqrt(x) * 0.0).sum().backward()  # d sqrt at 0 times 0: NaN, unchecked
    assert torch.isnan(x.grad).all()
    with pytest.raises(FloatingPointError, match="nan"):  # raised out of the scope
        with debug_nans():
            (torch.sqrt(x) * 0.0).sum().backward()
    with debug_nans():
        profiling.raise_on_nan(1.0)
        with pytest.raises(FloatingPointError):
            profiling.raise_on_nan(float("nan"))
    profiling.raise_on_nan(float("nan"))  # off: no check


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as log_dir:
        torch.randn(64, 64) @ torch.randn(64, 64)
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert log_dir == str(tmp_path / "tr")
    assert any("mm" in str(e.get("name", "")) for e in data["traceEvents"])


def test_span_names_the_ops(tmp_path):
    profiling.clear()
    a = torch.randn(8, 8)
    with trace(str(tmp_path / "tr")):
        with span("pfn_block"):
            out = a @ a
    assert torch.equal(out, a @ a) and [s.name for s in recorded()] == ["pfn_block"]
    profiling.clear()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    ranges = [e for e in events if e.get("name") == "pfn_block" and "dur" in e]
    mms = [e for e in events if e.get("name") == "aten::mm" and "dur" in e]
    assert ranges and mms
    r = ranges[0]
    assert any(r["ts"] <= m["ts"] and m["ts"] + m["dur"] <= r["ts"] + r["dur"] for m in mms)
