"""The port's measurement drivers (``pfn_tpu_torch.experiments``: profile_step,
batch_shape_sweep, anomaly_10x10, fused_ab, flagship_throughput) on the CPU.

  * Held to the JAX scripts' own functions, loaded from their files (their
    top-level imports are the standard library's; no JAX driver's main
    runs): the sweep's payload (``_write``) key for key, including a failed
    shape and the winner rule; ``_resolve_impl`` against ``bench.py``'s on
    one A/B file, and read from the same anchored file from any working
    directory; the anomaly driver's shapes and batches, whose keys are
    JAX's without the block suffix (the named deviation: the TPU tile rule
    is not ported).
  * Held to the JAX package: the parameter count of the profiled Fig-3a
    model at 100 and 10 000 buckets, equal to JAX ``num_params`` of the
    same config's ``init_params`` (23.394064 M at 10 000,
    docs/results/profile_2010.json).
  * Held to the JAX scripts' literal formulas: the roofline
    (``experiments/profile_step.py:135-154``, peak 989) to 1e-12 relative,
    fused_ab's speedup, the sweep's TrainConfig (:49-55) and its
    resume rule.
  * Every driver's main end to end with ``--device cpu`` at emsize 32 / 2
    layers (the model sizes patched in the modules), finite positive
    times; without ``--device`` each needs a card and raises without one.
"""

import argparse
import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch

from pfn_tpu_torch.experiments import (
    anomaly_10x10,
    batch_shape_sweep,
    common,
    flagship_throughput,
    fused_ab,
    profile_step,
)
from pfn_tpu_torch.models.transformer import num_params
from pfn_tpu_torch.priors import GPPrior
from pfn_tpu_torch.train.loop import _updates_per_epoch

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TINY = dict(emsize=32, nhid=64, nlayers=2, nhead=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file, as the other driver test files:
    small CPU ops beside other workers' OpenMP threads thrash."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_script(path: str, name: str):
    """The module of a JAX script (JAX is imported inside its functions
    only, so loading it imports none)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def tiny(monkeypatch):
    for module in (common, profile_step, batch_shape_sweep, flagship_throughput):
        monkeypatch.setattr(module, "FIG3A_MODEL", TINY)
    monkeypatch.setattr(flagship_throughput, "BATCH_SIZE", 8)
    monkeypatch.setattr(flagship_throughput, "BPTT", 32)
    monkeypatch.setattr(profile_step, "REPS", 2)
    monkeypatch.setattr(profile_step, "WARMUP", 1)


@pytest.mark.parametrize("num_buckets, bptt, batch_size, grid", [(100, 100, 64, 0), (10_000, 2010, 4, 8192)])
def test_profiled_model_has_the_jax_parameter_count(num_buckets, bptt, batch_size, grid):
    import jax
    import jax.numpy as jnp

    from pfn_tpu.distributions import get_bucket_limits as jax_bucket_limits
    from pfn_tpu.models.transformer import num_params as jax_num_params
    from pfn_tpu.priors.gp import GPPrior as JaxGPPrior
    from pfn_tpu.train import TrainConfig as JaxTrainConfig
    from pfn_tpu.train import bar_criterion as jax_bar_criterion
    from pfn_tpu.train.loop import build_model as jax_build_model

    # The JAX script's model (experiments/profile_step.py:56-67), its shapes only.
    jax_model = jax_build_model(
        JaxGPPrior(num_features=1, grid=grid, **profile_step.GP_HP),
        jax_bar_criterion(jax_bucket_limits(num_buckets, full_range=(-4.0, 4.0))),
        JaxTrainConfig(emsize=512, nhid=1024, nlayers=6, nhead=4, batch_size=batch_size, bptt=bptt, lr=1e-4,
                       warmup_epochs=1, epochs=1, steps_per_epoch=20, dtype=jnp.bfloat16))
    want = jax_num_params(jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0), seq_len=bptt)))
    _, _, _, state, _ = profile_step.setup(batch_size, bptt, grid, num_buckets, CPU)
    assert num_params(state.model) == want
    if num_buckets == 10_000:
        assert want == 23_394_064


def test_roofline_is_the_jax_formula_at_the_h100_peak():
    P, B, T, fwd, fb, full = 23_394_064, 4, 2010, 7.25, 20.5, 21.75
    got = profile_step.roofline(P, B, T, fwd, fb, full, 512, 6)
    # experiments/profile_step.py:135-154, with the H100's 989 in place of the v5e's 197.
    emsize, nlayers, peak = 512, 6, 989.0
    attn_flops = 4 * B * T * T * emsize * nlayers
    param_flops = 2 * P * B * T
    fwd_flops = param_flops + attn_flops
    step_flops = 3 * fwd_flops
    want = {
        "peak_bf16_tflops": peak,
        "fwd_tflop": fwd_flops / 1e12,
        "fwd_pct_of_peak": 100 * fwd_flops / (fwd / 1e3) / (peak * 1e12),
        "fwd_bwd_pct_of_peak": 100 * step_flops / (fb / 1e3) / (peak * 1e12),
        "full_step_pct_of_peak": 100 * step_flops / (full / 1e3) / (peak * 1e12),
    }
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12)
    # The docstring's count: attention 0.199 of a 0.575 TFLOP forward.
    assert attn_flops / 1e12 == pytest.approx(0.199, abs=5e-4)
    assert got["fwd_tflop"] == pytest.approx(0.575, abs=5e-4)


def test_sweep_payload_is_the_jax_payload(tmp_path):
    jax_sweep = _jax_script("experiments/batch_shape_sweep.py", "jax_batch_shape_sweep")
    results = {"4x25": 4.764, "10x10": 5.692, "20x5": 3.991, "25x4": 3.977,
               "100x1": "failed: OutOfMemoryError: CUDA out of memory. Tried to allocate 3.12 GiB"}
    got_args = argparse.Namespace(bptt=2010, out=str(tmp_path / "port" / "sweep.json"))
    want_args = argparse.Namespace(bptt=2010, out=str(tmp_path / "jax" / "sweep.json"))
    got, want = batch_shape_sweep._write(got_args, dict(results)), jax_sweep._write(want_args, dict(results))
    assert got == want
    assert got["winner"] == "25x4"
    assert json.loads(Path(got_args.out).read_text()) == json.loads(Path(want_args.out).read_text())
    # No shape timed: no winner.
    assert batch_shape_sweep._write(got_args, {"100x1": results["100x1"]}) == jax_sweep._write(
        want_args, {"100x1": results["100x1"]})
    assert batch_shape_sweep.SHAPES == jax_sweep.SHAPES


def test_sweep_resume_skips_timed_shapes_and_retries_failures(tmp_path, monkeypatch):
    out = tmp_path / "sweep.json"
    out.write_text(json.dumps({"s_per_epoch": {"4x25": 4.5, "10x10": "failed: RuntimeError: boom"}}))
    calls = []

    def fake_time_config(batch_size, agg, bptt, epochs_timed, device):
        calls.append((batch_size, agg, bptt, epochs_timed, device))
        if (batch_size, agg) == (50, 2):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return 1.0 + batch_size / 1000

    monkeypatch.setattr(batch_shape_sweep, "time_config", fake_time_config)
    got = batch_shape_sweep.main(["--device", "cpu", "--out", str(out), "--shapes", "4x25,10x10,20x5,50x2",
                                  "--epochs_timed", "1"])
    assert calls == [(10, 10, 2010, 1, CPU), (20, 5, 2010, 1, CPU), (50, 2, 2010, 1, CPU)]
    assert got["s_per_epoch"] == {"4x25": 4.5, "10x10": 1.01, "20x5": 1.02,
                                  "50x2": "failed: OutOfMemoryError: CUDA out of memory"}
    assert got["winner"] == "10x10"
    assert json.loads(out.read_text()) == got
    # Run again: every timed shape is cached, the failure is tried again.
    calls.clear()
    batch_shape_sweep.main(["--device", "cpu", "--out", str(out), "--shapes", "4x25,10x10,20x5,50x2"])
    assert calls == [(50, 2, 2010, 2, CPU)]


@pytest.mark.parametrize("batch_size, agg", batch_shape_sweep.SHAPES)
def test_sweep_config_holds_the_schedule(batch_size, agg):
    cfg = batch_shape_sweep.sweep_config(batch_size, agg, 2010, CPU)
    assert batch_size * agg == 100
    assert (cfg.batch_size, cfg.aggregate_k_gradients, cfg.steps_per_epoch) == (batch_size, agg, 4 * agg)
    assert _updates_per_epoch(cfg) == 4
    # experiments/batch_shape_sweep.py:49-55.
    assert (cfg.emsize, cfg.nhid, cfg.nlayers, cfg.nhead, cfg.bptt) == (512, 1024, 6, 4, 2010)
    assert (cfg.epochs, cfg.lr, cfg.warmup_epochs, cfg.eval_pos_sampler, cfg.eval_pos_max) == (
        1, 1e-4, 1, "weighted", 2000)
    assert cfg.dtype == torch.bfloat16 and cfg.verbose is False
    assert batch_shape_sweep.sweep_config(batch_size, agg, 1000, CPU).eval_pos_max == 1000


@pytest.mark.parametrize("ab", [{"speedup": 1.04}, {"speedup": 1.06}, None, "{not json", ["a", "list"]])
def test_resolve_impl_agrees_with_bench(ab, tmp_path, monkeypatch):
    bench = _jax_script("bench.py", "jax_bench")
    path = tmp_path / "fused_ab.json"
    if isinstance(ab, str):
        path.write_text(ab)
    elif ab is not None:
        path.write_text(json.dumps(ab))
    monkeypatch.setattr(bench, "FUSED_AB_FILE", str(path))
    monkeypatch.setattr(flagship_throughput, "FUSED_AB_FILE", str(path))
    for name in ("best", "auto", "fused", "dense"):
        try:
            want = bench._resolve_impl(name)
        except AttributeError:  # a JSON list has no .get: bench.py raises, and so does the port
            with pytest.raises(AttributeError):
                flagship_throughput._resolve_impl(name)
            continue
        assert flagship_throughput._resolve_impl(name) == want
    if not isinstance(ab, list):
        assert flagship_throughput._resolve_impl("best") == ("fused" if ab == {"speedup": 1.06} else "auto")


@pytest.mark.parametrize("cwd", ["root", "tmp", "experiments"])
def test_resolve_impl_reads_the_anchored_ab_from_any_directory(cwd, tmp_path, monkeypatch):
    # The port's A/B lies beside the package, as bench.py:36-38 anchors its
    # own, and never under the TPU's docs/results/fused_ab.json.
    anchored = ROOT / "docs" / "results" / "torch_h100" / "fused_ab.json"
    assert flagship_throughput.FUSED_AB_FILE == str(anchored)
    assert fused_ab.parser().get_default("out") == flagship_throughput.FUSED_AB_FILE
    want = "auto"
    if anchored.exists():
        want = "fused" if json.loads(anchored.read_text()).get("speedup", 0.0) > 1.05 else "auto"
    # An A/B with the other answer where the working directory's results/
    # would hold one is not read.
    (tmp_path / "results").mkdir()
    (tmp_path / "results" / "fused_ab.json").write_text(json.dumps({"speedup": 2.0 if want == "auto" else 0.5}))
    monkeypatch.chdir({"root": ROOT, "tmp": tmp_path, "experiments": Path(flagship_throughput.__file__).parent}[cwd])
    assert flagship_throughput._resolve_impl("best") == want


def test_flagship_main_prints_the_impl_it_resolved(tmp_path, monkeypatch, capsys):
    path = tmp_path / "fused_ab.json"
    path.write_text(json.dumps({"speedup": 1.2}))
    monkeypatch.setattr(flagship_throughput, "FUSED_AB_FILE", str(path))
    measured = []
    monkeypatch.setattr(flagship_throughput, "measure_pfn_torch", lambda **kw: measured.append(kw) or 30.0)
    monkeypatch.setattr(flagship_throughput, "measure_torch_baseline", lambda **kw: 20.0)
    got = flagship_throughput.main(["--device", "cpu"])
    assert measured[0]["attention_impl"] == "fused" and got["attention_impl"] == "fused"
    assert f"attention_impl best -> fused (the A/B in {path})" in capsys.readouterr().out
    got = flagship_throughput.main(["--device", "cpu", "--attention_impl", "auto"])
    assert measured[1]["attention_impl"] == "auto" and got["attention_impl"] == "auto"
    assert "attention_impl auto -> auto\n" in capsys.readouterr().out


def test_fused_ab_runs_aba_and_writes_where_best_reads(tmp_path, monkeypatch):
    readings = {"auto": [100.0, 110.0], "fused": [126.0]}
    calls = []

    def fake_measure(attention_impl, device, steps, grid, updates_per_call):
        calls.append((attention_impl, device, steps, grid, updates_per_call))
        return readings[attention_impl].pop(0)

    monkeypatch.setattr(fused_ab, "measure_pfn_torch", fake_measure)
    # The anchored A/B moved aside, so that the committed one stays as it is.
    ab_file = tmp_path / "docs" / "results" / "torch_h100" / "fused_ab.json"
    monkeypatch.setattr(flagship_throughput, "FUSED_AB_FILE", str(ab_file))
    monkeypatch.chdir(tmp_path)
    assert flagship_throughput._resolve_impl("best") == "auto"  # no A/B yet
    got = fused_ab.main(["--device", "cpu", "--steps", "3"])
    assert [c[0] for c in calls] == ["auto", "fused", "auto"]
    assert all(c[1:] == (CPU, 3, 2048, 25) for c in calls)
    assert got["speedup"] == 126.0 / (0.5 * (100.0 + 110.0))
    assert got["config"] == {"steps": 3, "grid": 2048, "updates_per_call": 25}
    assert got["card"] == "cpu"
    # The default --out is the port's own A/B, never the TPU's under docs/,
    # and never the working directory's results/.
    assert json.loads(ab_file.read_text()) == got
    assert not (tmp_path / "results").exists()
    assert flagship_throughput._resolve_impl("best") == "fused"  # 1.2 > 1.05


def test_anomaly_timers_make_the_repeats_they_time(monkeypatch):
    n = {"attn": 0, "prior": 0}
    real_attn, real_sample = anomaly_10x10.pfn_flash_attention, GPPrior.sample

    def attn(*args, **kwargs):
        n["attn"] += 1
        return real_attn(*args, **kwargs)

    def sample(self, *args, **kwargs):
        n["prior"] += 1
        return real_sample(self, *args, **kwargs)

    monkeypatch.setattr(anomaly_10x10, "pfn_flash_attention", attn)
    monkeypatch.setattr(GPPrior, "sample", sample)
    for batch, reps in ((20, 2), (25, 1), (4, 1)):
        n.update(attn=0, prior=0)
        s = anomaly_10x10.time_attention(batch, 16, nhead=1, d=8, reps_timed=reps, device="cpu")
        assert n["attn"] == 1 + reps * (100 // batch)  # one warm-up call
        assert s > 0
        s = anomaly_10x10.time_prior(batch, 16, reps_timed=reps, device="cpu")
        assert n["prior"] == 1 + reps * (100 // batch)
        assert s > 0


def test_anomaly_keys_are_jax_keys_without_the_block_deviation(tmp_path, monkeypatch):
    jax_anomaly = _jax_script("experiments/anomaly_10x10.py", "jax_anomaly_10x10")
    assert anomaly_10x10.STEP_SHAPES == jax_anomaly.STEP_SHAPES
    assert anomaly_10x10.ATTN_BATCHES == jax_anomaly.ATTN_BATCHES
    assert not hasattr(anomaly_10x10, "_force_block")  # the TPU tile rule is not ported
    monkeypatch.setattr(anomaly_10x10, "time_step", lambda b, agg, bptt, epochs, device: 1.0 + b)
    monkeypatch.setattr(anomaly_10x10, "time_attention", lambda b, bptt, reps_timed, device: 0.5 + b)
    monkeypatch.setattr(anomaly_10x10, "time_prior", lambda b, bptt, reps_timed, device: 0.25 + b)
    out = tmp_path / "anomaly.json"
    got = anomaly_10x10.main(["--device", "cpu", "--out", str(out)])
    # The JAX script's keys (experiments/anomaly_10x10.py:176, 194, 211), block suffix dropped.
    jax_step = {f"{b}x{agg}_block{block}" for b, agg in jax_anomaly.STEP_SHAPES for block in (128, 256)}
    jax_attn = {f"B{b}_block{block}" for b in jax_anomaly.ATTN_BATCHES for block in (128, 256)}
    assert set(got["step_s_per_epoch"]) == {k.rsplit("_block", 1)[0] for k in jax_step}
    assert set(got["attn_s_per_100ds"]) == {k.rsplit("_block", 1)[0] for k in jax_attn}
    assert set(got["prior_s_per_100ds"]) == {f"B{b}" for b in jax_anomaly.ATTN_BATCHES}
    assert got["step_s_per_epoch"]["10x10"] == 11.0 and got["attn_s_per_100ds"]["B25"] == 25.5
    assert json.loads(out.read_text()) == got


def _finite_positive(*values) -> bool:
    return all(isinstance(v, float) and math.isfinite(v) and v > 0 for v in values)


def test_profile_step_runs_on_the_cpu(tiny, tmp_path):
    out = tmp_path / "profile.json"
    got = profile_step.main(["--device", "cpu", "--bptt", "48", "--batch_size", "4", "--num_buckets", "20",
                             "--grid", "256", "--out", str(out)])
    stages = ("prior_sample_ms", "forward_ms", "fwd_bwd_ms", "optimizer_ms", "full_step_ms")
    assert _finite_positive(*(got[k] for k in stages))
    jax_keys = json.loads((ROOT / "docs" / "results" / "profile_2010.json").read_text())
    assert set(jax_keys) | {"card", "device"} == set(got)
    assert set(jax_keys["roofline"]) == set(got["roofline"])
    P = round(got["params_m"] * 1e6)
    assert got["roofline"] == profile_step.roofline(P, 4, 48, got["forward_ms"], got["fwd_bwd_ms"],
                                                    got["full_step_ms"], TINY["emsize"], TINY["nlayers"])
    assert got["card"] == "cpu" and json.loads(out.read_text()) == got


def test_batch_shape_sweep_runs_on_the_cpu(tiny, tmp_path):
    got = batch_shape_sweep.main(["--device", "cpu", "--bptt", "32", "--shapes", "20x5,100x1", "--epochs_timed", "1",
                                  "--out", str(tmp_path / "sweep.json")])
    assert _finite_positive(*got["s_per_epoch"].values()) and set(got["s_per_epoch"]) == {"20x5", "100x1"}
    assert got["winner"] in got["s_per_epoch"]


def test_anomaly_runs_on_the_cpu(tiny, tmp_path, monkeypatch):
    monkeypatch.setattr(anomaly_10x10, "STEP_SHAPES", [(20, 5)])
    monkeypatch.setattr(anomaly_10x10, "ATTN_BATCHES", [25])
    got = anomaly_10x10.main(["--device", "cpu", "--bptt", "32", "--epochs_timed", "1", "--reps_timed", "1",
                              "--out", str(tmp_path / "anomaly.json")])
    assert _finite_positive(got["step_s_per_epoch"]["20x5"], got["attn_s_per_100ds"]["B25"],
                            got["prior_s_per_100ds"]["B25"])


def test_fused_ab_and_flagship_run_on_the_cpu(tiny, tmp_path):
    got = fused_ab.main(["--device", "cpu", "--steps", "2", "--updates_per_call", "2", "--grid", "128",
                         "--out", str(tmp_path / "ab.json")])
    assert _finite_positive(got["baseline_a"], got["fused"], got["baseline_b"], got["speedup"])
    got = flagship_throughput.main(["--device", "cpu", "--steps", "2", "--updates_per_call", "2",
                                    "--baseline_steps", "2", "--attention_impl", "auto"])
    assert _finite_positive(got["prior_batches_per_sec"], got["torch_baseline_prior_batches_per_sec"])


@pytest.mark.parametrize("call", [
    lambda: flagship_throughput.measure_torch_baseline(steps=1),
    lambda: flagship_throughput.measure_pfn_torch(steps=1, attention_impl="auto"),
    lambda: batch_shape_sweep.time_config(4, 25, 64),
    lambda: anomaly_10x10.time_attention(4, 64),
    lambda: anomaly_10x10.time_prior(4, 64),
    lambda: profile_step.main([]),
    lambda: batch_shape_sweep.main(["--out", "unused.json"]),
    lambda: anomaly_10x10.main(["--out", "unused.json"]),
    lambda: fused_ab.main(["--out", "unused.json"]),
    lambda: flagship_throughput.main([]),
], ids=["baseline", "flagship", "sweep_config", "attention", "prior", "profile_main", "sweep_main", "anomaly_main",
        "fused_ab_main", "flagship_main"])
def test_the_card_is_the_default_and_there_is_no_cpu_fallback(call, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert not list(tmp_path.iterdir())  # nothing written before it raised
