"""Each per-layer metric reader, and the breakdown, on a synthetic trace."""

import pytest

from pfnbench import flops, spec, trace


def synthetic() -> dict:
    # A 1000 us window: an f32 GEMM 100-400, the bf16 flash forward 450-550,
    # dq 600-650 and dk/dv 640-700 (overlapping dq by 10 us), idle elsewhere.
    prof = {"window": (0.0, 1000.0),
            "kernels": [("sm80_xmma_gemm_f32f32", 100.0, 400.0),
                        ("void (anonymous namespace)::fwd_sm90<128, true>(CUtensorMap_st)", 450.0, 550.0),
                        ("void (anonymous namespace)::dq_sm90<128, true>(CUtensorMap_st)", 600.0, 650.0),
                        ("void (anonymous namespace)::dkv_sm90<128, true>(CUtensorMap_st)", 640.0, 700.0)],
            "host": [("cudaLaunchKernel", 420.0, 440.0), ("cudaStreamSynchronize", 700.0, 1000.0)],
            "results": []}
    calls = [{"BH": 8, "T": 2010, "D": 128, "sep": 1000, "dtype": "bfloat16", "backward": b, "count": 1}
             for b in (False, True)]
    return {"kind": "train", "enqueue_s": [0.010, 0.030], "window_s": 2.0, "required_flops": 989e12,
            "peak_flops": 989e12, "profile": prof, "attention_calls": calls}


def read(name, t):
    return spec.metric_reader(name).read(t)


def test_host_enqueue_ms():
    assert read("host_enqueue_ms.train", synthetic()) == pytest.approx(20.0)
    assert read("host_enqueue_ms.train", {"enqueue_s": []}) is None


def test_mfu():
    # 989 TFLOP required over 2 s at 989 TFLOP/s: 50 %.
    assert read("mfu.train", synthetic()) == pytest.approx(50.0)
    assert read("mfu.score", dict(synthetic(), required_flops=0)) is None


def test_attn_roofline():
    t = synthetic()
    bound = sum(flops.attention_bound_s(8, 2010, 128, 1000, "bfloat16", b) for b in (False, True))
    kernel_s = (100 + 50 + 60) * 1e-6
    assert read("attn_roofline.train", t) == pytest.approx(100 * bound / kernel_s)
    t["profile"]["kernels"] = t["profile"]["kernels"][:1]
    assert read("attn_roofline.train", t) is None  # no flash kernel: nothing to read, never 0


def test_device_idle_pct():
    # busy: 300 + 100 + (600..700) 100 = 500 us of 1000.
    assert read("device_idle_pct.train", synthetic()) == pytest.approx(50.0)
    t = synthetic()
    t["profile"]["kernels"] = []
    assert read("device_idle_pct.score", t) is None


def test_breakdown():
    b = trace.breakdown(synthetic()["profile"])
    assert b["device_ops"][0] == ["sm80_xmma_gemm_f32f32", pytest.approx(300e-6)]
    assert len(b["device_ops"]) == 4
    gaps = dict((round(s * 1e6), name) for name, s in b["idle_gaps"])
    assert gaps[300] == "cudaStreamSynchronize"  # 700-1000
    assert gaps[100] == "host"  # 0-100: no call before it
    assert gaps[50] == "host after cudaLaunchKernel"  # 550-600
    assert sorted(round(s * 1e6) for _, s in b["idle_gaps"]) == [50, 50, 100, 300]  # 400-450 too


def test_the_window_starts_at_the_first_launch(monkeypatch):
    """The syncs the profiler makes beyond the pads neither open nor close
    the window."""
    import torch

    class Event:
        def __init__(self, name, start, end, cuda=False):
            self.name = name
            self.time_range = type("R", (), {"start": start, "end": end})()
            self.device_type = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU

    events = [Event("cudaDeviceSynchronize", 0.0, 5.0), Event("cudaLaunchKernel", 25000.0, 25010.0),
              Event("k", 25020.0, 26000.0, cuda=True), Event("cudaStreamSynchronize", 25010.0, 26005.0),
              Event("cudaDeviceSynchronize", 26006.0, 26007.0), Event("cudaDeviceSynchronize", 46100.0, 46101.0)]

    class Prof:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def step(self):
            pass

        def events(self):
            return events

    monkeypatch.setattr(torch.profiler, "profile", Prof)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(trace, "PAD_S", 0.0)
    prof = trace.profile(lambda: None, 1)
    assert prof["window"] == (25000.0, 26005.0)
    assert trace.busy_us(prof) == 980.0
