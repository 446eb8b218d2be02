"""The readers of the program's spans (``spans.py`` and the metrics that use
it) on synthetic spans and a synthetic profile: the clock fit, the charging
of idle gaps, the partition of the idle time, the launches, the device-time
shares, and None where there is nothing to read."""

import random
from types import SimpleNamespace

import pytest

from pfnbench import spans, spec

OFFSET_US = -5_000_000.25  # the profile's clock minus the program's
READERS = ["prior_ms.train", "optimizer_ms.train", "decoder_pct.train", "decoder_pct.score", "launches.train",
           "idle_prior_ms.train", "idle_model_ms.train", "idle_optimizer_ms.train", "idle_outside_ms.train"]
# One update's spans on the program's clock (us from the update's start): name, start, end, parent.
UPDATE = [("train.update", 0, 1000, None), ("prior.sample", 10, 100, 0), ("model.forward", 100, 400, 0),
          ("model.decoder", 300, 400, 2), ("train.loss", 400, 450, 0), ("train.backward", 450, 700, 0),
          ("train.optimizer", 700, 900, 0), ("train.backward.head", 450, 550, 5),
          ("train.backward.encoder", 550, 700, 5)]
# Idle gaps on the program's clock, each with the layer it is charged to.
GAPS = [((1050, 1060), "prior"), ((1350, 1360), "model"), ((1500, 1510), "model"), ((1800, 1830), "optimizer"),
        ((1950, 1970), "outside"), ((2020, 2030), "prior"), ((3050, 3100), "outside")]
LAUNCHES = [1020, 1120, 1320, 1460, 1720, 2020, 2500, 3060]  # the last after both updates


def synthetic_spans(updates=2, start_us=1000):
    out = []
    for u in range(updates):
        base = len(out)
        for name, a, b, parent in UPDATE:
            a_ns, b_ns = (start_us + 1000 * u + a) * 1000, (start_us + 1000 * u + b) * 1000
            out.append(SimpleNamespace(name=name, parent=None if parent is None else base + parent, start_ns=a_ns,
                                       end_ns=b_ns, records=(a_ns, b_ns), device_ms=(b - a) / 1000))
    return out


def synthetic_trace(kind="train"):
    """The profile of two updates: the program's event records as
    ``cudaEventRecord`` calls on the profile's clock, kernels everywhere from
    1000 to 3050 but in ``GAPS``, the window 1000-3100."""
    records = sorted({r for s in synthetic_spans() for r in s.records})
    host = [("cudaEventRecord", r / 1e3 + OFFSET_US - 0.5, r / 1e3 + OFFSET_US + 0.5) for r in records]
    host += [("cudaLaunchKernel", t + OFFSET_US, t + OFFSET_US + 3) for t in LAUNCHES]
    host.append(("cudaStreamSynchronize", 3050 + OFFSET_US, 3100 + OFFSET_US))
    edges = [1000] + [x for (a, b), _ in GAPS[:-1] for x in (a, b)] + [3050]
    kernels = [("k", edges[i] + OFFSET_US, edges[i + 1] + OFFSET_US) for i in range(0, len(edges), 2)]
    prof = {"window": (1000 + OFFSET_US, 3100 + OFFSET_US), "kernels": kernels, "host": host, "results": [0, 0]}
    return {"kind": kind, "profile": prof}


@pytest.fixture
def program(monkeypatch):
    """Serve ``spans.program_spans`` from a list the test sets."""
    held = {"spans": synthetic_spans()}
    monkeypatch.setattr(spans, "program_spans", lambda: held["spans"])
    spans._FITS.clear()
    yield held
    spans._FITS.clear()


def read(name, t):
    return spec.metric_reader(name).read(t)


def test_the_fit_recovers_the_offset_from_shifted_event_records():
    rng = random.Random(5)
    program_spans = synthetic_spans(updates=6)
    records = sorted({r for s in program_spans for r in s.records})
    calls = [("cudaEventRecord", r / 1e3 + OFFSET_US + rng.uniform(-2, 2), r / 1e3 + OFFSET_US + rng.uniform(2, 4))
             for r in records[1:]]  # the program's first record is not in the profile
    calls += [("cudaEventRecord", 100.0 + OFFSET_US, 101.0 + OFFSET_US), ("cudaLaunchKernel", 0.0, 1.0)]
    fit = spans.fit(program_spans, {"host": calls})
    assert fit["offset_us"] == pytest.approx(OFFSET_US + 3, abs=1)  # the calls end 2-4 us after the records
    assert fit["residual_us"] < 3 and fit["max_residual_us"] < 5
    assert fit["matched"] == len(records) - 1 and fit["records"] == len(records) and fit["calls"] == len(records)


def test_the_fit_needs_event_records_on_both_sides():
    assert spans.fit(synthetic_spans(), {"host": [("cudaLaunchKernel", 0.0, 1.0)]}) is None
    cpu = [SimpleNamespace(**dict(vars(s), records=None)) for s in synthetic_spans()]
    assert spans.fit(cpu, synthetic_trace()["profile"]) is None


def test_each_idle_gap_goes_to_the_innermost_open_span(program):
    idle = spans.idle_by_layer(synthetic_trace())
    want = dict.fromkeys(spans.LAYERS, 0.0)
    for (a, b), layer in GAPS:
        want[layer] += (b - a) / 1e3 / 2  # ms per update, two updates
    assert idle == pytest.approx(want)
    for layer in spans.LAYERS:
        assert read(f"idle_{layer}_ms.train", synthetic_trace()) == pytest.approx(want[layer])


def test_the_idle_readings_partition_the_idle_share(program):
    t = synthetic_trace()
    per_update = sum(read(f"idle_{layer}_ms.train", t) for layer in spans.LAYERS)
    window_us = t["profile"]["window"][1] - t["profile"]["window"][0]
    assert 100.0 * per_update * 1e3 * 2 / window_us == pytest.approx(read("device_idle_pct.train", t))


def test_launches_inside_updates(program):
    assert read("launches.train", synthetic_trace()) == pytest.approx(7 / 2)


def test_device_time_readers(program):
    t = synthetic_trace()
    assert read("prior_ms.train", t) == pytest.approx(0.09)
    assert read("optimizer_ms.train", t) == pytest.approx(0.2)
    assert read("decoder_pct.train", t) == pytest.approx(100 * (0.1 + 0.05 + 0.1) / 1.0)
    program["spans"] = [s for s in synthetic_spans() if s.name in ("model.forward", "model.decoder")]
    assert read("decoder_pct.score", synthetic_trace("score")) == pytest.approx(100 * 0.1 / 0.3)
    assert read("prior_ms.train", t) is None  # no update


@pytest.mark.parametrize("name", READERS)
def test_each_reader_returns_none_without_spans(program, monkeypatch, name):
    kind = "score" if name.endswith(".score") else "train"
    program["spans"] = None
    assert read(name, synthetic_trace(kind)) is None
    program["spans"] = [SimpleNamespace(**dict(vars(s), records=None, device_ms=None)) for s in synthetic_spans()]
    assert read(name, synthetic_trace(kind)) is None  # the CPU: host times only
    assert read(name, {"kind": kind}) is None  # no profile


def test_a_program_without_spans_gives_none(monkeypatch):
    from pfn_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recorded")
    assert spans.program_spans() is None
    for name in READERS:
        assert read(name, synthetic_trace("score" if name.endswith(".score") else "train")) is None
