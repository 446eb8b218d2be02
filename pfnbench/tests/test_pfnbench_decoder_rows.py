"""The reader of the decoder's row counter (``metrics/decoder_rows_pct.py``)
on synthetic spans: rows decoded over rows produced, summed over the
stretch's ``model.decoder`` spans; None where no span carries the counter
(a program older than it) or there are no spans."""

from types import SimpleNamespace

import pytest

from pfnbench import spans, spec

T = 2010


def _span(name, rows=None):
    return SimpleNamespace(name=name, parent=None, start_ns=0, end_ns=1, records=None, device_ms=None, rows=rows)


def _read(name, held, monkeypatch, kind):
    monkeypatch.setattr(spans, "program_spans", lambda: held)
    return spec.metric_reader(name).read({"kind": kind})


def test_training_reads_the_eval_rows_share(monkeypatch):
    seps, batch = (1595, 10, 2000), 100
    held = [_span("train.update"), _span("model.forward")]
    held += [_span("model.decoder", (batch * (T - sep), batch * T)) for sep in seps] + [_span("train.loss")]
    want = 100.0 * sum(T - sep for sep in seps) / (len(seps) * T)
    assert _read("decoder_rows_pct.train", held, monkeypatch, "train") == pytest.approx(want, rel=1e-12)


def test_scoring_reads_one_row_a_pass(monkeypatch):
    held = [s for _ in range(14) for s in (_span("model.forward"), _span("model.decoder", (32, 32 * T)))]
    assert _read("decoder_rows_pct.score", held, monkeypatch, "score") == pytest.approx(100.0 / T, rel=1e-12)


def test_every_row_reads_100(monkeypatch):
    held = [_span("model.decoder", (4 * 300, 4 * 300))] * 3
    assert _read("decoder_rows_pct.train", held, monkeypatch, "train") == pytest.approx(100.0)


@pytest.mark.parametrize("held", [None, [], [_span("model.decoder"), _span("train.update")],
                                  [SimpleNamespace(name="model.decoder", device_ms=1.0)]],
                         ids=["no_program_spans", "empty", "no_counter", "an_older_span"])
def test_nothing_to_read_gives_none(held, monkeypatch):
    assert _read("decoder_rows_pct.train", held, monkeypatch, "train") is None
    assert _read("decoder_rows_pct.score", held, monkeypatch, "score") is None


def test_an_answer_altered_in_the_row_it_decodes_is_not_correct(tiny_cell, monkeypatch):
    """The scoring check still fails an altered answer now that each pass
    decodes only the scored row (``pfn_predict(..., rows=)``)."""
    from pfn_tpu_torch.evals import harness

    from pfnbench import run

    predict = harness.pfn_predict

    def altered(model, x, y, sep, rows=None):
        out = predict(model, x, y, sep, rows=rows).clone()
        row = sep if rows is None else sep - rows[0]
        out[0, row] = out[1, row]
        return out

    monkeypatch.setattr(harness, "pfn_predict", altered)
    wl, cfg = tiny_cell("fig3a_score_b32")
    result = run.run("fig3a_score_b32", 2**31 + 77, 0.2, False, "cpu", workload_spec=wl, config=cfg)
    assert not result["correct"], result["checks"]
