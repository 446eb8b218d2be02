"""The share of the rows the forward produced that the decoder ran on, in
the profiled stretch: the counter each ``model.decoder`` span carries
(``Span.rows``: rows decoded, rows produced), summed over the stretch.
Training decodes the eval rows (>= sep) of each microbatch, scoring the one
row a pass reads. None where no span carries the counter (a program older
than it)."""

from pfnbench import spans


def read(t: dict):
    recorded = spans.program_spans()
    if recorded is None:
        return None
    counts = [s.rows for s in recorded if s.name == "model.decoder" and getattr(s, "rows", None) is not None]
    produced = sum(p for _, p in counts)
    return 100.0 * sum(d for d, _ in counts) / produced if produced else None
