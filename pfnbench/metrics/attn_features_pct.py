"""The per-feature model's attention across features: device ms of its
``model.attn_features`` spans over its ``model.forward`` spans, in the
profiled stretch of a training cell (the forward's share only; the
backward has no per-layer spans). None where the program has no such span."""

from pfnbench import spans


def read(t: dict, part: set = frozenset({"model.attn_features"})):
    recorded = spans.program_spans()
    if recorded is None or t.get("kind") != "train":
        return None
    ms, whole = spans.device_ms(recorded, part), spans.device_ms(recorded, {"model.forward"})
    return 100.0 * ms / whole if ms is not None and whole else None
