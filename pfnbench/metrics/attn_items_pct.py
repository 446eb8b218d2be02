"""The per-feature model's attention across rows: device ms of its
``model.attn_items`` spans over its ``model.forward`` spans, in the profiled
stretch of a training cell (``attn_features_pct`` reads the same way)."""

from pfnbench.metrics import attn_features_pct


def read(t: dict):
    return attn_features_pct.read(t, part={"model.attn_items"})
