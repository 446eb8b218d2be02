"""The whole step's share of the chip's peak: the window's required
operations (``flops.py``) over its wall time times the peak of the
configuration's dtype."""


def read(t: dict):
    if not t.get("window_s") or not t.get("required_flops"):
        return None
    return 100.0 * t["required_flops"] / (t["window_s"] * t["peak_flops"])
