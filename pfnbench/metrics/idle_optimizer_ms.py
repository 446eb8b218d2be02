"""Device-idle ms per update charged to the optimizer: the gaps under a
``train.optimizer`` span. Each idle gap of the profiled window goes once to
the innermost program span open on the host at its middle
(``spans.idle_by_layer``), so the four ``idle_*_ms`` metrics partition the
window's idle time."""

from pfnbench import spans


def read(t: dict):
    idle = spans.idle_by_layer(t)
    return None if idle is None else idle["optimizer"]
