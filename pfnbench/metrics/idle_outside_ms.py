"""Device-idle ms per update charged to none of the prior, the model and the
optimizer: the gaps under ``train.update``'s own code or outside every span
(the harness's loop and its loss read). Each idle gap of the profiled window
goes once to the innermost program span open on the host at its middle
(``spans.idle_by_layer``), so the four ``idle_*_ms`` metrics partition the
window's idle time."""

from pfnbench import spans


def read(t: dict):
    idle = spans.idle_by_layer(t)
    return None if idle is None else idle["outside"]
