"""The plain reference that decides ``correct``: PyTorch and NumPy only.

Written from the model's equations (PFN-masked dense attention, post-LN
encoder layers with the tanh GELU, the Linear-GELU-Linear decoder, the
bar-distribution NLL and the BCE, the global-norm clip and Adam) and from
the priors' definitions. Nothing here imports ``jax``, the JAX package or
the measured port; the benchmark hands both sides the same inputs (weights,
borders, seeds), and the reference works out again what the port derives
from them.

The prior of a configuration is found by name: ``prior_<kind>.py`` here, and
a criterion ``criterion_<kind>.py``, so a later configuration adds files and
edits none.
"""

import importlib


def part(prefix: str, kind: str):
    """The module ``pfnbench.reference.<prefix>_<kind>``."""
    return importlib.import_module(f"{__name__}.{prefix}_{kind}")
