"""The plain reference that decides ``correct``: PyTorch and NumPy only.

Written from the model's equations (for the ``pfn`` kind: PFN-masked dense
attention, post-LN encoder layers with the tanh GELU, the
Linear-GELU-Linear decoder), from the criteria's (the bar-distribution NLL
and the BCE), from the update's (the global-norm clip and Adam) and from
the priors' definitions. Nothing here imports ``jax``, the JAX package or
the measured port; the benchmark hands both sides the same inputs (weights,
borders, seeds), and the reference works out again what the port derives
from them.

The parts of a configuration are found by name: its model
``model_<kind>.py`` here (the config's ``model.kind``, absent ``pfn``), its
prior ``prior_<kind>.py`` and its criterion ``criterion_<kind>.py``, so a
later configuration adds files and edits none.
"""

from pathlib import Path

from pfnbench import spec


def part(prefix: str, kind: str, root: Path = spec.ROOT):
    """The module of file ``reference/<prefix>_<kind>.py`` under ``root``
    (the benchmark's directory), loaded from its file (``spec.load``)."""
    return spec.load("reference", f"{prefix}_{kind}", root)
