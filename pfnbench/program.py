"""What the harness asks of the system under test beside its model kind:
the head's width and a device sync. The port's prior, criterion and model
are built by the config's model kind, ``models/<kind>.py``
(``spec.program_model(kind, root).build``)."""

from __future__ import annotations

import torch

from pfnbench import spec


def n_out(cfg: dict) -> int:
    """The head's width, as the configuration's criterion sets it."""
    return spec.program_criterion(cfg["criterion"]["kind"]).n_out(cfg["criterion"])


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
