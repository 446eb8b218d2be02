"""Device ms of the program's ``train.optimizer`` spans (the global norm,
the clip and Adam) per ``train.update`` span, in the profiled stretch."""

from pfnbench import spans


def read(t: dict):
    return spans.ms_per_update({"train.optimizer"})
