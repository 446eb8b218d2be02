"""Device ms of the program's ``prior.sample`` spans (a microbatch's draw
and its sep) per ``train.update`` span, in the profiled stretch."""

from pfnbench import spans


def read(t: dict):
    return spans.ms_per_update({"prior.sample"})
