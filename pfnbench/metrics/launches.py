"""Kernel launches per update: the profile's kernel-launch runtime calls
that fall, on the clock the program's spans share with the profile
(``spans.fit``), inside a ``train.update`` span, over those spans."""

from pfnbench import spans


def read(t: dict):
    return spans.launches_per_update(t)
