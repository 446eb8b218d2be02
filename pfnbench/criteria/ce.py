"""Cross-entropy over ``num_classes`` logits (the criterion's config): the
port's ``ce_criterion``. Its head is ``num_classes`` wide whatever the
prior's labels, so a prior with fewer classes leaves the other logits to be
pushed down. A model kind passes the criterion's config to ``program``."""

from pfn_tpu_torch.train import ce_criterion


def n_out(cfg: dict) -> int:
    return cfg["num_classes"]


def program(borders, cfg: dict):
    return ce_criterion(cfg["num_classes"])
