from pfn_tpu_torch.train import full_support_bar_criterion


def n_out(cfg: dict) -> int:
    return cfg["num_buckets"]


def program(borders):
    return full_support_bar_criterion(borders)
