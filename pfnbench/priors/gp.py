"""The port's GP prior on its grid sampler (``pfn_tpu_torch.priors.GPPrior``)."""

from pfn_tpu_torch.priors import GPPrior


def program(cfg: dict):
    return GPPrior(num_features=1, noise=cfg["noise"], outputscale=cfg["outputscale"],
                   lengthscale=cfg["lengthscale"], grid=cfg["grid"])
