"""The port's BNN prior of the reference's comparison: the
``evals.comparison`` model spec through ``priors.module.ModulePrior``."""

from pfn_tpu_torch.evals.comparison import BayesianNNModel


def program(cfg: dict):
    return BayesianNNModel(num_features=cfg["num_features"], embed=cfg["embed"]).as_prior()
