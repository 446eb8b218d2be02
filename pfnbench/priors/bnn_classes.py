"""The port's BNN prior of the reference's comparison with ``num_classes``
label classes (the ``bnn`` kind has 2): the ``evals.comparison`` model spec
through ``priors.module.ModulePrior``."""

from pfn_tpu_torch.evals.comparison import BayesianNNModel


def program(cfg: dict):
    return BayesianNNModel(num_features=cfg["num_features"], embed=cfg["embed"],
                           num_classes=cfg["num_classes"]).as_prior()
