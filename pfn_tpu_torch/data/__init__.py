"""Real-data loaders: the tabular benchmark's datasets (host-side numpy) and
the Omniglot class banks (one tensor on the device; the synthetic stand-in).

Port of ``pfn_tpu/data/__init__.py``."""

from pfn_tpu_torch.data.datasets import (
    class_balance_interleave,
    get_2class_iris,
    get_2class_wine,
    get_breast_cancer,
    get_csv_labeled,
    get_diabetes,
    get_iris,
    get_linnerud,
    get_wine,
    load_local_benchmark,
    load_openml_list,
    load_reference_benchmark,
    load_svmlight,
    test_dids_classification,
    valid_dids_classification,
)
from pfn_tpu_torch.data.omniglot import ClassBank, load_omniglot_class_bank, synthetic_class_bank

__all__ = [
    "ClassBank",
    "class_balance_interleave",
    "get_2class_iris",
    "get_2class_wine",
    "get_breast_cancer",
    "get_csv_labeled",
    "get_diabetes",
    "get_iris",
    "get_linnerud",
    "get_wine",
    "load_local_benchmark",
    "load_omniglot_class_bank",
    "load_openml_list",
    "load_reference_benchmark",
    "load_svmlight",
    "synthetic_class_bank",
    "test_dids_classification",
    "valid_dids_classification",
]
