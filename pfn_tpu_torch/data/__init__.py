"""Real-data loaders (host-side numpy): the tabular benchmark's datasets.

The datasets part of ``pfn_tpu/data/__init__.py``; the Omniglot class banks
are not ported yet (ROADMAP.md queue 1 item 11)."""

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

__all__ = [
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
    "load_openml_list",
    "load_reference_benchmark",
    "load_svmlight",
    "test_dids_classification",
    "valid_dids_classification",
]
