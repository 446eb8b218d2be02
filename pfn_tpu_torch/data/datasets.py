"""Real tabular datasets for the PFN-vs-baselines benchmark.

A copy of ``pfn_tpu/data/datasets.py`` (host-side numpy; the port imports
nothing of the JAX package). Parity: reference datasets/__init__.py: the
OpenML list loader with NaN/width filtering and a 400-sample cap (:19-56),
the curated did lists (:60-61) and the small local loaders (:63-205). The
reference's signature preprocessing is the class-balance sort-interleave
trick (:26-30, repeated in every loader): sort by label, keep a balanced
2 * minority prefix, then interleave the two classes so that every window of
the sequence is about balanced (:func:`class_balance_interleave`).

All loaders return numpy ``(name, X (N, F) float32, y (N,) float32,
categorical_feats list)`` rows. sklearn, pandas and openml are imported
inside the functions that need them, so the module imports where they are
absent. OpenML fetching needs the ``openml`` package and the network, and
the reference files need their directory: both are gated; the local suite
uses sklearn's bundled datasets.
"""

from __future__ import annotations

import numpy as np


def class_balance_interleave(X: np.ndarray, y: np.ndarray, max_samples: int | None = None):
    """Sort by label, truncate to a balanced 2*minority set, interleave
    classes (0,1,0,1,...). Parity: reference datasets/__init__.py:26-30."""
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    sort = np.argsort(y) if y.mean() < 0.5 else np.argsort(-y)
    pos = int(y.sum()) if y.mean() < 0.5 else int((1 - y).sum())
    X, y = X[sort][-pos * 2 :], y[sort][-pos * 2 :]
    y = y.reshape(2, -1).T.reshape(-1)[::-1].copy()
    X = X.reshape(2, -1, X.shape[1]).transpose(1, 0, 2).reshape(-1, X.shape[1])[::-1].copy()
    if max_samples is not None:
        X, y = X[:max_samples], y[:max_samples]
    return X, y


# ---------------------------------------------------------------------------
# Local loaders (sklearn bundled data; no network)
# ---------------------------------------------------------------------------

def get_iris():
    """3-class iris, class-interleaved (datasets/__init__.py:67-76)."""
    import sklearn.datasets

    X, y = sklearn.datasets.load_iris(return_X_y=True)
    X = X.reshape(3, -1, X.shape[1]).transpose(1, 0, 2).reshape(-1, X.shape[1])
    y = y.reshape(3, -1).T.reshape(-1)
    return X.astype(np.float32), y.astype(np.float32)


def get_2class_iris():
    """Binary iris (classes 0/1), interleaved (datasets/__init__.py:79-91)."""
    import sklearn.datasets

    X, y = sklearn.datasets.load_iris(return_X_y=True)
    X, y = X[y < 2], y[y < 2]
    return class_balance_interleave(X, y)


def get_wine():
    import sklearn.datasets

    X, y = sklearn.datasets.load_wine(return_X_y=True)
    n = (len(y) // 2) * 2
    X = X[:n].reshape(2, -1, X.shape[1]).transpose(1, 0, 2).reshape(-1, X.shape[1])[::-1]
    y = y[:n].reshape(2, -1).T.reshape(-1)[::-1]
    return X.astype(np.float32).copy(), y.astype(np.float32).copy()


def get_2class_wine():
    """Binary wine, balanced + interleaved (datasets/__init__.py:116-123)."""
    import sklearn.datasets

    X, y = sklearn.datasets.load_wine(return_X_y=True)
    X, y = X[y < 2], y[y < 2]
    return class_balance_interleave(X, y)


def get_breast_cancer():
    """Binary, balanced to 424 rows (datasets/__init__.py:132-139)."""
    import sklearn.datasets

    X, y = sklearn.datasets.load_breast_cancer(return_X_y=True)
    return class_balance_interleave(X, y, max_samples=424)


def get_diabetes():
    import sklearn.datasets

    X, y = sklearn.datasets.load_diabetes(return_X_y=True)
    return X.astype(np.float32), y.astype(np.float32)


def get_linnerud():
    import sklearn.datasets

    X, y = sklearn.datasets.load_linnerud(return_X_y=True)
    return X.astype(np.float32), y.astype(np.float32)


def load_local_benchmark(max_samples: int = 400):
    """A hermetic benchmark suite of class-balanced binary datasets in the
    reference's ``[name, X, y, categorical_feats]`` row format."""
    rows = []
    for name, fn in [
        ("2class_iris", get_2class_iris),
        ("2class_wine", get_2class_wine),
        ("breast_cancer", get_breast_cancer),
    ]:
        X, y = fn()
        rows.append([name, X[:max_samples], y[:max_samples], []])
    return rows


def load_svmlight(path: str, max_samples: int = 400):
    """Load an svmlight/libsvm file as a class-balanced binary dataset
    (parity: the svmlight loader at reference datasets/__init__.py:8-16).
    Labels are mapped to {0, 1} by sign/value order."""
    from sklearn.datasets import load_svmlight_file

    X, y = load_svmlight_file(path)
    X = np.asarray(X.todense(), dtype=np.float32)
    labels = np.unique(y)
    assert len(labels) == 2, f"expected binary labels, got {labels}"
    y = (y == labels[1]).astype(np.float32)
    return class_balance_interleave(X, y, max_samples=max_samples)


def get_csv_labeled(
    path: str,
    label_col: str,
    label_map: dict | None = None,
    drop_cols: tuple = (),
    max_samples: int | None = None,
):
    """Load a CSV with a named label column as a class-balanced binary
    dataset. Covers the reference's bundled heart.csv ('target',
    datasets/__init__.py:106-114) and biochem.csv ('class' Abnormal/Normal,
    :94-103). Deviation (documented): the reference's CSV loaders reshape
    raw halves without sorting by label first, which does not actually
    class-balance; we apply the standard sort-interleave like every other
    loader."""
    import pandas as pd

    df = pd.read_csv(path).drop(columns=list(drop_cols))
    y = df[label_col]
    if label_map is not None:
        y = y.map(lambda v: label_map[v])
    X = df.drop(columns=[label_col]).to_numpy(dtype=np.float32)
    y = y.to_numpy(dtype=np.float32)
    return class_balance_interleave(X, y, max_samples=max_samples)


#: The reference's 9 locally bundled real binary-classification datasets
#: (svmlight + CSV files under <ref>/datasets/, loaders
#: datasets/__init__.py:8-16,94-114). Caps follow the reference (400 via the
#: protocol; heart 274, biochem 200 via their loaders).
REFERENCE_BUNDLED_SVMLIGHT = (
    "a1a", "australian", "diabetes", "fourclass", "german.numer",
    "ionosphere_scale", "splice",
)


def load_reference_benchmark(root: str, max_samples: int = 400):
    """Load the reference's bundled svmlight/CSV datasets from ``root`` (a
    directory laid out like the reference's ``datasets/``) in the standard
    ``[name, X, y, categorical_feats]`` row format. Raises FileNotFoundError
    if the directory (or any expected file) is absent — callers gate and
    fall back to :func:`load_local_benchmark`."""
    import os

    rows = []
    for name in REFERENCE_BUNDLED_SVMLIGHT:
        X, y = load_svmlight(
            os.path.join(root, f"{name}.txt"), max_samples=max_samples
        )
        rows.append([name, X, y, []])
    X, y = get_csv_labeled(
        os.path.join(root, "heart.csv"), "target",
        max_samples=min(274, max_samples),
    )
    rows.append(["heart", X, y, []])
    X, y = get_csv_labeled(
        os.path.join(root, "biochem.csv"), "class",
        label_map={"Abnormal": 0, "Normal": 1},
        max_samples=min(200, max_samples),
    )
    rows.append(["biochem", X, y, []])
    return rows


# ---------------------------------------------------------------------------
# OpenML (gated: needs the openml package + network)
# ---------------------------------------------------------------------------

# Curated did lists (reference datasets/__init__.py:60-61).
valid_dids_classification = [13, 59, 4, 15, 40710, 43, 1498]
test_dids_classification = [
    973, 1596, 40981, 1468, 40984, 40975, 41163, 41147, 1111, 41164, 1169,
    1486, 41143, 1461, 41167, 40668, 41146, 41169, 41027, 23517, 41165,
    41161, 41159, 40996, 41138, 1590, 41166, 1464, 41168, 41150, 1489,
    41142, 3, 12, 31, 54, 1067,
]


def get_openml(did: int, max_samples: int = 400):
    """Fetch one OpenML dataset, binarize to classes {0,1}, class-balance
    interleave, cap rows (datasets/__init__.py:19-33)."""
    try:
        import openml
    except ImportError as e:
        raise ImportError(
            "OpenML loaders need the `openml` package and network access; "
            "use load_local_benchmark() for a hermetic suite."
        ) from e
    dataset = openml.datasets.get_dataset(did)
    X, y, categorical_indicator, _ = dataset.get_data(
        dataset_format="array", target=dataset.default_target_attribute
    )
    X, y = X[y < 2], y[y < 2]
    X, y = class_balance_interleave(X, y, max_samples=max_samples)
    return X, y, list(np.where(categorical_indicator)[0])


def load_openml_list(dids, filter_for_nan: bool = True, num_feats: int = 100):
    """Parity: datasets/__init__.py:36-56 (NaN filter, <num_feats features,
    400-row cap)."""
    try:
        import openml
        import pandas as pd
    except ImportError as e:
        raise ImportError(
            "OpenML loaders need the `openml` package and network access; "
            "use load_local_benchmark() for a hermetic suite."
        ) from e
    openml_list = openml.datasets.list_datasets(dids)
    datalist = pd.DataFrame.from_dict(openml_list, orient="index")
    if filter_for_nan:
        filtered = datalist[
            np.logical_and(
                datalist["NumberOfFeatures"] < num_feats,
                datalist["NumberOfInstancesWithMissingValues"] == 0,
            )
        ]
    else:
        filtered = datalist[datalist["NumberOfFeatures"] < num_feats]
    datasets = []
    for ds in filtered.index:
        entry = filtered.loc[ds]
        X, y, categorical_feats = get_openml(int(entry.did), 400)
        datasets.append([entry["name"], X, y, categorical_feats])
    return datasets, filtered
