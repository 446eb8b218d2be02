"""The port's evaluation drivers and heatmaps on the CPU.

  * ``bayesian_models_custom_priors`` and ``tabular_eval``
    (``python -m pfn_tpu_torch.experiments.<name>``) each run ``--cpu
    --quick`` at a tiny size (the quick config's steps per epoch patched
    down, a few epochs, one or two windows), ``tabular_hgb_baseline`` (host
    only, as its JAX script; no flag for either) without ``--ref_root`` on
    the sklearn suite at one window, and each writes the
    JAX drivers' keys: the Bayesian driver's ``summary.json`` as
    ``experiments/bayesian_models_custom_priors.py:86-107`` writes it, the
    tabular driver's ``pfn`` and each baseline that ran (a missing package
    or an unknown name is skipped), and the hgb driver's file the keys of
    ``docs/results/tabular_hgb_reference_suite.json``, which the JAX driver
    wrote (and which the port's driver only reads).
  * ``tabular_eval --checkpoint`` then ``--load`` gives the PFN column
    again; its non-quick config takes ``attention_impl="auto"`` where the
    JAX driver asks ``bench._resolve_impl("best")`` (a named deviation), and
    its source imports nothing of ``bench``.
  * Without ``--cpu`` the drivers need a card and raise without one.
  * The heatmap functions draw on the Agg backend the same mesh as the JAX
    ones: equal arrays for the same bar-distribution inputs, and within
    1e-4 of the normalised densities for the two packages' models carrying
    the same weights through the weight bridge.
"""

import ast
import json
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from threadpoolctl import threadpool_limits  # noqa: E402

from pfn_tpu import presentation as jpres  # noqa: E402
from pfn_tpu.distributions import get_bucket_limits as jax_bucket_limits  # noqa: E402
from pfn_tpu.models.transformer import PFNTransformer as JaxPFN  # noqa: E402
from pfn_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from pfn_tpu.train import bar_criterion as jax_bar_criterion  # noqa: E402
from pfn_tpu_torch import presentation  # noqa: E402
from pfn_tpu_torch.distributions import get_bucket_limits  # noqa: E402
from pfn_tpu_torch.experiments import bayesian_models_custom_priors, tabular_eval, tabular_hgb_baseline  # noqa: E402
from pfn_tpu_torch.models import PFNTransformer, TransformerConfig  # noqa: E402
from pfn_tpu_torch.train import bar_criterion, seeded_flax_params, state_dict_from_flax_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def test_bayesian_driver_quick(tmp_path, monkeypatch):
    monkeypatch.setitem(bayesian_models_custom_priors.QUICK, "steps_per_epoch", 5)
    out = tmp_path / "bm"
    summary = bayesian_models_custom_priors.main(["--cpu", "--quick", "--epochs", "2", "--bptt", "40",
                                                  "--training_samples", "20", "--out", str(out),
                                                  "--checkpoint", str(tmp_path / "ck")])
    written = json.loads((out / "summary.json").read_text())
    assert {k: sorted(v) for k, v in written.items()} == {"transformer": ["acc", "nll", "seconds"],
                                                           "svi": ["acc", "nll"], "mcmc": ["acc", "nll"]}
    assert all(np.isfinite(v) for d in written.values() for v in d.values())
    assert written == summary
    assert (tmp_path / "ck").exists()
    only = bayesian_models_custom_priors.main(["--cpu", "--quick", "--epochs", "1", "--bptt", "40", "--out",
                                               str(tmp_path / "only"), "--methods", "transformer"])
    assert sorted(only) == ["transformer"]


def test_tabular_driver_quick_checkpoint_and_load(tmp_path, monkeypatch):
    common = ["--cpu", "--quick", "--epochs", "1", "--bptt", "40", "--eval_positions", "20", "--max_samples", "1"]
    first = tabular_eval.main(common + ["--baselines", "knn", "xgb", "nosuch", "--out", str(tmp_path / "a"),
                                        "--checkpoint", str(tmp_path / "ck")])
    assert sorted(first) == ["knn", "pfn"]  # xgboost is not installed; "nosuch" is no baseline
    assert json.loads((tmp_path / "a" / "summary.json").read_text()) == first
    assert all(0.0 <= v <= 1.0 for v in first.values())
    loaded = tabular_eval.main(common + ["--baselines", "knn", "--out", str(tmp_path / "b"), "--load",
                                         str(tmp_path / "ck")])
    assert loaded == pytest.approx(first)


def test_tabular_driver_configs_and_imports():
    args = tabular_eval.build_parser().parse_args([])
    cfg = tabular_eval.train_config(args, "cpu")
    assert (cfg.emsize, cfg.nhid, cfg.nlayers, cfg.nhead, cfg.batch_size, cfg.bptt) == (512, 1024, 6, 4, 256, 100)
    # A deviation on purpose: the JAX driver asks bench._resolve_impl("best").
    assert cfg.attention_impl == "auto" and cfg.dtype == torch.float32
    assert args.out.startswith("results/") and args.ref_root is None
    source = (ROOT / "pfn_tpu_torch" / "experiments" / "tabular_eval.py").read_text()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] != "bench" for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert (node.module or "").split(".")[0] != "bench"
    assert "sys.path" not in source


def test_hgb_driver_sklearn_suite(tmp_path):
    out = tmp_path / "hgb.json"
    written = tabular_hgb_baseline.main(["--bptt", "20", "--eval_position", "10",
                                         "--max_samples", "1", "--out", str(out), "--cache_dir",
                                         str(tmp_path / "cache")])
    reference = json.loads((ROOT / "docs" / "results" / "tabular_hgb_reference_suite.json").read_text())
    assert json.loads(out.read_text()) == written
    assert sorted(written) == sorted(reference)
    names = ["2class_iris", "2class_wine", "breast_cancer"]
    assert sorted(written["hgb"]) == sorted(names + ["_windows"])
    assert all(0.0 <= written["hgb"][n] <= 1.0 for n in names)
    for col in ("pfn", "logistic", "knn", "gp"):
        assert written[col] == reference[col]  # the committed columns, merged read-only
    assert written["weighted_mean"]["hgb"] == written["hgb_weighted_mean"]


@pytest.mark.parametrize("driver", [bayesian_models_custom_priors, tabular_eval])
def test_drivers_need_a_card_without_cpu(driver, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main(["--quick", "--out", str(tmp_path)])


def _meshes_equal(a, b, atol=0.0):
    np.testing.assert_allclose(np.asarray(a.get_array()), np.asarray(b.get_array()), atol=atol, rtol=0)
    np.testing.assert_allclose(a.get_coordinates(), b.get_coordinates(), atol=1e-6, rtol=0)


def test_heatmaps_match_jax():
    data = np.arange(12.0).reshape(3, 4)
    boxes = (np.array([0.0, 1.0, 2.0, 3.0]), np.array([1.0, 2.0, 3.0, 4.0]), np.array([0.0, 0.5, 2.0]),
             np.array([0.5, 2.0, 3.0]))
    fig, (ax1, ax2) = plt.subplots(1, 2)
    _meshes_equal(presentation.heatmap_with_box_sizes(ax1, data, *boxes),
                  jpres.heatmap_with_box_sizes(ax2, data, *boxes))
    assert ax1.get_xlim() == ax2.get_xlim() == (0.0, 4.0) and ax1.get_ylim() == ax2.get_ylim() == (0.0, 3.0)
    borders = np.array([0.0, 1.0, 3.0])
    x = np.array([0.7, 0.1, 0.4])  # unsorted on purpose
    preds = np.array([[0.25, 0.75], [0.5, 0.5], [0.9, 0.1]])
    _meshes_equal(presentation.plot_bar_distribution(ax1, x, borders, preds),
                  jpres.plot_bar_distribution(ax2, x, borders, preds))
    with pytest.raises(ValueError, match="borders"):
        presentation.plot_bar_distribution(ax1, x, borders[:2], preds)
    plt.close(fig)


@pytest.fixture(scope="module")
def bar_models():
    params = seeded_flax_params(1, 16, 32, 1, 20, seed=0)
    jmodel = JaxPFN(JaxConfig(num_features=1, n_out=20, emsize=16, nhead=2, nhid=32, nlayers=1))
    model = PFNTransformer(TransformerConfig(num_features=1, n_out=20, emsize=16, nhead=2, nhid=32, nlayers=1)).eval()
    model.load_state_dict(state_dict_from_flax_params(params, 1), strict=True)
    jcrit = jax_bar_criterion(jax_bucket_limits(20, full_range=(-3.0, 3.0)))
    crit = bar_criterion(get_bucket_limits(20, full_range=(-3.0, 3.0)))
    return (jmodel, jax.tree.map(jnp.asarray, params), jcrit), (model, crit)


def test_model_heatmaps_match_jax(bar_models):
    (jmodel, jparams, jcrit), (model, crit) = bar_models
    x = np.linspace(0, 1, 12, dtype=np.float32)[:, None]
    y = np.sin(x[:, 0] * 6)
    fig, (ax1, ax2) = plt.subplots(1, 2)
    for window in (None, (-1.2, 1.2)):
        _meshes_equal(presentation.plot_model_w_eval_pos(ax1, model, crit, x, y, 6, min_max_y=window),
                      jpres.plot_model_w_eval_pos(ax2, jmodel, jparams, jcrit, jnp.asarray(x), jnp.asarray(y), 6,
                                                  min_max_y=window), atol=1e-4)
    xs = np.linspace(0, 1, 9, dtype=np.float32)[:, None]
    ys = np.sin(xs[:, 0] * 5)
    _meshes_equal(presentation.plot_model_and_orig_curve(ax1, model, crit, xs, ys, given_indices=[1, 4, 7]),
                  jpres.plot_model_and_orig_curve(ax2, jmodel, jparams, jcrit, xs, ys, given_indices=[1, 4, 7]),
                  atol=1e-4)
    assert len(ax1.lines) == len(ax2.lines) == 2
    plt.close(fig)
