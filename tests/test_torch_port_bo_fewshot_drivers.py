"""The port's few-shot and Bayesian-optimisation drivers on the CPU.

``fewshot_omniglot`` and ``bayesopt_eval`` (``python -m
pfn_tpu_torch.experiments.<name>``) each run ``--cpu --quick`` at a tiny
size (the quick config's steps per epoch patched down, one or two epochs)
and write the JAX drivers' keys: ``summary.json`` as
``experiments/fewshot_omniglot.py:119-131`` writes it, and the payload and
regret summary of ``experiments/bayesopt_eval.py:111-135``, under
``results/`` by default (never ``docs/``). Their configs are the JAX
drivers'; without ``--cpu`` they need a card.
"""

import json

import numpy as np
import pytest
import torch

from pfn_tpu_torch.experiments import bayesopt_eval, fewshot_omniglot


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fewshot_driver_quick(tmp_path, monkeypatch):
    monkeypatch.setitem(fewshot_omniglot.QUICK, "steps_per_epoch", 3)
    monkeypatch.setitem(fewshot_omniglot.ACCURACY, "num_batches", 2)
    out = tmp_path / "fs"
    summary = fewshot_omniglot.main(["--cpu", "--quick", "--epochs", "2", "--finetune_epochs", "3", "--imgsz", "8",
                                     "--omniglot_root", str(tmp_path / "none"), "--out", str(out)])
    written = json.loads((out / "summary.json").read_text())
    assert written == summary
    assert sorted(written) == ["chance", "finetuned_acc", "k_shot", "n_way", "source", "zero_shot_acc"]
    assert written["source"] == "synthetic" and written["chance"] == 0.2
    assert all(0.0 <= written[k] <= 1.0 for k in ("zero_shot_acc", "finetuned_acc"))


def test_fewshot_configs():
    args = fewshot_omniglot.build_parser().parse_args([])
    assert args.out.startswith("results/")
    cfg = fewshot_omniglot.pretrain_config(args, "cpu")
    assert (cfg.emsize, cfg.nhid, cfg.nlayers, cfg.nhead, cfg.bptt, cfg.batch_size) == (1024, 2048, 6, 8, 26, 64)
    assert (cfg.eval_pos_sampler, cfg.fixed_eval_pos, cfg.lr, cfg.epochs) == ("fixed", 25, 1e-4, 100)
    ft = fewshot_omniglot.finetune_config(cfg, args)
    assert (ft.epochs, ft.lr, ft.warmup_epochs, ft.emsize) == (40, 2.5e-5, 2, 1024)
    quick = fewshot_omniglot.pretrain_config(fewshot_omniglot.build_parser().parse_args(["--quick"]), "cpu")
    assert (quick.emsize, quick.nlayers, quick.epochs) == (64, 2, 12)


def test_bayesopt_driver_quick(tmp_path, monkeypatch):
    out = tmp_path / "bo.json"
    payload = bayesopt_eval.main(["--cpu", "--quick", "--epochs", "1", "--num_functions", "2", "--num_candidates", "24",
                                  "--num_iterations", "5", "--out", str(out)])
    written = json.loads(out.read_text())
    assert written == json.loads(json.dumps(payload))
    assert sorted(written) == ["epochs", "gp_hp", "num_candidates", "num_functions", "num_init", "num_iterations",
                               "summary"]
    assert written["gp_hp"] == {"noise": 1e-2, "outputscale": 1.0, "lengthscale": 0.3} and written["num_init"] == 3
    for name in ("ei", "ucb", "random"):
        s = written["summary"][name]
        assert sorted(s) == ["final_regret", "iters_to_0.1", "mean_regret"] and len(s["mean_regret"]) == 6
        assert np.all(np.diff(s["mean_regret"]) <= 1e-12) and s["final_regret"] >= 0  # best-so-far regret


def test_bayesopt_configs():
    args = bayesopt_eval.build_parser().parse_args([])
    cfg = bayesopt_eval.train_config(args, "cpu")
    assert (cfg.emsize, cfg.nhid, cfg.nlayers, cfg.nhead, cfg.bptt, cfg.batch_size) == (128, 256, 4, 4, 64, 64)
    assert (cfg.epochs, cfg.lr, cfg.updates_per_call, args.num_candidates, args.num_iterations) == (400, 1e-3, 10, 128,
                                                                                                   25)
    assert bayesopt_eval.UCB_BETA == 1.5 and bayesopt_eval.NUM_BUCKETS == 256


@pytest.mark.parametrize("driver", [fewshot_omniglot, bayesopt_eval])
def test_drivers_need_a_card_without_cpu(driver, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main(["--quick", "--out", str(tmp_path / "out")])
