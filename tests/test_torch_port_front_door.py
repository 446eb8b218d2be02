"""The port's front door against the JAX package's, on the CPU: the
registries, the config tree (overrides, YAML), the CLI (``python -m
pfn_tpu_torch.train``) and a user-registered eval-position sampler; after
tests/test_config.py.

Deviations, named: the port's ``TrainConfig`` has ``device`` and
``exact_gelu`` (absent from the JAX config, so the tree comparisons drop
them); ``--cpu`` sets ``TrainConfig.device`` where the JAX flag selects a
JAX backend; ``mesh.enabled`` on the CPU raises unless the caller started a
gloo world (NCCL takes one card a rank).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pfn_tpu import config as jconfig
from pfn_tpu import registries as jreg
from pfn_tpu.train import cli as jcli
from pfn_tpu_torch import config, registries
from pfn_tpu_torch.priors import StrokePrior
from pfn_tpu_torch.train import cli, loop
from pfn_tpu_torch.train.checkpoints import restore_checkpoint

ROOT = Path(__file__).resolve().parents[1]
PORT_ONLY_TRAIN_FIELDS = ("device", "exact_gelu", "model_kind")
TINY = ["--bptt", "12", "--batch_size", "4", "--emsize", "16", "--nhid", "32", "--nlayers", "2", "--nhead", "2",
        "--steps_per_epoch", "2", "--cpu"]
OVERRIDES = ["train.lr=0.0003", "train.nlayers=3", "prior.name=ridge", "prior.kwargs.noisy_std=0.05",
             "criterion.kwargs.num_buckets=17", "criterion.kwargs.full_range=(-2.0, 2.0)", "train.fsdp=false",
             "train.verbose=TRUE", "train.eval_pos_max=none", "train.eval_pos_sampler=weighted", "mesh.tp=2",
             "encoder=mlp", "pos_encoder=learned", "checkpoint_path=some/dir"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small CPU ops, beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_tree(cfg) -> dict:
    d = config.to_dict(cfg)
    for name in PORT_ONLY_TRAIN_FIELDS:
        d["train"].pop(name)
    return d


@pytest.mark.parametrize("name", ["PRIORS", "CRITERIONS", "ENCODERS", "POS_ENCODERS", "EVAL_POS_SAMPLERS"])
def test_registries_have_the_jax_names(name):
    port, jax_table = getattr(registries, name), getattr(jreg, name)
    assert port.names() == jax_table.names()
    assert port.kind == jax_table.kind
    with pytest.raises(KeyError, match="available"):
        port.get("nope")


def test_prior_entries_build_the_port_priors():
    for name in registries.PRIORS.names():
        kwargs = {"num_features": 4} if name in ("stroke",) else {}
        prior = registries.PRIORS.get(name)(**kwargs)
        assert hasattr(prior, "sample") and prior.num_features >= 1, name


def test_overrides_give_the_jax_tree():
    cfg, jcfg = config.ExperimentConfig(), jconfig.ExperimentConfig()
    config.apply_overrides(cfg, OVERRIDES)
    jconfig.apply_overrides(jcfg, OVERRIDES)
    assert _port_tree(cfg) == jconfig.to_dict(jcfg)
    assert cfg.train.fsdp is False and cfg.train.verbose is True and cfg.train.eval_pos_max is None
    assert cfg.criterion.kwargs["full_range"] == (-2.0, 2.0)
    for bad, error in (("train.nonexistent=1", AttributeError), ("train.lr", ValueError)):
        with pytest.raises(error):
            config.apply_overrides(cfg, [bad])
        with pytest.raises(error):
            jconfig.apply_overrides(jcfg, [bad])


def test_cli_arguments_give_the_jax_tree():
    argv = ["gp", "--loss_function", "adaptivebarnll", "--lr", "1e-4", "--epochs", "3", "--dropout", "0.1",
            "--aggregate_k_gradients", "2", "--set", "prior.kwargs.lengthscale=0.6", "--set", "mesh.enabled=True",
            "--checkpoint", "a", "--warm_start", "b"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    jcfg = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    assert _port_tree(cfg) == jconfig.to_dict(jcfg)
    assert cfg.train.device is None
    assert cli.config_from_args(cli.build_parser().parse_args(argv + ["--cpu"])).train.device == "cpu"
    port_flags = {a.dest for a in cli.build_parser()._actions}
    jax_flags = {a.dest for a in jcli.build_parser()._actions}
    assert port_flags == jax_flags


def test_yaml_round_trip(tmp_path):
    yaml = pytest.importorskip("yaml")
    cfg = config.ExperimentConfig()
    # YAML has no tuples: full_range would come back a list.
    config.apply_overrides(cfg, [o for o in OVERRIDES if "full_range" not in o] + ["train.dtype=bfloat16"])
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(config.to_dict(cfg)))
    loaded = config.from_yaml(str(path))
    assert config.to_dict(loaded) == config.to_dict(cfg)
    assert loaded.train.dtype is torch.bfloat16 and loaded.prior.name == "ridge"
    assert yaml.safe_load(path.read_text())["train"]["dtype"] == "bfloat16"
    with pytest.raises(KeyError, match="unknown config key"):
        config.from_dict({"train": {"nope": 1}})


def test_build_materializes_prior_criterion_and_modules():
    cfg = config.ExperimentConfig()
    config.apply_overrides(cfg, ["prior.kwargs.lengthscale=0.6", "criterion.kwargs.num_buckets=10",
                                 "encoder=normalized_uniform", "pos_encoder=sinus", "train.dtype=float32"])
    prior, criterion, train_cfg, mesh = config.build(cfg)
    assert prior.lengthscale == 0.6 and criterion.bar.num_bars == 10 and mesh is None
    assert train_cfg.encoder is registries.ENCODERS.get("normalized_uniform")
    assert train_cfg.pos_encoder is registries.POS_ENCODERS.get("sinus")
    assert train_cfg.dtype is torch.float32


def test_adaptive_criterion_estimates_borders_from_the_prior():
    cfg = config.ExperimentConfig()
    config.apply_overrides(cfg, ["criterion.name=adaptivefullsupportbarnll", "criterion.kwargs.num_buckets=8",
                                 "criterion.kwargs.y_sample_size=4000", "train.bptt=20"])
    _, criterion, _, _ = config.build(cfg)
    borders = criterion.bar.borders
    assert borders.shape == (9,) and bool((torch.diff(borders) > 0).all())


def test_ce_defaults_to_the_priors_classes_and_refuses_regression():
    assert registries.CRITERIONS.get("ce")(StrokePrior(num_features=16, num_outputs=5)).num_classes == 5
    with pytest.raises(ValueError, match="num_classes"):
        registries.CRITERIONS.get("ce")(registries.PRIORS.get("ridge")())


def test_mesh_raises_naming_its_item():
    """``mesh.enabled`` builds a mesh over the world's ranks (since ROADMAP.md
    queue 1 item 14; tests/test_torch_port_mesh_cli.py). Started here, the
    world's backend is NCCL, one card a rank: on the CPU it raises, naming
    the backend, and falls back to neither gloo nor the CPU."""
    cfg = config.ExperimentConfig()
    cfg.mesh.enabled = True
    cfg.train.device = "cpu"
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        config.build(cfg)
    assert not torch.distributed.is_initialized()


def test_cli_trains_saves_and_warm_starts_on_the_cpu(tmp_path, monkeypatch, capsys):
    ckpt = str(tmp_path / "ckpt")
    argv = ["ridge", "--loss_function", "mse", "--epochs", "1", "--lr", "1e-3", "--warmup_epochs", "0"] + TINY
    result = cli.main(argv + ["--checkpoint", ckpt])
    out = capsys.readouterr().out
    assert "final mean loss" in out and "saved checkpoint" in out
    assert len(result.epoch_stats) == 1 and np.isfinite(result.final_loss)
    saved = restore_checkpoint(ckpt)
    assert saved.keys() == result.model.state_dict().keys()
    for name, value in result.model.state_dict().items():
        assert torch.equal(saved[name], value), name

    seen = {}
    real_train = loop.train

    def recording_train(prior, criterion, cfg, mesh=None, init_params=None, **kw):
        seen["init"] = init_params
        return real_train(prior, criterion, cfg, mesh=mesh, init_params=init_params, **kw)

    monkeypatch.setattr(loop, "train", recording_train)
    again = cli.main(argv + ["--warm_start", ckpt])
    assert "warm-started params from" in capsys.readouterr().out
    assert seen["init"].keys() == saved.keys()
    assert all(torch.equal(seen["init"][k], saved[k]) for k in saved)
    assert np.isfinite(again.final_loss)


def test_cli_needs_the_card_without_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["ridge", "--loss_function", "mse", "--epochs", "1", "--steps_per_epoch", "1"])


def test_cli_resume_with_the_model_options_is_bitwise(tmp_path):
    """The chip run's option config (a normalized-uniform encoder, a learned
    table, SeqBN, dropout 0.1, the adaptive bar head) at a tiny width: 2
    epochs straight against 1 epoch then a resume, bitwise equal (the
    dropout masks come from the training generator, which the checkpoint
    saves)."""
    base = ["ridge", "--loss_function", "adaptivebarnll", "--set", "encoder=normalized_uniform", "--set",
            "pos_encoder=learned", "--set", "train.input_normalization=true", "--set", "train.dropout=0.1",
            "--set", "criterion.kwargs.y_sample_size=2000", "--warmup_epochs", "1", "--set", "train.verbose=false"]
    straight = cli.main(base + TINY + ["--epochs", "2"])
    resumable = base + TINY + ["--set", f"train.checkpoint_dir={tmp_path / 'ck'}", "--set", "train.checkpoint_every=1"]
    cli.main(resumable + ["--epochs", "1"])
    resumed = cli.main(resumable + ["--epochs", "2"])
    assert [s["epoch"] for s in resumed.epoch_stats] == [2]
    assert resumed.epoch_stats[0]["lr"] > 0
    assert resumed.final_loss == straight.final_loss
    for name, value in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], value), name


def test_python_m_help_runs_with_jax_blocked():
    code = ("import runpy, sys\nsys.modules['jax'] = None\nsys.modules['pfn_tpu'] = None\n"
            "sys.argv = ['pfn_tpu_torch.train', '--help']\n"
            "try:\n    runpy.run_module('pfn_tpu_torch.train', run_name='__main__', alter_sys=True)\n"
            "except SystemExit as e:\n    assert e.code == 0, e.code\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--warm_start" in proc.stdout and "--cpu" in proc.stdout
    proc = subprocess.run([sys.executable, "-m", "pfn_tpu_torch.train", "--help"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and "--loss_function" in proc.stdout, proc.stderr


@pytest.fixture
def only_seven():
    """A user-registered sampler putting all its weight on position 7,
    removed again afterwards."""
    name = "test_only_seven"
    registries.EVAL_POS_SAMPLERS.register(name, lambda max_len: np.eye(max_len, dtype=np.float32)[7])
    yield name
    registries.EVAL_POS_SAMPLERS._entries.pop(name)


def test_user_registered_sampler_changes_the_drawn_sep(only_seven):
    from pfn_tpu_torch.priors import RidgePrior
    from pfn_tpu_torch.train import TrainConfig, TrainState, build_model, mse_criterion

    prior, crit = RidgePrior(num_features=2), mse_criterion()

    def drawn_seps(sampler):
        cfg = TrainConfig(emsize=16, nhid=32, nlayers=1, nhead=2, bptt=12, batch_size=2, epochs=1, steps_per_epoch=4,
                          lr=1e-3, device="cpu", eval_pos_sampler=sampler, verbose=False)
        model = build_model(prior, crit, cfg)
        optimizer, _, schedule = loop._make_optimizer(cfg, model)
        state = TrainState(model, optimizer, torch.Generator().manual_seed(0))
        step = loop.make_train_step(prior, crit, cfg, schedule)
        return [int(step(state)["pos_cnt"].argmax()) for _ in range(6)]

    assert drawn_seps(only_seven) == [7] * 6
    assert drawn_seps("uniform") != [7] * 6
    cfg = dataclasses.replace(config.ExperimentConfig().train, eval_pos_sampler=only_seven, device="cpu",
                              emsize=16, nhid=32, nlayers=1, nhead=2, bptt=12, batch_size=2, epochs=1,
                              steps_per_epoch=2, lr=1e-3, verbose=False)
    result = loop.train(prior, crit, cfg)
    assert result.positional_losses[7] > 0 and not any(result.positional_losses[:7] + result.positional_losses[8:])
