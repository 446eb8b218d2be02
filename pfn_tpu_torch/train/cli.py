"""Command-line training: ``python -m pfn_tpu_torch.train``.

Port of ``pfn_tpu/train/cli.py``, with the same arguments: the prior as a
positional argument, ``--config`` (a YAML ExperimentConfig), ``--loss_function``,
dotted ``--set a.b=value`` overrides, ``--checkpoint``, ``--warm_start`` and
13 scalar flags; everything goes through ``pfn_tpu_torch.config`` and
``pfn_tpu_torch.registries``.

    python -m pfn_tpu_torch.train gp --loss_function barnll \\
        --set prior.kwargs.lengthscale=0.6 --set prior.kwargs.noise=1e-4 \\
        --set prior.kwargs.outputscale=1.0 --epochs 3 --steps_per_epoch 10

It trains on the CUDA card, and raises where there is none; ``--cpu`` trains
on the CPU (``TrainConfig.device = "cpu"``). ``--checkpoint PATH`` saves the
trained model's ``state_dict`` (``train.checkpoints.save_checkpoint``);
``--warm_start PATH`` loads one into ``train(init_params=...)``.
:func:`main` returns the ``TrainResult``, which is how scripts call it in
process.

On a device mesh, one process a rank under ``torchrun`` (N cards, NCCL):

    torchrun --nproc_per_node N -m pfn_tpu_torch.train gp ... \\
        --set mesh.enabled=true --set mesh.sp=2

``config.build`` starts the rank from torchrun's environment; only rank 0
prints and saves, and the process group ends with the run where ``main``
started it.
"""

from __future__ import annotations

import argparse

from pfn_tpu_torch import config as config_lib
from pfn_tpu_torch import registries

_SCALAR_FLAGS = [
    ("lr", float), ("epochs", int), ("batch_size", int), ("bptt", int), ("emsize", int), ("nhid", int),
    ("nlayers", int), ("nhead", int), ("dropout", float), ("steps_per_epoch", int), ("seed", int),
    ("aggregate_k_gradients", int), ("warmup_epochs", int),
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m pfn_tpu_torch.train",
                                description="Meta-train a PFN on a synthetic prior (PyTorch, CUDA).")
    p.add_argument("prior", nargs="?", default=None, choices=registries.PRIORS.names() + [None],
                   help="prior name (reference train.py:193-202)")
    p.add_argument("--config", default=None, help="YAML ExperimentConfig file")
    p.add_argument("--loss_function", default=None, choices=registries.CRITERIONS.names(),
                   help="criterion name (reference train.py:221-237)")
    p.add_argument("--set", dest="overrides", action="append", default=[], metavar="a.b=value",
                   help="dotted config override, e.g. train.lr=3e-4 or prior.kwargs.lengthscale=0.6")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (TrainConfig.device='cpu'); without it the run needs a CUDA card")
    p.add_argument("--checkpoint", default=None, help="save the trained model's state_dict here")
    p.add_argument("--warm_start", default=None,
                   help="checkpoint to initialize the model from (reference load_weights_from_this_state_dict, "
                        "train.py:25,46-47)")
    for flag, typ in _SCALAR_FLAGS:
        p.add_argument(f"--{flag}", type=typ, default=None)
    return p


def config_from_args(args) -> config_lib.ExperimentConfig:
    cfg = config_lib.from_yaml(args.config) if args.config else config_lib.ExperimentConfig()
    if args.prior is not None:
        cfg.prior.name = args.prior
    if args.loss_function is not None:
        cfg.criterion.name = args.loss_function
    for flag, _ in _SCALAR_FLAGS:
        v = getattr(args, flag)
        if v is not None:
            setattr(cfg.train, flag, v)
    config_lib.apply_overrides(cfg, args.overrides)
    if args.cpu:
        cfg.train.device = "cpu"
    if args.checkpoint is not None:
        cfg.checkpoint_path = args.checkpoint
    if args.warm_start is not None:
        cfg.warm_start_from = args.warm_start
    return cfg


def main(argv=None):
    """Parse ``argv``, train, save; returns the ``TrainResult``."""
    import torch.distributed as dist

    from pfn_tpu_torch.device import require_cuda
    from pfn_tpu_torch.train.checkpoints import restore_checkpoint, save_checkpoint
    from pfn_tpu_torch.train.loop import train

    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if cfg.train.device is None:
        require_cuda()  # before the prior and criterion are built: no CPU fallback
    owns_group = cfg.mesh.enabled and not dist.is_initialized()
    prior, criterion, train_cfg, mesh = config_lib.build(cfg)
    lead = mesh is None or mesh.rank == 0
    try:
        init_params = None
        if cfg.warm_start_from:
            init_params = restore_checkpoint(cfg.warm_start_from, map_location="cpu")
            if lead:
                print(f"warm-started params from {cfg.warm_start_from}")

        result = train(prior, criterion, train_cfg, mesh=mesh, init_params=init_params)
        if lead:
            print(f"final mean loss {result.final_loss:.5f}")
        if cfg.checkpoint_path and lead:
            save_checkpoint(cfg.checkpoint_path, {k: v.detach().cpu() for k, v in result.model.state_dict().items()})
            print(f"saved checkpoint to {cfg.checkpoint_path}")
    finally:
        if owns_group:
            dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
