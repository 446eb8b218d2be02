"""The system under test, built from a configuration: the port's prior,
criterion and PFN, holding the benchmark's weights."""

from __future__ import annotations

import torch

from pfnbench import spec

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def n_out(cfg: dict) -> int:
    """The head's width, as the configuration's criterion sets it."""
    return spec.program_criterion(cfg["criterion"]["kind"]).n_out(cfg["criterion"])


def build(cfg: dict, device, weights: dict, borders, **train):
    """(prior, criterion, TrainConfig, model) of configuration ``cfg``;
    ``train`` holds the TrainConfig fields of the cell (batch, microbatches)."""
    from pfn_tpu_torch.train import TrainConfig, build_model

    m = cfg["model"]
    prior = spec.program_prior(cfg["prior"]["kind"]).program(cfg["prior"])
    criterion = spec.program_criterion(cfg["criterion"]["kind"]).program(borders).to(device)
    t = cfg["train"]
    tcfg = TrainConfig(emsize=m["emsize"], nhid=m["nhid"], nlayers=m["nlayers"], nhead=m["nhead"],
                       dtype=DTYPES[m["dtype"]], bptt=t["bptt"], lr=t["lr"], eval_pos_sampler=t["eval_pos_sampler"],
                       eval_pos_max=t.get("eval_pos_max"), device=device, verbose=False, **train)
    with torch.device(device):
        model = build_model(prior, criterion, tcfg)
    model.load_state_dict(weights, strict=True)
    return prior, criterion, tcfg, model


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
