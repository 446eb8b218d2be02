"""What the experiments share: the prior's hyperparameters, the scored
context sizes, the device flag, the bucket criterion, the model of a
checkpoint, and the measurement drivers' device sync and card line."""

from __future__ import annotations

import subprocess

import torch

from pfn_tpu_torch.device import require_cuda
from pfn_tpu_torch.distributions import get_bucket_limits
from pfn_tpu_torch.priors import sample_y_for_buckets
from pfn_tpu_torch.train import (
    TrainConfig,
    build_model,
    full_support_bar_criterion,
    latest_state_checkpoint,
    restore_checkpoint,
)

GP_HP = dict(noise=1e-4, outputscale=1.0, lengthscale=0.6)
# The context sizes the long-run scripts score (experiments/fig3a_longrun.py).
POSITIONS = [1, 2, 5, 10, 20, 50, 100, 200, 400, 700, 1000, 1400, 1800, 2000]
# The Fig-3a model (the notebook's grid point): emsize 512, 4 heads of 128,
# nhid 1024, 6 layers, bf16.
FIG3A_MODEL = dict(emsize=512, nhid=1024, nlayers=6, nhead=4)


def add_device_argument(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the current CUDA device, an error without a card; "
                             "'cpu' runs on the host)")


def resolve_device(name: str | None) -> torch.device:
    """``--device``: None is the current CUDA device, and raises without one."""
    return require_cuda() if name is None else torch.device(name)


def synchronize(device) -> None:
    """Wait for the work queued on a CUDA ``device`` (the host's work is done
    when a call returns). Every timed region of the measurement drivers ends
    in it, so the clock never stops on a queue."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(device) -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them for the
    first card; "cpu" for the host."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def bucket_criterion(prior, num_buckets: int, bptt: int, device, seed: int = 0, max_seq_len: int | None = None):
    """The full-support bar criterion on borders estimated from 100k prior ys
    (the notebook's cell 5), drawn from a generator on ``device`` seeded with
    ``seed``: the same borders at every invocation on one device."""
    ys = sample_y_for_buckets(prior, 100_000, bptt, seed=seed, max_seq_len=max_seq_len, device=device)
    return full_support_bar_criterion(get_bucket_limits(num_buckets, ys=ys)).to(device)


def restore_model(ck_dir: str, prior, criterion, bptt: int, device, model: dict):
    """The bf16 model of sizes ``model`` (FIG3A_MODEL) with the weights of
    the newest checkpoint under ``ck_dir``, in eval mode. Returns (model,
    checkpoint path)."""
    latest = latest_state_checkpoint(ck_dir)
    if latest is None:
        raise SystemExit(f"no checkpoint under {ck_dir}")
    cfg = TrainConfig(**model, bptt=bptt, dtype=torch.bfloat16, device=device)
    net = build_model(prior, criterion, cfg)
    net.load_state_dict(restore_checkpoint(latest[0], map_location=device)["model"], strict=True)
    return net.eval(), latest[0]
