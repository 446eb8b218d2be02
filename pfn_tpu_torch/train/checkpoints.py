"""Training-state checkpoints, and the weight bridge from the JAX package.

  * :func:`save_checkpoint` / :func:`restore_checkpoint`: one ``torch.save``
    file per checkpoint directory (``epoch_N/`` under a run's
    ``checkpoint_dir``). The train loop stores the model, the optimizer
    state, the step, the training generator's state and the epoch, so a
    resumed run continues the uninterrupted one exactly.
  * :func:`prune_state_checkpoints` / :func:`latest_state_checkpoint`:
    retention and discovery of ``epoch_N`` directories, as in the JAX
    package.
  * :func:`state_dict_from_flax_params` repeats the mapping and transposes of
    ``pfn_tpu.train.checkpoints.export_torch_state_dict`` without importing
    jax: it takes the flax params tree as nested dicts of numpy arrays and
    returns the port's ``state_dict``, under the reference's torch names, so
    that a ``PFNTransformer`` loaded from it with ``strict=True`` computes
    what the JAX model computes.
"""

from __future__ import annotations

import os
import shutil
from typing import Any

import numpy as np
import torch

_STATE_FILE = "state.pt"


def save_checkpoint(path: str, state: Any) -> None:
    """Write ``state`` (nested dicts of tensors and Python scalars) into the
    directory ``path``, replacing an earlier checkpoint there atomically."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, _STATE_FILE)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, target)


def restore_checkpoint(path: str, map_location=None) -> Any:
    """Read what :func:`save_checkpoint` wrote into ``path``. Only tensors,
    containers and scalars are unpickled (``weights_only``)."""
    return torch.load(os.path.join(path, _STATE_FILE), map_location=map_location, weights_only=True)


def _epoch_dirs(checkpoint_dir: str) -> list[tuple[int, str]]:
    """(epoch, name) of every ``epoch_N`` entry under ``checkpoint_dir``."""
    found = []
    for name in os.listdir(checkpoint_dir):
        if name.startswith("epoch_"):
            try:
                found.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue
    return sorted(found)


def prune_state_checkpoints(checkpoint_dir: str, keep: int) -> None:
    """Delete all but the newest ``keep`` epoch_N checkpoints."""
    for _, name in _epoch_dirs(checkpoint_dir)[:-keep]:
        shutil.rmtree(os.path.join(checkpoint_dir, name), ignore_errors=True)


def latest_state_checkpoint(checkpoint_dir: str):
    """(path, epoch) of the newest ``epoch_N`` checkpoint under
    ``checkpoint_dir``, or None."""
    if not os.path.isdir(checkpoint_dir):
        return None
    found = _epoch_dirs(checkpoint_dir)
    if not found:
        return None
    epoch, name = found[-1]
    return os.path.join(checkpoint_dir, name), epoch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _dense(sd: dict, name: str, p: dict) -> None:
    sd[name + ".weight"] = _tensor(np.asarray(p["kernel"]).T)
    sd[name + ".bias"] = _tensor(p["bias"])


def state_dict_from_flax_params(params: dict, nlayers: int) -> dict:
    """Map a ``PFNTransformer`` flax params tree ({"params": {...}} or the
    inner dict) of numpy arrays to the port's state_dict of f32 tensors."""
    p = params.get("params", params)
    sd: dict = {}
    _dense(sd, "encoder", p["encoder"]["linear"])
    _dense(sd, "y_encoder", p["y_encoder"]["linear"])
    for i in range(nlayers):
        L = p[f"layer_{i}"]
        pre = f"transformer_encoder.layers.{i}."
        sd[pre + "self_attn.in_proj_weight"] = _tensor(np.asarray(L["self_attn"]["qkv"]["kernel"]).T)
        sd[pre + "self_attn.in_proj_bias"] = _tensor(L["self_attn"]["qkv"]["bias"])
        _dense(sd, pre + "self_attn.out_proj", L["self_attn"]["out_proj"])
        _dense(sd, pre + "linear1", L["linear1"])
        _dense(sd, pre + "linear2", L["linear2"])
        for norm in ("norm1", "norm2"):
            sd[pre + norm + ".weight"] = _tensor(L[norm]["scale"])
            sd[pre + norm + ".bias"] = _tensor(L[norm]["bias"])
    _dense(sd, "decoder.0", p["decoder"]["fc1"])
    _dense(sd, "decoder.2", p["decoder"]["fc2"])
    return sd


def seeded_flax_params(num_features: int, emsize: int, nhid: int, nlayers: int, n_out: int, seed: int = 0) -> dict:
    """A params tree in the JAX package's layout, every entry drawn from a
    numpy generator seeded with ``seed``: kernels N(0, 1/fan_in), biases
    N(0, 0.1^2), LayerNorm scales 1 + N(0, 0.1^2). Unlike a fresh init,
    out_proj and linear2 are nonzero, so attention reaches the output. For
    parity tests and smoke runs with random weights."""
    rng = np.random.default_rng(seed)

    def dense(fan_in: int, fan_out: int) -> dict:
        return {
            "kernel": (rng.standard_normal((fan_in, fan_out)) / np.sqrt(fan_in)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(fan_out)).astype(np.float32),
        }

    def norm() -> dict:
        return {
            "scale": (1.0 + 0.1 * rng.standard_normal(emsize)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(emsize)).astype(np.float32),
        }

    p: dict = {"encoder": {"linear": dense(num_features, emsize)}, "y_encoder": {"linear": dense(1, emsize)}}
    for i in range(nlayers):
        p[f"layer_{i}"] = {
            "self_attn": {"qkv": dense(emsize, 3 * emsize), "out_proj": dense(emsize, emsize)},
            "linear1": dense(emsize, nhid),
            "linear2": dense(nhid, emsize),
            "norm1": norm(),
            "norm2": norm(),
        }
    p["decoder"] = {"fc1": dense(emsize, nhid), "fc2": dense(nhid, n_out)}
    return {"params": p}
