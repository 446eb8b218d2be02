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
    returns the port's ``state_dict``, under the reference's torch names (and
    the flax tree's names for the options the reference never exported), so
    that a ``PFNTransformer`` loaded from it with ``strict=True`` computes
    what the JAX model computes, with any encoder, SeqBN, positional
    encoding and head that the JAX model builds, and MoE layers.
    :func:`state_dict_from_flax_pipeline_params` does the same for one stage
    of a JAX ``PipelinedPFN``'s params.
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


def _encoder(sd: dict, name: str, p: dict) -> None:
    """The x- or y-encoder's entries, by the flax tree's layout: LinearEncoder
    (``linear``), NormalizedUniformEncoder (``inner/linear``), MLPEncoder
    (``fc1``, ``fc2``), CanonicalEmbedding (``embedding``) or
    EmbeddingEncoder (``emb/embedding``)."""
    if "linear" in p:
        _dense(sd, name, p["linear"])
    elif "inner" in p:
        _dense(sd, name + ".inner", p["inner"]["linear"])
    elif "fc1" in p:
        _dense(sd, name + ".fc1", p["fc1"])
        _dense(sd, name + ".fc2", p["fc2"])
    elif "embedding" in p:
        sd[name + ".embedding"] = _tensor(p["embedding"])
    elif "emb" in p:
        sd[name + ".emb.embedding"] = _tensor(p["emb"]["embedding"])
    else:
        raise KeyError(f"unknown encoder layout under {name!r}: {sorted(p)}")


def _decoder(sd: dict, p: dict) -> None:
    """The head's entries: FixedScaledDecoder (``fc1``, ``fc2``, ``T``),
    ScaledDecoder (``linear``, ``linear1``, ``linear2``) or the default
    MLPDecoder (``fc1``, ``fc2`` as ``decoder.0``, ``decoder.2``)."""
    if "T" in p:
        _dense(sd, "decoder.fc1", p["fc1"])
        _dense(sd, "decoder.fc2", p["fc2"])
        sd["decoder.T"] = _tensor(p["T"])
    elif "linear" in p:
        for name in ("linear", "linear1", "linear2"):
            _dense(sd, "decoder." + name, p[name])
    else:
        _dense(sd, "decoder.0", p["fc1"])
        _dense(sd, "decoder.2", p["fc2"])


def _layer(sd: dict, pre: str, L: dict) -> None:
    """One encoder layer's entries under ``pre``. An MoE layer's FFN
    (``moe``) maps to ``moe.router.weight`` / ``.bias`` (the router's Dense,
    transposed) and ``moe.w1``, ``moe.b1``, ``moe.w2``, ``moe.b2`` as they
    are ((E, D, nhid), (E, nhid), (E, nhid, D), (E, D): the port keeps the
    JAX layout for the batched experts)."""
    sd[pre + "self_attn.in_proj_weight"] = _tensor(np.asarray(L["self_attn"]["qkv"]["kernel"]).T)
    sd[pre + "self_attn.in_proj_bias"] = _tensor(L["self_attn"]["qkv"]["bias"])
    _dense(sd, pre + "self_attn.out_proj", L["self_attn"]["out_proj"])
    if "moe" in L:
        _dense(sd, pre + "moe.router", L["moe"]["router"])
        for name in ("w1", "b1", "w2", "b2"):
            sd[pre + "moe." + name] = _tensor(L["moe"][name])
    else:
        _dense(sd, pre + "linear1", L["linear1"])
        _dense(sd, pre + "linear2", L["linear2"])
    for norm in ("norm1", "norm2"):
        sd[pre + norm + ".weight"] = _tensor(L[norm]["scale"])
        sd[pre + norm + ".bias"] = _tensor(L[norm]["bias"])


def _embed(sd: dict, pre: str, p: dict) -> None:
    _encoder(sd, pre + "encoder", p["encoder"])
    _encoder(sd, pre + "y_encoder", p["y_encoder"])
    if "pos_encoder" in p:
        sd[pre + "pos_encoder.pos_embedding"] = _tensor(p["pos_encoder"]["pos_embedding"])


def state_dict_from_flax_params(params: dict, nlayers: int) -> dict:
    """Map a ``PFNTransformer`` flax params tree ({"params": {...}} or the
    inner dict) of numpy arrays to the port's state_dict of f32 tensors,
    with every option's parameters: the encoders' layouts (:func:`_encoder`),
    ``input_ln`` (SeqBN: scale, bias -> weight, bias), ``pos_encoder``'s
    table, MoE layers (:func:`_layer`) and the scaled heads
    (:func:`_decoder`)."""
    p = params.get("params", params)
    sd: dict = {}
    _embed(sd, "", p)
    if "input_ln" in p:
        sd["input_ln.weight"] = _tensor(p["input_ln"]["scale"])
        sd["input_ln.bias"] = _tensor(p["input_ln"]["bias"])
    for i in range(nlayers):
        _layer(sd, f"transformer_encoder.layers.{i}.", p[f"layer_{i}"])
    _decoder(sd, p["decoder"])
    return sd


def state_dict_from_flax_pipeline_params(params: dict, layers_per_stage: int, stage: int) -> dict:
    """Map a JAX ``PipelinedPFN``'s params ({"embed", "stages", "decoder"},
    each {"params": ...}, every stage leaf with a leading stage axis) to the
    state_dict of the port's ``PipelinedPFN`` on stage ``stage``:
    ``embed.encoder``, ``embed.y_encoder``, ``embed.pos_encoder``,
    ``stage.layer_{i}.*`` (that stage's slice) and ``decoder.*``."""
    sd: dict = {}
    _embed(sd, "embed.", params["embed"]["params"])
    stages = params["stages"]["params"]
    for i in range(layers_per_stage):
        layer = _index_tree(stages[f"layer_{i}"], stage)
        _layer(sd, f"stage.layer_{i}.", layer)
    _decoder(sd, params["decoder"]["params"])
    return sd


def _index_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def seeded_flax_params(num_features: int, emsize: int, nhid: int, nlayers: int, n_out: int, seed: int = 0,
                       encoder: str = "linear", y_encoder: str = "linear", input_normalization: bool = False,
                       pos_encoder: str | None = None, max_len: int = 0, decoder: str = "mlp",
                       num_classes: int = 2, num_embs: int = 100, num_experts: int = 0) -> dict:
    """A params tree in the JAX package's layout, every entry drawn from a
    numpy generator seeded with ``seed``: kernels N(0, 1/fan_in), biases
    N(0, 0.1^2), LayerNorm scales 1 + N(0, 0.1^2). Unlike a fresh init,
    out_proj and linear2 are nonzero, so attention reaches the output. For
    parity tests and smoke runs with random weights.

    Opt-in options, by their registry names (each drawn after the default
    tree, so the default tree's draws do not change): ``encoder`` and
    ``y_encoder`` in linear / normalized_uniform / mlp / canonical
    (``num_classes`` rows) / embedding (``num_embs`` bins);
    ``input_normalization`` (SeqBN scale and bias, as the LayerNorms);
    ``pos_encoder`` learned or paired_scrambled_learned (a (max_len, emsize)
    table of N(0, 1/emsize)); ``decoder`` mlp / scaled / fixed_scaled (T 1 +
    N(0, 0.1^2)); ``num_experts`` > 0: every layer's FFN becomes an MoE
    (``moe``: the router a dense of N(0, 1/fan_in), w1 and w2 N(0, 1/fan_in)
    per expert, b1 and b2 N(0, 0.1^2)) in place of linear1 and linear2."""
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

    def embedding(rows: int, features: int) -> np.ndarray:
        return rng.standard_normal((rows, features, emsize // features)).astype(np.float32)

    def encoder_tree(kind: str, fan_in: int) -> dict:
        if kind == "normalized_uniform":
            return {"inner": {"linear": dense(fan_in, emsize)}}
        if kind == "mlp":
            return {"fc1": dense(fan_in, emsize), "fc2": dense(emsize, emsize)}
        if kind == "canonical":
            return {"embedding": embedding(num_classes, fan_in)}
        if kind == "embedding":
            return {"emb": {"embedding": embedding(num_embs, fan_in)}}
        raise ValueError(f"unknown encoder {kind!r}")

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
    if encoder != "linear":
        p["encoder"] = encoder_tree(encoder, num_features)
    if y_encoder != "linear":
        p["y_encoder"] = encoder_tree(y_encoder, 1)
    if input_normalization:
        p["input_ln"] = norm()
    if pos_encoder in ("learned", "paired_scrambled_learned"):
        p["pos_encoder"] = {"pos_embedding": (rng.standard_normal((max_len, emsize)) / np.sqrt(emsize))
                            .astype(np.float32)}
    elif pos_encoder not in (None, "none", "sinus"):
        raise ValueError(f"unknown positional encoding {pos_encoder!r}")
    if decoder == "scaled":
        p["decoder"] = {"linear": dense(emsize, nhid), "linear1": dense(nhid, n_out), "linear2": dense(nhid, 10)}
    elif decoder == "fixed_scaled":
        p["decoder"] = {"fc1": dense(emsize, nhid), "fc2": dense(nhid, n_out),
                        "T": np.float32(1.0 + 0.1 * rng.standard_normal())}
    elif decoder != "mlp":
        raise ValueError(f"unknown decoder {decoder!r}")
    for i in range(nlayers if num_experts > 0 else 0):
        L = p[f"layer_{i}"]
        del L["linear1"], L["linear2"]
        L["moe"] = {
            "router": dense(emsize, num_experts),
            "w1": (rng.standard_normal((num_experts, emsize, nhid)) / np.sqrt(emsize)).astype(np.float32),
            "b1": (0.1 * rng.standard_normal((num_experts, nhid))).astype(np.float32),
            "w2": (rng.standard_normal((num_experts, nhid, emsize)) / np.sqrt(nhid)).astype(np.float32),
            "b2": (0.1 * rng.standard_normal((num_experts, emsize))).astype(np.float32),
        }
    return {"params": p}
