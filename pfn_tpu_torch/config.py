"""One typed experiment-config tree.

Port of ``pfn_tpu/config.py``. An :class:`ExperimentConfig` is a dataclass
tree (prior, criterion, the port's ``TrainConfig``, mesh, module names) that
loads from YAML, takes dotted ``a.b=value`` overrides (values through
``ast.literal_eval``, never ``eval``; lowercase true/false/none/null first),
and builds into (prior, criterion, train_cfg, mesh) through
``pfn_tpu_torch.registries``.

Two differences from the JAX module, both about torch: ``train.dtype`` is a
``torch.dtype``, rendered by name in :func:`to_dict` ("float32") and read
back from a name by :func:`from_dict` and :func:`build`; and the mesh is a
world of processes, one a rank: with ``mesh.enabled`` :func:`build` starts
this process's rank (``parallel.init_distributed``, from ``torchrun``'s
environment, or a world of one, on NCCL) unless the caller has started it
(gloo, where ranks share a card or run on the CPU).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any

import torch

from pfn_tpu_torch.train.loop import TrainConfig


@dataclasses.dataclass
class PriorConfig:
    name: str = "gp"
    kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CriterionConfig:
    name: str = "barnll"
    kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MeshConfig:
    """dp=None means "all remaining ranks"; enabled=False disables the
    mesh. sp/ep are the sequence- and expert-parallel axes."""

    dp: int | None = None
    tp: int = 1
    sp: int = 1
    ep: int = 1
    enabled: bool = False


@dataclasses.dataclass
class ExperimentConfig:
    prior: PriorConfig = dataclasses.field(default_factory=PriorConfig)
    criterion: CriterionConfig = dataclasses.field(default_factory=CriterionConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    encoder: str | None = None  # registry names; None = the model's default
    y_encoder: str | None = None
    pos_encoder: str | None = None
    checkpoint_path: str | None = None
    warm_start_from: str | None = None  # reference load_weights_from_this_state_dict


def _parse_value(text: str) -> Any:
    """An override's value: a literal if it parses, else the raw string.
    Lowercase booleans and null come first, so ``train.fsdp=false`` is False
    and not the truthy string 'false'."""
    lowered = text.strip().lower()
    if lowered in ("true", "false"):
        return lowered == "true"
    if lowered in ("none", "null"):
        return None
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def apply_overrides(cfg: ExperimentConfig, overrides: list[str]) -> ExperimentConfig:
    """Apply dotted ``section.field=value`` overrides in place.
    ``prior.kwargs.<k>=v`` and ``criterion.kwargs.<k>=v`` address the open
    kwargs dicts (the reference's ``--extra_prior_kwargs``)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} is not of the form a.b=value")
        path, _, raw = ov.partition("=")
        value = _parse_value(raw)
        parts = path.split(".")
        obj: Any = cfg
        for p in parts[:-1]:
            obj = obj[p] if isinstance(obj, dict) else getattr(obj, p)
        last = parts[-1]
        if isinstance(obj, dict):
            obj[last] = value
        else:
            if not hasattr(obj, last):
                raise AttributeError(f"{type(obj).__name__} has no field {last!r} (override {ov!r})")
            setattr(obj, last, value)
    return cfg


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from itself or its name ("float32", "torch.bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    found = getattr(torch, str(dtype).removeprefix("torch."), None)
    if not isinstance(found, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return found


_SECTIONS = {"PriorConfig": PriorConfig, "CriterionConfig": CriterionConfig, "MeshConfig": MeshConfig,
             "TrainConfig": TrainConfig}


def _dataclass_from_dict(cls, data: dict):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in fields:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        ftype = fields[k].type
        sub = _SECTIONS.get(ftype.split("|")[0].strip()) if isinstance(ftype, str) else None
        if isinstance(v, dict) and sub is not None:
            kwargs[k] = _dataclass_from_dict(sub, v)
        elif cls is TrainConfig and k == "dtype":
            kwargs[k] = _torch_dtype(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def from_dict(data: dict) -> ExperimentConfig:
    return _dataclass_from_dict(ExperimentConfig, data or {})


def from_yaml(path: str) -> ExperimentConfig:
    """Load an ExperimentConfig from a YAML file (reference --config,
    train.py:146-151). PyYAML is imported here, not at import time."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return from_dict(data)


def to_dict(cfg: ExperimentConfig) -> dict:
    """The tree as plain data: the module factories dropped, the dtype by
    name."""
    d = dataclasses.asdict(cfg)
    t = d["train"]
    for k in ("encoder", "y_encoder", "pos_encoder", "decoder"):
        t.pop(k, None)
    t["dtype"] = str(_torch_dtype(cfg.train.dtype)).removeprefix("torch.")
    if isinstance(t.get("device"), torch.device):
        t["device"] = str(t["device"])
    return d


def build(cfg: ExperimentConfig):
    """Materialize (prior, criterion, train_cfg, mesh) from the config tree.
    With ``mesh.enabled`` the mesh spans the world's ranks, dp taking the
    ranks the other axes leave unless set; the process group is started here
    where the caller has not (``parallel.init_distributed``: NCCL on
    ``train.device``, None the card)."""
    import torch.distributed as dist

    from pfn_tpu_torch import registries
    from pfn_tpu_torch.parallel import init_distributed, make_mesh

    mesh = None
    if cfg.mesh.enabled:
        m = cfg.mesh
        if dist.is_initialized():
            device = cfg.train.device
        else:
            device = init_distributed(device=cfg.train.device)
        denom = m.tp * m.sp * m.ep
        dp = m.dp or max(1, dist.get_world_size() // denom)
        mesh = make_mesh(dp=dp, tp=m.tp, sp=m.sp, ep=m.ep, device=device)
    prior = registries.PRIORS.get(cfg.prior.name)(**cfg.prior.kwargs)
    crit_kwargs = dict(cfg.criterion.kwargs)
    crit_kwargs.setdefault("seq_len", cfg.train.bptt)
    criterion = registries.CRITERIONS.get(cfg.criterion.name)(prior, **crit_kwargs)
    train_cfg = cfg.train
    train_cfg.dtype = _torch_dtype(train_cfg.dtype)
    if cfg.encoder is not None:
        train_cfg.encoder = registries.ENCODERS.get(cfg.encoder)
    if cfg.y_encoder is not None:
        train_cfg.y_encoder = registries.ENCODERS.get(cfg.y_encoder)
    if cfg.pos_encoder is not None:
        train_cfg.pos_encoder = registries.POS_ENCODERS.get(cfg.pos_encoder)
    return prior, criterion, train_cfg, mesh
