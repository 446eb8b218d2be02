"""The device mesh and its sharding rules.

Port of ``pfn_tpu/parallel/mesh.py`` onto ``torch.distributed``: one process
a rank, and a process group for each axis of the mesh, ``("dp", "sp", "tp",
"ep")`` with size-1 axes always present (rank = ((dp·sp + sp)·tp + tp)·ep +
ep, the JAX device array's row-major order):
  * ``dp``: the batch of datasets is split over it; gradients are summed
    over it; with ``fsdp`` the parameters and the Adam state are split over
    it too and gathered at use (ZeRO-3).
  * ``tp``: the attention's heads and the FFN's hidden units are split over
    it (Megatron: the block's output is all-reduced).
  * ``sp``: the token stream is split over the sequence between attention
    blocks; attention gathers K and V over it.
  * ``ep``: the MoE layers' experts are split over it.

Where the JAX package places arrays with ``NamedSharding``\\s, the port takes
slices: a sharding is a spec, one mesh axis name (or None) per dimension, and
:func:`shard` gives a rank's slice of a global tensor. A model on a mesh holds
the slices of its parameters (``PFNTransformer.param_specs`` says which);
:func:`gathered_state_dict` and :func:`load_full_state_dict_` move between
them and the one-device state, which checkpoints hold.

Backend: NCCL on CUDA, one card a rank. Gloo only where the caller names it:
the CPU tests, and ranks that share one card. More ranks than cards without a
backend named raises; nothing picks gloo or the CPU on its own.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os

import torch
import torch.distributed as dist

from pfn_tpu_torch.device import require_cuda
from pfn_tpu_torch.parallel.collectives import DATA_AXES, all_gather, gather_list, join, split, sum_over


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a mesh of ranks: the axes and their sizes
    (``shape``), its index on each (``coords``), the process group of the
    ranks that differ from it on one axis only (``groups``, for the axes of
    size > 1), and the device its tensors live on."""

    shape: dict
    coords: dict
    groups: dict
    device: torch.device

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    @property
    def rank(self) -> int:
        return dist.get_rank()


def init_distributed(backend: str | None = None, device=None, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None) -> torch.device:
    """Start this process's rank of the world and return its device.

    ``world_size``, ``rank`` and ``init_method`` default to what
    ``torchrun`` puts in the environment (``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR``); a world of one without them needs
    none. ``backend`` None is NCCL on the card ``LOCAL_RANK``, and raises
    where ``device`` is not CUDA or the host has fewer cards than ranks.
    ``"gloo"``: ranks on the CPU (``device="cpu"``) or sharing the cards
    round robin. ``device`` None is the card (raises without one)."""
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    device = require_cuda() if device is None else torch.device(device)
    if backend is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        if device.type != "cuda":
            raise ValueError(f"NCCL needs CUDA tensors, not {device.type}: name backend='gloo' to run ranks there")
        if local_world > torch.cuda.device_count():
            raise RuntimeError(f"{local_world} ranks on this host and {torch.cuda.device_count()} CUDA cards: NCCL "
                               "takes one card a rank; name backend='gloo' for ranks that share a card")
        backend = "nccl"
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}: None (NCCL) or 'gloo'")
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if init_method is None and world_size == 1 and "MASTER_ADDR" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank)
    return device


def _build(sizes: dict, device) -> Mesh:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the process group: call parallel.init_distributed first")
    names, dims = tuple(sizes), tuple(sizes.values())
    world = dist.get_world_size()
    if math.prod(dims) != world:
        raise ValueError(f"{'*'.join(names)}={math.prod(dims)} != world size {world}")
    rank = dist.get_rank()
    coords = dict(zip(names, _unravel(rank, dims)))
    groups = {}
    for a, axis in enumerate(names):
        if dims[a] == 1:
            continue
        others = [range(d) if b != a else [0] for b, d in enumerate(dims)]
        for base in itertools.product(*others):  # every rank builds every group, in one order
            ranks = [_ravel(base[:a] + (i,) + base[a + 1:], dims) for i in range(dims[a])]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    device = require_cuda() if device is None else torch.device(device)
    return Mesh(shape=dict(sizes), coords=coords, groups=groups, device=device)


def _unravel(rank: int, dims) -> tuple:
    out = []
    for d in reversed(dims):
        out.append(rank % d)
        rank //= d
    return tuple(reversed(out))


def _ravel(coords, dims) -> int:
    rank = 0
    for c, d in zip(coords, dims):
        rank = rank * d + c
    return rank


def make_mesh(dp: int | None = None, tp: int = 1, sp: int = 1, ep: int = 1, device=None) -> Mesh:
    """A ``("dp", "sp", "tp", "ep")`` mesh over the world's ranks; dp None
    takes the ranks left. ``device``: this rank's (None: its card)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None:
        if world % (tp * sp * ep):
            raise ValueError(f"world size {world} does not divide over tp*sp*ep={tp * sp * ep}")
        dp = world // (tp * sp * ep)
    return _build({"dp": dp, "sp": sp, "tp": tp, "ep": ep}, device)


def make_pp_mesh(dp: int = 1, pp: int = 1, device=None) -> Mesh:
    """A ``("dp", "pp")`` mesh for the pipeline (``parallel.pipeline``)."""
    return _build({"dp": dp, "pp": pp}, device)


def batch_sharding(mesh: Mesh) -> tuple:
    """(B, T, ...) arrays: batch over dp, sequence over sp."""
    return ("dp", "sp") if mesh.axis_size("sp") > 1 else ("dp",)


def token_sharding(mesh: Mesh) -> tuple | None:
    """The (B, T, D) token stream's spec, or None without a sequence axis."""
    return ("dp", "sp", None) if mesh.axis_size("sp") > 1 else None


def expert_sharding(mesh: Mesh) -> tuple | None:
    """The MoE dispatched tensor (B, E, C, D): experts over ep, or None."""
    return ("dp", "ep", None, None) if mesh.axis_size("ep") > 1 else None


def replicate(mesh: Mesh) -> tuple:
    return ()


def shard(x: torch.Tensor, mesh: Mesh, spec, blocks: int = 1) -> torch.Tensor:
    """This rank's slice of the global tensor ``x`` under ``spec``; dim 0
    may be made of ``blocks`` blocks, each split on its own."""
    for dim, axis in enumerate(spec or ()):
        if axis is not None and mesh.axis_size(axis) > 1:
            x = split(x, dim, mesh.axis_size(axis), mesh.axis_index(axis), blocks if dim == 0 else 1)
    return x


def unshard(x: torch.Tensor, mesh: Mesh, spec, blocks: int = 1) -> torch.Tensor:
    """The global tensor from every rank's :func:`shard` (no autograd)."""
    for dim, axis in reversed(list(enumerate(spec or ()))):
        if axis is not None and mesh.axis_size(axis) > 1:
            x = join(gather_list(x, mesh, axis), dim, blocks if dim == 0 else 1)
    return x


# Name rules of the JAX package's ``_spec_for``, on the port's state_dict
# names (torch layout: a weight is (out, in), so the JAX kernel's spec
# reversed): column-sharded over tp (qkv, linear1, the decoder's and the MLP
# encoder's fc1; the default decoder's first linear is ``decoder.0``),
# row-sharded (out_proj, linear2, fc2, ``decoder.2``); the MoE experts' w1,
# b1, w2, b2 over ep; with fsdp, the larger dim of every other weight over dp.
_COL_SHARDED = ("in_proj", "linear1", "fc1", "decoder.0.")
_ROW_SHARDED = ("out_proj", "linear2", "fc2", "decoder.2.")
_EXPERT = ("w1", "w2", "b1", "b2")


def blocks_of(name: str) -> int:
    """in_proj's rows are q, k and v, each split over tp head by head."""
    return 3 if "in_proj" in name else 1


def _spec_for(name: str, shape, fsdp: bool) -> tuple:
    leaf = name.rsplit(".", 1)[-1]
    is_kernel = leaf.endswith("weight") and len(shape) >= 2
    is_bias = leaf.endswith("bias")
    dp = "dp" if fsdp else None
    if ".moe." in f".{name}" and leaf in _EXPERT:
        return ("ep",) + (None,) * (len(shape) - 1)
    for tag in _COL_SHARDED:
        if tag in name:
            if is_kernel:
                return ("tp", dp)
            if is_bias:
                return ("tp",)
    for tag in _ROW_SHARDED:
        if tag in name and is_kernel:
            return (dp, "tp")
    if fsdp and is_kernel:
        # JAX's argmax over its (in, out) kernel shape, mapped to torch's (out, in).
        jax_axis = max(range(len(shape)), key=lambda a: (shape[::-1][a], -a))
        spec = [None] * len(shape)
        spec[len(shape) - 1 - jax_axis] = "dp"
        return tuple(spec)
    return ()


def param_sharding(params, mesh: Mesh, fsdp: bool = False) -> dict:
    """{name: spec} for a model's parameters (a module or a {name: tensor}
    dict): the name rules above, and a dim that does not divide its axis
    stays whole."""
    named = params.named_parameters() if isinstance(params, torch.nn.Module) else params.items()
    specs = {}
    for name, value in named:
        spec = _spec_for(name, tuple(value.shape), fsdp)
        specs[name] = tuple(a if a is not None and value.shape[d] % (mesh.axis_size(a) * (blocks_of(name) if d == 0
                                                                                           else 1)) == 0 else None
                            for d, a in enumerate(spec))
    return specs


def sharded_axes(spec) -> tuple:
    return tuple(a for a in spec or () if a is not None)


def shard_module_(model: torch.nn.Module, mesh: Mesh, fsdp: bool = False) -> torch.nn.Module:
    """Replace each parameter of ``model`` by this rank's slice of it under
    :func:`param_sharding` and record the specs in ``model.param_specs``."""
    specs = param_sharding(model, mesh, fsdp)
    for name, p in model.named_parameters():
        p.data = shard(p.data, mesh, specs[name], blocks_of(name)).contiguous()
    model.param_specs = {n: s for n, s in specs.items() if any(a and mesh.axis_size(a) > 1 for a in s)}
    return model


def gathered_state_dict(model: torch.nn.Module) -> dict:
    """The one-device state_dict of a model sharded by :func:`shard_module_`
    (every rank takes part)."""
    specs = getattr(model, "param_specs", {})
    mesh = model.config.mesh
    return {n: (unshard(t, mesh, specs[n], blocks_of(n)) if n in specs else t) for n, t in model.state_dict().items()}


def load_full_state_dict_(model: torch.nn.Module, state_dict: dict) -> None:
    """Load a one-device state_dict into a sharded model (each rank its
    slices), or into an unsharded one as it is."""
    specs = getattr(model, "param_specs", {})
    mesh = model.config.mesh
    model.load_state_dict({n: (shard(t, mesh, specs[n], blocks_of(n)) if n in specs else t)
                           for n, t in state_dict.items()}, strict=True)


def _map_optimizer_state(model: torch.nn.Module, state: dict, fn) -> dict:
    """``state`` (an optimizer's state_dict) with ``fn(tensor, spec,
    blocks)`` applied to each sharded parameter's state tensors."""
    specs = getattr(model, "param_specs", {})
    names = [n for n, _ in model.named_parameters()]
    return {**state, "state": {i: {k: (fn(v, specs[names[i]], blocks_of(names[i]))
                                       if names[i] in specs and torch.is_tensor(v) and v.dim() else v)
                                   for k, v in s.items()} for i, s in state["state"].items()}}


def gathered_optimizer_state(model: torch.nn.Module, optimizer) -> dict:
    """``optimizer.state_dict()`` with each parameter's state tensors (Adam's
    moments) gathered as the parameter is."""
    mesh = model.config.mesh
    return _map_optimizer_state(model, optimizer.state_dict(), lambda v, spec, b: unshard(v, mesh, spec, b))


def load_full_optimizer_state_(model: torch.nn.Module, optimizer, state: dict) -> None:
    """Load a one-device optimizer state_dict: each rank its slices."""
    mesh = model.config.mesh
    optimizer.load_state_dict(_map_optimizer_state(model, state,
                                                   lambda v, spec, b: shard(v, mesh, spec, b).contiguous()))


def gather_at_use(name: str, p: torch.Tensor, mesh: Mesh, spec, keep_local=()) -> torch.Tensor:
    """The tensor a forward computes with: the fsdp slice gathered over dp
    (its backward sums the gradient over dp), and a model-axis slice
    gathered too unless the axis is in ``keep_local`` (a block that splits
    its work over that axis itself)."""
    for dim, axis in enumerate(spec):
        if axis is not None and axis not in keep_local:
            p = all_gather(p, mesh, axis, dim, blocks_of(name) if dim == 0 else 1)
    return p


def sync_grads_(named_params, specs: dict, mesh: Mesh) -> None:
    """Sum each gradient over the data axes whose ranks computed parts of it:
    dp and sp, less dp for a parameter sharded over it (its gather's
    backward summed it). One sum per set of axes, over a flat buffer."""
    buckets: dict = {}
    for name, p in named_params:
        if p.grad is None:
            continue
        axes = tuple(a for a in DATA_AXES if mesh.axis_size(a) > 1 and a not in sharded_axes(specs.get(name)))
        if axes:
            buckets.setdefault(axes, []).append(p.grad)
    for axes, grads in buckets.items():
        flat = sum_over(torch.cat([g.reshape(-1) for g in grads]), mesh, axes)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def global_grad_norm(named_params, specs: dict, mesh: Mesh) -> torch.Tensor:
    """The L2 norm of the whole gradient, each sharded parameter counted
    once (its squares summed over the axes it is split over) and each
    replicated one once."""
    by_axes: dict = {}
    for name, p in named_params:
        if p.grad is not None:
            axes = tuple(a for a in sharded_axes(specs.get(name)) if mesh.axis_size(a) > 1)
            by_axes.setdefault(axes, []).append(p.grad.float().pow(2).sum())
    total = sum(sum_over(torch.stack(sq).sum(), mesh, axes) for axes, sq in by_axes.items())
    return torch.sqrt(total)
