"""Differentiable collectives over one axis of a :class:`~pfn_tpu_torch.parallel.mesh.Mesh`.

The port's own module: in the JAX package XLA inserts these from sharding
constraints and ``shard_map``. Each is one ``torch.distributed`` call:
``all_gather`` (the list form), ``all_reduce``, ``reduce_scatter_tensor`` or
``all_to_all_single``. NCCL carries them, and gloo carries them on CUDA
tensors too (each of the four in f32, bf16 and f16, four gloo ranks sharing
one H100, torch 2.11), so the same code runs ranks on one card each (NCCL)
and ranks that share one card (gloo). Gathers and permutes send a tensor in
its own dtype. Sums of 16-bit tensors reduce in f32 and round once, as one
rank's f32 accumulation does; the port's sums are of f32 tensors (loss
terms, gradients of f32 parameters, the tensor-parallel partial products)
but for the bf16 gradient of the keys and values over ``sp``. An
all-reduce hands every rank the same result, so replicated parameters stay
equal across ranks (the tests check the gathered state rank by rank).

Every rank of the world computes a part of the loss, and the mesh's axes
come in two kinds (``DATA_AXES``):
  * along ``dp`` and ``sp`` the ranks compute different parts of the loss
    (other datasets, other positions), so a collective's backward is its
    adjoint: an all-gather's is a reduce-scatter, an all-reduce's an
    all-reduce;
  * along ``tp``, ``ep`` and ``pp`` the ranks compute the same loss from
    the same inputs (Megatron's rule), so an all-reduce's backward is the
    identity, :func:`copy_to`'s the converse, and an all-gather's takes the
    rank's own slice of the gradient.

Size-1 axes are no-ops. ``blocks`` splits a dimension made of that many
equal blocks block by block (the q, k and v rows of ``in_proj`` over
``tp``: a rank holds its heads of each).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

DATA_AXES = ("dp", "sp")


def _sum_dtype(x: torch.Tensor) -> torch.Tensor:
    """x as a sum takes it: 16-bit floats as f32, so that it rounds once."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def gather_list(x: torch.Tensor, mesh, axis: str) -> list:
    """Every rank's ``x`` along ``axis``, in rank order (no autograd)."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(out, x, group=mesh.groups[axis])
    return out


def split(x: torch.Tensor, dim: int, n: int, i: int, blocks: int = 1) -> torch.Tensor:
    """Shard ``i`` of ``n`` of ``x`` along ``dim``: of each of ``blocks``
    equal blocks, its i-th n-th."""
    x = x.unflatten(dim, (blocks, n, x.shape[dim] // (blocks * n)))
    return x.select(dim + 1, i).flatten(dim, dim + 1)


def join(pieces: list, dim: int, blocks: int = 1) -> torch.Tensor:
    """The inverse of :func:`split` over every shard."""
    parts = [p.unflatten(dim, (blocks, p.shape[dim] // blocks)) for p in pieces]
    return torch.stack(parts, dim + 1).flatten(dim, dim + 2)


def _reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int, blocks: int) -> torch.Tensor:
    """The sum over ``axis`` of every rank's ``x``, this rank's shard of it
    along ``dim``."""
    n = mesh.axis_size(axis)
    shards = [_sum_dtype(split(x, dim, n, i, blocks)) for i in range(n)]
    out = torch.empty(shards[0].numel(), dtype=shards[0].dtype, device=x.device)
    dist.reduce_scatter_tensor(out, torch.cat([t.reshape(-1) for t in shards]), group=mesh.groups[axis])
    return out.reshape(shards[0].shape).to(x.dtype)


def sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over every rank along ``axes`` (no autograd): for
    loss denominators, gradients and norms."""
    out = None
    for axis in axes:
        if mesh is not None and mesh.axis_size(axis) > 1:
            if out is None:
                out = _sum_dtype(x).clone(memory_format=torch.contiguous_format)
            dist.all_reduce(out, group=mesh.groups[axis])
    return x if out is None else out.to(x.dtype)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, blocks):
        ctx.args = (mesh, axis, dim, blocks)
        return join(gather_list(x, mesh, axis), dim, blocks)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, blocks = ctx.args
        if axis in DATA_AXES:
            return _reduce_scatter(g, mesh, axis, dim, blocks), None, None, None, None
        own = split(g, dim, mesh.axis_size(axis), mesh.axis_index(axis), blocks)
        return own.contiguous(), None, None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return sum_over(x, mesh, (axis,))

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return (sum_over(g, mesh, (axis,)) if axis in DATA_AXES else g), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return sum_over(g, mesh, (axis,)), None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int, blocks: int = 1) -> torch.Tensor:
    """Every rank's shard along ``axis`` joined along ``dim``. Backward: a
    reduce-scatter on a data axis, the rank's own slice on a model axis."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    return _AllGather.apply(x, mesh, axis, dim, blocks)


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis``. Backward: an all-reduce on a data axis, the
    identity on a model axis (the tensor-parallel output reduction)."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    return _AllReduce.apply(x, mesh, axis)


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The identity, whose backward sums over the model axis ``axis``: the
    input of a block that the ranks along it split between them."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def ppermute_raw(x: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` places on along ``axis`` (cyclic) and
    return what the rank ``shift`` places back sent: one all-to-all with one
    non-empty chunk each way (no autograd)."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    if n == 1:
        return x
    flat = x.contiguous().reshape(-1)
    sizes_in, sizes_out = [0] * n, [0] * n
    sizes_in[(i + shift) % n] = sizes_out[(i - shift) % n] = flat.numel()
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, sizes_out, sizes_in, group=mesh.groups[axis])
    return out.reshape(x.shape)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.args = (mesh, axis, shift)
        return ppermute_raw(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, shift = ctx.args
        return ppermute_raw(g, mesh, axis, -shift), None, None, None


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` by the cyclic shift ``shift`` along ``axis``; its
    backward is the inverse permutation."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    return _PPermute.apply(x, mesh, axis, shift)
