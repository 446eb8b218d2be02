"""The training loop.

Port of ``pfn_tpu/train/loop.py``, itself at parity with the reference
train.py: the head width follows the criterion, Adam with a cosine warmup
stepped once per epoch, ``single_eval_pos`` drawn per microbatch, the loss
taken over eval positions only, gradients summed (not averaged) over
``aggregate_k_gradients`` microbatches and clipped to a global norm of 1.0,
per-position loss bookkeeping, validation hooks, and full-state
checkpoints with automatic resume.

How it maps to PyTorch:
  * Every draw (prior data, ``sep``) comes from one explicit
    ``torch.Generator`` on the training device, which the checkpoint saves.
    ``sep`` stays a one-element device tensor from the sampler through the
    model, the kernels and the loss mask. The host needs its value for one
    thing: on one device the model decodes only the eval rows sep .. T-1,
    the rows the loss reads (the others would carry weight 0 and a zero
    gradient). So right after the draw sep is copied to pinned host memory
    without blocking (:class:`_HostSep`), and the host waits for that copy
    only once the encoder's kernels are enqueued: it never drains the
    device's queue before the loop reads the loss.
  * On a device mesh and on the fused path the decoder runs on every row and
    the loss is masked (positions >= sep), not sliced, so every microbatch
    has the same shapes there.
  * The JAX package's ``lax.scan`` over microbatches is a Python loop whose
    ``backward()`` calls accumulate into ``.grad``: the sum over the k
    microbatches. ``updates_per_call`` updates run between host syncs
    (``make_train_chunk``); capturing the step in a CUDA graph is left to a
    later change (ROADMAP.md, open cell i).
  * With ``dropout > 0`` the model draws its dropout masks from the same
    generator, after the microbatch's data and sep (the JAX package splits a
    "dropout" key per microbatch), so a resumed run stays bitwise equal.
  * ``eval_pos_sampler`` resolves through ``registries.EVAL_POS_SAMPLERS``
    (unless "fixed"), so a user-registered sampler changes training.
  * ``attention_impl="fused"`` runs each microbatch's forward through
    ``models.fused_apply.fused_forward`` (the JAX package's
    ``_apply_with_aux``): every encoder layer is one fused-layer kernel call
    forward and two backward. A config that path does not support raises
    ``ValueError`` with ``fused_supported``'s reason before anything runs, as
    does bptt > 512. The JAX package refuses a non-TPU backend there; the
    port's counterpart is its device rule: on the card the fused kernels run,
    and their plain PyTorch versions run only where the caller set
    ``device="cpu"``.
  * ``num_experts > 0`` trains MoE FFNs; the loss adds ``moe_aux_weight``
    times the layers' load-balancing loss (the reported loss is the task's),
    and the automatic LR counts each expert weight at 1/E
    (:func:`_active_param_count`).
  * Spans (``utils.profiling.span``) mark an update, the prior's draws, the
    loss, the backward and the optimizer for the benchmark's per-layer
    metrics; while recording is off each is a flag check.
  * ``train(..., mesh=parallel.make_mesh(...))`` runs one rank of a device
    mesh (one process a rank; ``parallel.init_distributed``). Every rank
    draws the global batch, and sep, from the same seeded generator, which
    is the one-rank run's batch, and keeps its rows (dp) and positions (sp).
    The masked mean's numerator and denominator are summed over dp and sp;
    gradients are summed over the data axes (``parallel.mesh.sync_grads_``)
    and the clip's norm counts every parameter once. With ``fsdp`` the
    parameters and the Adam state are split over dp as well. Checkpoints
    hold the gathered state (they load on one device), only rank 0 writes
    them and prints, and ``TrainResult.model`` is the one-device model.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from pfn_tpu_torch.device import require_cuda
from pfn_tpu_torch.models.fused_apply import fused_forward, fused_supported
from pfn_tpu_torch.models.transformer import PFNTransformer, TransformerConfig
from pfn_tpu_torch.ops import _ext
from pfn_tpu_torch.parallel.collectives import sum_over
from pfn_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    gathered_optimizer_state,
    gathered_state_dict,
    global_grad_norm,
    load_full_optimizer_state_,
    load_full_state_dict_,
    shard,
    shard_module_,
    sync_grads_,
)
from pfn_tpu_torch.train.checkpoints import (
    latest_state_checkpoint,
    prune_state_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from pfn_tpu_torch.train.losses import Criterion
from pfn_tpu_torch.utils.profiling import raise_on_nan, span
from pfn_tpu_torch.utils.samplers import draw_eval_pos
from pfn_tpu_torch.utils.schedules import cosine_schedule_with_warmup, get_openai_lr


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's TrainConfig (the reference train() signature), plus
    the training ``device`` (None: the current CUDA device, and an error
    when there is no card; pass "cpu" to train on the CPU) and
    ``exact_gelu``, which the JAX config lacks (so a model the JAX loop
    builds from an exact-GELU checkpoint runs the tanh GELU; here it reaches
    ``TransformerConfig.exact_gelu``). ``fsdp`` splits the parameters and
    the optimizer state over the mesh's dp axis (no effect without a mesh).
    The module factories take the port's protocols (``models/``).
    ``attention_impl="fused"`` trains through the fused-layer kernels (module
    docstring)."""

    emsize: int = 200
    nhid: int = 200
    nlayers: int = 6
    nhead: int = 2
    dropout: float = 0.0
    epochs: int = 10
    steps_per_epoch: int = 100
    batch_size: int = 200
    bptt: int = 10
    lr: float | None = None
    warmup_epochs: int = 10
    input_normalization: bool = False
    aggregate_k_gradients: int = 1
    eval_pos_sampler: str = "uniform"  # 'uniform' | 'weighted' | 'mixture' | 'fixed'
    eval_pos_max: int | None = None  # cap (<= bptt) of the drawn sep
    fixed_eval_pos: int | None = None
    # Optimizer updates between two host syncs (the loop reads the loss once
    # per call).
    updates_per_call: int = 1
    # Full-state checkpoint (model, optimizer, step, generator, epoch) every
    # checkpoint_every epochs into checkpoint_dir; train() resumes from the
    # newest one automatically.
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0
    checkpoint_keep: int = 2  # newest checkpoints retained (0 = keep all)
    validation_period: int = 10
    seed: int = 0
    verbose: bool = True
    fsdp: bool = False
    attention_impl: str = "auto"
    dtype: torch.dtype = torch.float32
    num_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    encoder: Callable | None = None
    y_encoder: Callable | None = None
    pos_encoder: Callable | None = None
    decoder: Callable | None = None
    exact_gelu: bool = False
    device: str | torch.device | None = None


@dataclasses.dataclass
class TrainState:
    """What an update changes: the model's weights, the optimizer state, the
    training generator and the count of updates taken."""

    model: PFNTransformer
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0


@dataclasses.dataclass
class TrainResult:
    final_loss: float
    positional_losses: list
    model: PFNTransformer
    criterion: Criterion
    config: TrainConfig
    epoch_stats: list


def _device(cfg: TrainConfig, mesh: Mesh | None = None) -> torch.device:
    if mesh is not None:
        if cfg.device is not None and torch.device(cfg.device).type != mesh.device.type:
            raise ValueError(f"TrainConfig.device {cfg.device} is not the mesh's device {mesh.device}")
        return mesh.device
    if cfg.device is not None:
        return torch.device(cfg.device)
    return require_cuda()


def _updates_per_epoch(cfg: TrainConfig) -> int:
    return max(1, cfg.steps_per_epoch // cfg.aggregate_k_gradients)


def build_model(prior, criterion: Criterion, cfg: TrainConfig, mesh: Mesh | None = None) -> PFNTransformer:
    """The PFN for ``prior`` and ``criterion`` (the head width follows the
    criterion), on the training device. Its initial weights are drawn from a
    generator seeded with ``cfg.seed``; the global RNG state is left as it
    was. With ``mesh``: on the mesh's device, holding this rank's slices of
    those weights (``parallel.mesh.shard_module_``, fsdp as ``cfg.fsdp``)."""
    mcfg = TransformerConfig(
        mesh=mesh,
        moe_capacity_factor=cfg.moe_capacity_factor,
        num_features=prior.num_features,
        n_out=criterion.n_out(prior.num_outputs),
        emsize=cfg.emsize,
        nhead=cfg.nhead,
        nhid=cfg.nhid,
        nlayers=cfg.nlayers,
        dropout=cfg.dropout,
        input_normalization=cfg.input_normalization,
        attention_impl=cfg.attention_impl,
        dtype=cfg.dtype,
        encoder=cfg.encoder,
        y_encoder=cfg.y_encoder,
        pos_encoder=cfg.pos_encoder,
        decoder=cfg.decoder,
        exact_gelu=cfg.exact_gelu,
        num_experts=cfg.num_experts,
        max_len=max(cfg.bptt * 2, 16),
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = PFNTransformer(mcfg)
    model = model.to(_device(cfg, mesh))
    return shard_module_(model, mesh, cfg.fsdp) if mesh is not None else model


def _active_param_count(model: PFNTransformer, num_experts: int) -> int:
    """The dense-equivalent parameter count of the one-device model for the
    automatic LR: each MoE expert weight counts at 1/E (one expert is active
    a token), so experts do not lower ``get_openai_lr``. A sharded
    parameter counts whole."""
    mesh, total = model.config.mesh, 0
    for name, p in model.named_parameters():
        n = p.numel()
        for axis in model.param_specs.get(name, ()):
            n *= mesh.axis_size(axis) if axis else 1
        is_expert = ".moe." in name and name.rsplit(".", 1)[-1] in ("w1", "w2", "b1", "b2")
        total += n // num_experts if is_expert and num_experts > 1 else n
    return total


def _validate_mesh_shapes(cfg: TrainConfig, mesh: Mesh | None) -> None:
    """Raise, with the reason, where the batch, sequence, heads or experts do
    not divide the mesh (the JAX package asserts the same)."""
    if mesh is None:
        return
    dp, sp, tp, ep = (mesh.axis_size(a) for a in ("dp", "sp", "tp", "ep"))
    if cfg.batch_size % dp:
        raise ValueError(f"batch_size={cfg.batch_size} must divide over dp={dp}")
    if sp > 1 and cfg.bptt % sp:
        raise ValueError(f"bptt={cfg.bptt} must divide over sp={sp} for sequence parallelism (pad bptt or change sp)")
    if tp > 1 and cfg.nhead % tp:
        raise ValueError(f"nhead={cfg.nhead} must divide over tp={tp} (heads are the tensor-parallel axis of "
                         "attention)")
    if ep > 1 and cfg.num_experts % ep:
        raise ValueError(f"num_experts={cfg.num_experts} must divide over ep={ep}")


def _make_optimizer(cfg: TrainConfig, model: PFNTransformer):
    """Adam (b1 0.9, b2 0.999, eps 1e-8) and the LR of each update: the
    epoch's cosine-warmup LR, constant within an epoch as the reference steps
    its scheduler once per epoch. Returns (optimizer, base_lr,
    step_schedule); the step applies the global-norm clip itself."""
    base_lr = cfg.lr if cfg.lr is not None else get_openai_lr(_active_param_count(model, cfg.num_experts))
    epoch_schedule = cosine_schedule_with_warmup(base_lr, cfg.warmup_epochs, cfg.epochs)
    updates_per_epoch = _updates_per_epoch(cfg)

    def step_schedule(count: int) -> float:
        return epoch_schedule(count // updates_per_epoch)

    optimizer = torch.optim.Adam(model.parameters(), lr=step_schedule(0), betas=(0.9, 0.999), eps=1e-8)
    return optimizer, base_lr, step_schedule


def _eval_pos_weights(cfg: TrainConfig, device) -> torch.Tensor | None:
    """The sampler's unnormalised weights over positions 0 .. max_len-1, on
    ``device``, from the entry of ``registries.EVAL_POS_SAMPLERS`` that
    ``cfg.eval_pos_sampler`` names (a ``max_len -> weights`` function); None
    for ``fixed``."""
    if cfg.eval_pos_sampler == "fixed":
        return None
    from pfn_tpu_torch.registries import EVAL_POS_SAMPLERS

    weights = EVAL_POS_SAMPLERS.get(cfg.eval_pos_sampler)(cfg.eval_pos_max or cfg.bptt)
    return torch.as_tensor(weights, dtype=torch.float32).to(device)


def _sample_eval_pos(generator: torch.Generator, cfg: TrainConfig, weights: torch.Tensor | None):
    """One ``sep`` as a one-element int32 tensor on the generator's device;
    ``weights`` from :func:`_eval_pos_weights`."""
    if cfg.eval_pos_sampler == "fixed":
        return torch.full((1,), cfg.fixed_eval_pos, dtype=torch.int32, device=generator.device)
    return draw_eval_pos(weights, generator)


def _check_fused(model: PFNTransformer, cfg: TrainConfig) -> None:
    """Raise ValueError where ``attention_impl="fused"`` cannot run this
    model, on its device, at this bptt (``fused_forward`` raises the same at
    its first call)."""
    reason = fused_supported(model.config, next(model.parameters()).device)
    if reason is None and cfg.bptt > _ext.FUSED_MAX_SEQ:
        reason = f"bptt {cfg.bptt} > {_ext.FUSED_MAX_SEQ}"
    if reason is not None:
        raise ValueError(f"fused path does not support this config: {reason}")


class _HostSep:
    """A one-element sep tensor on its way to the host. On the card: a
    non-blocking copy into pinned memory, enqueued when this is made, and an
    event behind it. ``operator.index`` waits for that event alone (once),
    so a caller that asks after enqueuing more work leaves the device that
    work to run; off the card it reads the value."""

    __slots__ = ("host", "event", "value")

    def __init__(self, sep: torch.Tensor):
        self.host, self.event, self.value = sep, None, None
        if sep.device.type == "cuda":
            self.host = torch.empty(sep.shape, dtype=sep.dtype, pin_memory=True)
            self.host.copy_(sep, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()

    def __index__(self) -> int:
        if self.value is None:
            if self.event is not None:
                self.event.synchronize()
            self.value = int(self.host.reshape(-1)[0])
        return self.value


def _decodes_eval_rows(model: PFNTransformer, cfg: TrainConfig) -> bool:
    """Whether the forward decodes only the eval rows: on one device, off the
    fused path (module docstring)."""
    return model.config.mesh is None and cfg.attention_impl != "fused"


def _sep_to_host(model: PFNTransformer, cfg: TrainConfig, sep) -> _HostSep | None:
    """sep's copy to the host where the forward decodes only the eval rows,
    else None; made right after the draw, before the microbatch's forward."""
    return _HostSep(sep) if _decodes_eval_rows(model, cfg) else None


def _local_batch(mesh: Mesh | None, x, y, target_y):
    """This rank's part of a global batch: its rows (dp) of x and y, whole
    sequences, and its rows and positions (dp, sp) of target_y."""
    if mesh is None:
        return x, y, target_y
    return shard(x, mesh, ("dp",)), shard(y, mesh, ("dp",)), shard(target_y, mesh, batch_sharding(mesh))


def _loss_terms(criterion: Criterion, out, target_y, sep, mesh: Mesh | None):
    """(numerator, denominator) of the mean loss over eval positions (>= sep)
    of a batch, each rank's numerator over its rows and positions, the
    denominator summed over dp and sp. ``out`` holds every row of
    ``target_y`` or its last ones (a forward that decoded the rows sep ..
    T-1 alone), which are scored against the last rows of ``target_y``."""
    with span("train.loss"):
        T, decoded = target_y.shape[1], out.shape[1]
        target_y = target_y[:, T - decoded:]
        start = (mesh.axis_index("sp") * T if mesh is not None else 0) + T - decoded
        losses = criterion.per_position(out, target_y)  # (B, decoded)
        positions = torch.arange(start, start + decoded, device=losses.device)
        mask = (positions >= sep).to(losses.dtype).expand_as(losses) * criterion.valid_weight(target_y)
        return (losses * mask).sum(), sum_over(mask.sum(), mesh, ("dp", "sp")).clamp_min(1.0)


def _loss_parts(model, criterion: Criterion, cfg: TrainConfig, x, y, target_y, sep,
                generator: torch.Generator | None = None, host_sep: _HostSep | None = None):
    """(objective, task loss) of one microbatch, a global batch: the
    objective to differentiate (on a mesh the rank's share, which sums over
    dp and sp to the whole) and the mean task loss over eval positions. The
    forward goes through the fused layers where ``cfg.attention_impl`` is
    "fused"; dropout masks, if any, come from ``generator``. On one device
    the model decodes the rows sep .. T-1 alone, sep read from ``host_sep``
    (:func:`_sep_to_host`), made here where the caller gives none."""
    mesh = model.config.mesh
    x, y, target_y = _local_batch(mesh, x, y, target_y)
    rows = None
    if _decodes_eval_rows(model, cfg):
        rows = (host_sep if host_sep is not None else _HostSep(sep), x.shape[1])
    if cfg.attention_impl == "fused":
        out = fused_forward(model, x, y, sep)
    elif cfg.num_experts > 0:
        out, aux = model(x, y, sep, generator=generator, return_aux=True, rows=rows)
    else:
        out = model(x, y, sep, generator=generator, rows=rows)
    num, den = _loss_terms(criterion, out, target_y, sep, mesh)
    objective = num / den
    if cfg.num_experts > 0:
        objective = objective + cfg.moe_aux_weight * aux
    return objective, sum_over(num.detach(), mesh, ("dp", "sp")) / den


def _masked_loss(model, criterion: Criterion, cfg: TrainConfig, x, y, target_y, sep,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """The objective of :func:`_loss_parts`: the mean loss over the eval
    positions (>= sep) of one microbatch, plus the weighted MoE loss."""
    return _loss_parts(model, criterion, cfg, x, y, target_y, sep, generator)[0]


def _update(state: TrainState, criterion: Criterion, cfg: TrainConfig, schedule, microbatches) -> dict:
    """One optimizer update from the (x, y, target_y, sep, host_sep)
    ``microbatches`` (``host_sep``: :func:`_sep_to_host`):
    gradients summed over them (and on a mesh over the data axes), the
    global norm clipped to 1.0 by optax's rule g / max(1, |g|), then Adam at
    ``schedule(state.step)``."""
    model, optimizer = state.model, state.optimizer
    if cfg.attention_impl == "fused":
        _check_fused(model, cfg)  # before a microbatch is drawn
    with span("train.update"):
        device = next(model.parameters()).device
        positions = torch.arange(cfg.bptt, device=device)
        loss_sum = torch.zeros((), device=device)
        pos_loss = torch.zeros(cfg.bptt, device=device)
        pos_cnt = torch.zeros(cfg.bptt, device=device)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        k = 0
        for x, y, target_y, sep, host_sep in microbatches:
            objective, loss = _loss_parts(model, criterion, cfg, x, y, target_y, sep, state.generator, host_sep)
            with span("train.backward"):  # cut in two at the decoder's input (utils.profiling)
                objective.backward()  # accumulates into .grad: the sum over microbatches
            onehot = (positions == sep).to(torch.float32)
            loss_sum += loss
            pos_loss += onehot * loss
            pos_cnt += onehot
            k += 1
        grad_norm = _clip_and_step(state, schedule)
        return {"loss": loss_sum / k, "pos_loss": pos_loss, "pos_cnt": pos_cnt, "grad_norm": grad_norm}


def _clip_and_step(state: TrainState, schedule) -> torch.Tensor:
    """The optimizer's part of an update, from the gradients in ``.grad``
    (on a mesh first summed over the data axes): the global norm clipped to
    1.0 by optax's rule g / max(1, |g|), then Adam at
    ``schedule(state.step)``. Returns the norm before the clip."""
    model, optimizer = state.model, state.optimizer
    mesh = model.config.mesh
    with span("train.optimizer"):
        if mesh is None:
            grads = [p.grad for p in model.parameters()]
            grad_norm = torch.nn.utils.get_total_norm(grads)
        else:
            sync_grads_(model.named_parameters(), model.param_specs, mesh)
            grads = [p.grad for p in model.parameters()]
            grad_norm = global_grad_norm(model.named_parameters(), model.param_specs, mesh)
        # optax.clip_by_global_norm(1.0): g unchanged below the norm, g / |g| at or above it.
        divisor = torch.where(grad_norm < 1.0, torch.ones_like(grad_norm), grad_norm)
        for g in grads:
            g.div_(divisor)
        for group in optimizer.param_groups:
            group["lr"] = schedule(state.step)
        optimizer.step()
    state.step += 1
    return grad_norm


def make_train_step(prior, criterion: Criterion, cfg: TrainConfig, schedule):
    """The step fed by the prior on the device: ``train_step(state) ->
    metrics``. Each of the k microbatches draws its datasets, then its sep,
    from ``state.generator``, which lies on the training device, then starts
    sep's copy to the host (:func:`_sep_to_host`)."""
    weights = _eval_pos_weights(cfg, _device(cfg))

    def train_step(state: TrainState) -> dict:
        g = state.generator

        def microbatches():
            for _ in range(cfg.aggregate_k_gradients):
                with span("prior.sample"):
                    x, y, target_y = prior.sample(cfg.batch_size, cfg.bptt, generator=g, device=g.device)
                    sep = _sample_eval_pos(g, cfg, weights)
                yield x, y, target_y, sep, _sep_to_host(state.model, cfg, sep)

        return _update(state, criterion, cfg, schedule, microbatches())

    return train_step


def make_train_step_from_batch(criterion: Criterion, cfg: TrainConfig, schedule):
    """The step fed by the host: ``train_step(state, xs, ys, target_ys) ->
    metrics``, with a leading aggregate_k_gradients axis on each array (xs
    (k, B, T, F), ys and target_ys (k, B, T)), for data the device cannot
    generate. Each microbatch draws its sep from ``state.generator`` and
    starts its copy to the host; the rest is :func:`make_train_step`'s
    update."""
    weights = _eval_pos_weights(cfg, _device(cfg))

    def train_step(state: TrainState, xs, ys, target_ys) -> dict:
        g = state.generator
        # From pinned host memory the copy is asynchronous.
        xs, ys, target_ys = (torch.as_tensor(a).to(g.device, non_blocking=True) for a in (xs, ys, target_ys))

        def microbatches():
            for i in range(xs.shape[0]):
                sep = _sample_eval_pos(g, cfg, weights)
                yield xs[i], ys[i], target_ys[i], sep, _sep_to_host(state.model, cfg, sep)

        return _update(state, criterion, cfg, schedule, microbatches())

    return train_step


def _stack_host(arrays) -> torch.Tensor:
    """The k host arrays of one field of k microbatches as one (k, ...)
    tensor; a single one keeps its buffer, so a pinned batch stays pinned."""
    ts = [torch.as_tensor(a) for a in arrays]
    return ts[0][None] if len(ts) == 1 else torch.stack(ts)


def make_train_chunk(train_step, updates_per_call: int):
    """``updates_per_call`` updates per call, with the metrics summed over
    them (``grad_norm`` averaged), as the JAX package's scanned chunk."""

    def chunk(state: TrainState) -> dict:
        metrics = [train_step(state) for _ in range(updates_per_call)]
        return {
            "loss": torch.stack([m["loss"] for m in metrics]).sum(),
            "pos_loss": torch.stack([m["pos_loss"] for m in metrics]).sum(0),
            "pos_cnt": torch.stack([m["pos_cnt"] for m in metrics]).sum(0),
            "grad_norm": torch.stack([m["grad_norm"] for m in metrics]).mean(),
        }

    return chunk


def _checkpoint(state: TrainState, epoch: int) -> dict:
    """The one-device state: on a mesh the gathered model and Adam state
    (every rank takes part)."""
    return {"model": gathered_state_dict(state.model),
            "optimizer": gathered_optimizer_state(state.model, state.optimizer), "step": state.step,
            "generator": state.generator.get_state(), "epoch": epoch}


def _restore(state: TrainState, ckpt: dict) -> None:
    load_full_state_dict_(state.model, ckpt["model"])
    load_full_optimizer_state_(state.model, state.optimizer, ckpt["optimizer"])
    state.generator.set_state(ckpt["generator"])
    state.step = int(ckpt["step"])


def _one_device_model(prior, criterion: Criterion, cfg: TrainConfig, model: PFNTransformer) -> PFNTransformer:
    """``model`` itself, or off a mesh: the one-device model of its gathered
    weights, on the rank's device."""
    mesh = model.config.mesh
    if mesh is None:
        return model
    one = build_model(prior, criterion, dataclasses.replace(cfg, device=mesh.device))
    one.load_state_dict(gathered_state_dict(model), strict=True)
    return one


def train(prior, criterion: Criterion, cfg: TrainConfig, mesh=None, init_params: dict[str, Any] | None = None,
          validate_fn: Callable | None = None, data_iter=None) -> TrainResult:
    """Meta-train a PFN on a prior. Returns the trained model and its stats.

    ``init_params``: a state_dict to start from instead of the seeded init.
    ``validate_fn(model) -> float`` runs every ``validation_period`` epochs.
    ``data_iter``: an iterator of host ``(x, y, target_y)`` batches of shape
    (batch_size, bptt, ...), which switches to the host-fed step; ``prior``
    then only gives num_features and num_outputs; every rank of a mesh
    passes the same global batches. ``mesh``: this rank's place on a device
    mesh (``parallel.make_mesh``); ``validate_fn`` then sees the one-device
    model of the gathered weights, as ``TrainResult.model`` is.
    """
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a pfn_tpu_torch.parallel Mesh (parallel.make_mesh), not {type(mesh).__name__}")
    _validate_mesh_shapes(cfg, mesh)
    device = _device(cfg, mesh)
    updates_per_epoch = _updates_per_epoch(cfg)
    if cfg.steps_per_epoch % cfg.aggregate_k_gradients:
        raise ValueError("steps_per_epoch must be divisible by aggregate_k_gradients")
    model = build_model(prior, criterion, cfg, mesh=mesh)
    if cfg.attention_impl == "fused":
        _check_fused(model, cfg)
    if init_params is not None:
        load_full_state_dict_(model, init_params)
    lead = mesh is None or mesh.rank == 0  # the rank that prints and writes
    criterion = criterion.to(device)
    optimizer, _, schedule = _make_optimizer(cfg, model)
    state = TrainState(model, optimizer, torch.Generator(device=device).manual_seed(cfg.seed))
    if data_iter is not None:
        if cfg.updates_per_call > 1:
            raise ValueError("updates_per_call > 1 needs on-device data generation")
        step_fn, upc = make_train_step_from_batch(criterion, cfg, schedule), 1
    else:
        step_fn, upc = make_train_step(prior, criterion, cfg, schedule), max(1, cfg.updates_per_call)
        if upc > 1:
            step_fn = make_train_chunk(step_fn, upc)
    if updates_per_epoch % upc:
        raise ValueError("updates per epoch must be divisible by updates_per_call")

    start_epoch = 1
    if cfg.checkpoint_dir:
        latest = latest_state_checkpoint(cfg.checkpoint_dir)
        if latest is not None:
            path, ckpt_epoch = latest
            _restore(state, restore_checkpoint(path, map_location="cpu"))
            start_epoch = ckpt_epoch + 1
            if cfg.verbose and lead:
                print(f"resumed from {path} (epoch {ckpt_epoch})")

    epoch_stats = []
    total_loss = float("inf")
    positional = [float("nan")] * cfg.bptt
    for epoch in range(start_epoch, cfg.epochs + 1):
        t0 = time.perf_counter()
        loss_acc = 0.0
        pos_loss_acc = torch.zeros(cfg.bptt, device=device)
        pos_cnt_acc = torch.zeros(cfg.bptt, device=device)
        grad_norm_acc = torch.zeros((), device=device)
        step_s = 0.0  # host time of the calls, each ending in the sync that reads its loss
        for _ in range(updates_per_epoch // upc):
            t_call = time.perf_counter()
            if data_iter is not None:
                batches = [next(data_iter) for _ in range(cfg.aggregate_k_gradients)]
                xs, ys, tys = (_stack_host([b[i] for b in batches]) for i in range(3))
                metrics = step_fn(state, xs, ys, tys)
            else:
                metrics = step_fn(state)
            loss = float(metrics["loss"])  # the host sync of the call
            step_s += time.perf_counter() - t_call
            raise_on_nan(loss)  # under utils.profiling.debug_nans
            loss_acc += loss
            pos_loss_acc += metrics["pos_loss"]
            pos_cnt_acc += metrics["pos_cnt"]
            grad_norm_acc += metrics["grad_norm"]
        total_loss = loss_acc / updates_per_epoch
        positional = (pos_loss_acc / pos_cnt_acc.clamp_min(1.0)).tolist()
        val_score = None
        if validate_fn is not None and epoch % cfg.validation_period == 0:
            val_score = validate_fn(_one_device_model(prior, criterion, cfg, model).eval())  # deterministic
        lr_now = float(schedule((epoch - 1) * updates_per_epoch))
        stats = {
            "epoch": epoch,
            "mean_loss": total_loss,
            "lr": lr_now,
            "epoch_time": time.perf_counter() - t0,
            "step_time": step_s / updates_per_epoch,
            "val_score": val_score,
            "grad_norm": float(grad_norm_acc) / (updates_per_epoch // upc),
        }
        epoch_stats.append(stats)
        if cfg.checkpoint_dir and cfg.checkpoint_every > 0 and epoch % cfg.checkpoint_every == 0:
            ckpt = _checkpoint(state, epoch)
            if lead:
                save_checkpoint(f"{cfg.checkpoint_dir}/epoch_{epoch}", ckpt)
                if cfg.checkpoint_keep > 0:
                    prune_state_checkpoints(cfg.checkpoint_dir, cfg.checkpoint_keep)
            if mesh is not None:  # no rank looks for a checkpoint before the lead has written it
                torch.distributed.barrier()
        if cfg.verbose and lead:
            print(
                f"| epoch {epoch:3d} | time {stats['epoch_time']:5.2f}s "
                f"| mean loss {total_loss:5.3f} | lr {lr_now:.2e}"
                + (f" | val {val_score}" if val_score is not None else "")
            )

    return TrainResult(
        final_loss=total_loss,
        positional_losses=positional,
        model=_one_device_model(prior, criterion, cfg, model).eval(),
        criterion=criterion,
        config=cfg,
        epoch_stats=epoch_stats,
    )
