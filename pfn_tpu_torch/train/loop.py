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
    model, the kernels and the loss mask, so a step costs no host sync until
    the loop reads the loss.
  * The loss is masked (positions >= sep), not sliced, so every microbatch
    has the same shapes.
  * The JAX package's ``lax.scan`` over microbatches is a Python loop whose
    ``backward()`` calls accumulate into ``.grad``: the sum over the k
    microbatches. ``updates_per_call`` updates run between host syncs
    (``make_train_chunk``); capturing the step in a CUDA graph is left to a
    later change (ROADMAP.md, open cell i).
  * ``attention_impl="fused"`` runs each microbatch's forward through
    ``models.fused_apply.fused_forward`` (the JAX package's
    ``_apply_with_aux``): every encoder layer is one fused-layer kernel call
    forward and two backward. A config that path does not support raises
    ``ValueError`` with ``fused_supported``'s reason before anything runs, as
    does bptt > 512. The JAX package refuses a non-TPU backend there; the
    port's counterpart is its device rule: on the card the fused kernels run,
    and their plain PyTorch versions run only where the caller set
    ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from pfn_tpu_torch.device import require_cuda
from pfn_tpu_torch.models.fused_apply import fused_forward, fused_supported
from pfn_tpu_torch.models.transformer import PFNTransformer, TransformerConfig, num_params
from pfn_tpu_torch.ops import _ext
from pfn_tpu_torch.train.checkpoints import (
    latest_state_checkpoint,
    prune_state_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from pfn_tpu_torch.train.losses import Criterion
from pfn_tpu_torch.utils.profiling import StepTimers
from pfn_tpu_torch.utils.samplers import draw_eval_pos, make_eval_pos_weights
from pfn_tpu_torch.utils.schedules import cosine_schedule_with_warmup, get_openai_lr

_BUILTIN_SAMPLERS = ("weighted", "uniform", "mixture")


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's TrainConfig (the reference train() signature), plus
    the training ``device`` (None: the current CUDA device, and an error
    when there is no card; pass "cpu" to train on the CPU). The fields for
    options the port does not have yet (a mesh, fsdp, experts, dropout,
    custom modules) are kept and raise, naming their ROADMAP.md item.
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


def _check_ported(cfg: TrainConfig, mesh=None) -> None:
    """Raise for the options the port does not have yet."""
    todo = {
        "a device mesh": (mesh is not None, "queue 1 item 14 (parallelism)"),
        "fsdp": (cfg.fsdp, "queue 1 item 14 (parallelism)"),
        "num_experts > 0": (cfg.num_experts > 0, "queue 1 item 14 (MoE)"),
        "dropout > 0": (cfg.dropout > 0, "queue 1 item 9 (dropout)"),
        "custom encoder, y_encoder, pos_encoder or decoder": (
            any(m is not None for m in (cfg.encoder, cfg.y_encoder, cfg.pos_encoder, cfg.decoder)),
            "queue 1 item 9 (encoders, positional encodings, decoders)"),
        f"eval_pos_sampler={cfg.eval_pos_sampler!r}": (
            cfg.eval_pos_sampler not in (*_BUILTIN_SAMPLERS, "fixed"), "queue 1 item 13 (the sampler registry)"),
    }
    for name, (used, item) in todo.items():
        if used:
            raise NotImplementedError(f"training with {name} is not ported yet (ROADMAP.md {item})")


def _device(cfg: TrainConfig) -> torch.device:
    if cfg.device is not None:
        return torch.device(cfg.device)
    return require_cuda()


def _updates_per_epoch(cfg: TrainConfig) -> int:
    return max(1, cfg.steps_per_epoch // cfg.aggregate_k_gradients)


def build_model(prior, criterion: Criterion, cfg: TrainConfig) -> PFNTransformer:
    """The PFN for ``prior`` and ``criterion`` (the head width follows the
    criterion), on the training device. Its initial weights are drawn from a
    generator seeded with ``cfg.seed``; the global RNG state is left as it
    was."""
    mcfg = TransformerConfig(
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
        num_experts=cfg.num_experts,
        max_len=max(cfg.bptt * 2, 16),
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = PFNTransformer(mcfg)
    return model.to(_device(cfg))


def _make_optimizer(cfg: TrainConfig, model: PFNTransformer):
    """Adam (b1 0.9, b2 0.999, eps 1e-8) and the LR of each update: the
    epoch's cosine-warmup LR, constant within an epoch as the reference steps
    its scheduler once per epoch. Returns (optimizer, base_lr,
    step_schedule); the step applies the global-norm clip itself."""
    base_lr = cfg.lr if cfg.lr is not None else get_openai_lr(num_params(model))
    epoch_schedule = cosine_schedule_with_warmup(base_lr, cfg.warmup_epochs, cfg.epochs)
    updates_per_epoch = _updates_per_epoch(cfg)

    def step_schedule(count: int) -> float:
        return epoch_schedule(count // updates_per_epoch)

    optimizer = torch.optim.Adam(model.parameters(), lr=step_schedule(0), betas=(0.9, 0.999), eps=1e-8)
    return optimizer, base_lr, step_schedule


def _eval_pos_weights(cfg: TrainConfig, device) -> torch.Tensor | None:
    """Sampler weights on ``device`` for a built-in sampler; None for
    ``fixed``."""
    if cfg.eval_pos_sampler == "fixed":
        return None
    return make_eval_pos_weights(cfg.eval_pos_max or cfg.bptt, cfg.eval_pos_sampler, device=device)


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


def _masked_loss(model, criterion: Criterion, cfg: TrainConfig, x, y, target_y, sep) -> torch.Tensor:
    """Mean loss over the eval positions (>= sep) of one microbatch, the
    forward through the fused layers where ``cfg.attention_impl`` is
    "fused"."""
    out = fused_forward(model, x, y, sep) if cfg.attention_impl == "fused" else model(x, y, sep)
    losses = criterion.per_position(out, target_y)  # (B, T)
    eval_rows = (torch.arange(cfg.bptt, device=losses.device) >= sep).to(losses.dtype)
    mask = eval_rows.expand_as(losses) * criterion.valid_weight(target_y)
    return (losses * mask).sum() / mask.sum().clamp_min(1.0)


def _update(state: TrainState, criterion: Criterion, cfg: TrainConfig, schedule, microbatches) -> dict:
    """One optimizer update from the (x, y, target_y, sep) ``microbatches``:
    gradients summed over them, the global norm clipped to 1.0 by optax's
    rule g / max(1, |g|), then Adam at ``schedule(state.step)``."""
    model, optimizer = state.model, state.optimizer
    if cfg.attention_impl == "fused":
        _check_fused(model, cfg)  # before a microbatch is drawn
    device = next(model.parameters()).device
    positions = torch.arange(cfg.bptt, device=device)
    loss_sum = torch.zeros((), device=device)
    pos_loss = torch.zeros(cfg.bptt, device=device)
    pos_cnt = torch.zeros(cfg.bptt, device=device)
    model.train()
    optimizer.zero_grad(set_to_none=True)
    k = 0
    for x, y, target_y, sep in microbatches:
        loss = _masked_loss(model, criterion, cfg, x, y, target_y, sep)
        loss.backward()  # accumulates into .grad: the sum over microbatches
        loss = loss.detach()
        onehot = (positions == sep).to(torch.float32)
        loss_sum += loss
        pos_loss += onehot * loss
        pos_cnt += onehot
        k += 1
    grads = [p.grad for p in model.parameters()]
    grad_norm = torch.nn.utils.get_total_norm(grads)
    # optax.clip_by_global_norm(1.0): g unchanged below the norm, g / |g| at or above it.
    divisor = torch.where(grad_norm < 1.0, torch.ones_like(grad_norm), grad_norm)
    for g in grads:
        g.div_(divisor)
    for group in optimizer.param_groups:
        group["lr"] = schedule(state.step)
    optimizer.step()
    state.step += 1
    return {"loss": loss_sum / k, "pos_loss": pos_loss, "pos_cnt": pos_cnt, "grad_norm": grad_norm}


def make_train_step(prior, criterion: Criterion, cfg: TrainConfig, schedule):
    """The step fed by the prior on the device: ``train_step(state) ->
    metrics``. Each of the k microbatches draws its datasets, then its sep,
    from ``state.generator``, which lies on the training device."""
    weights = _eval_pos_weights(cfg, _device(cfg))

    def train_step(state: TrainState) -> dict:
        g = state.generator

        def microbatches():
            for _ in range(cfg.aggregate_k_gradients):
                x, y, target_y = prior.sample(cfg.batch_size, cfg.bptt, generator=g, device=g.device)
                yield x, y, target_y, _sample_eval_pos(g, cfg, weights)

        return _update(state, criterion, cfg, schedule, microbatches())

    return train_step


def make_train_step_from_batch(criterion: Criterion, cfg: TrainConfig, schedule):
    """The step fed by the host: ``train_step(state, xs, ys, target_ys) ->
    metrics``, with a leading aggregate_k_gradients axis on each array (xs
    (k, B, T, F), ys and target_ys (k, B, T)), for data the device cannot
    generate. Each microbatch draws its sep from ``state.generator``; the
    rest is :func:`make_train_step`'s update."""
    weights = _eval_pos_weights(cfg, _device(cfg))

    def train_step(state: TrainState, xs, ys, target_ys) -> dict:
        g = state.generator
        xs, ys, target_ys = (torch.as_tensor(a, device=g.device) for a in (xs, ys, target_ys))
        microbatches = ((xs[i], ys[i], target_ys[i], _sample_eval_pos(g, cfg, weights)) for i in range(xs.shape[0]))
        return _update(state, criterion, cfg, schedule, microbatches)

    return train_step


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
    return {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(), "step": state.step,
            "generator": state.generator.get_state(), "epoch": epoch}


def _restore(state: TrainState, ckpt: dict) -> None:
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.generator.set_state(ckpt["generator"])
    state.step = int(ckpt["step"])


def train(prior, criterion: Criterion, cfg: TrainConfig, mesh=None, init_params: dict[str, Any] | None = None,
          validate_fn: Callable | None = None, data_iter=None) -> TrainResult:
    """Meta-train a PFN on a prior. Returns the trained model and its stats.

    ``init_params``: a state_dict to start from instead of the seeded init.
    ``validate_fn(model) -> float`` runs every ``validation_period`` epochs.
    ``data_iter``: an iterator of host ``(x, y, target_y)`` batches of shape
    (batch_size, bptt, ...), which switches to the host-fed step; ``prior``
    then only gives num_features and num_outputs. ``mesh`` is the JAX
    package's parameter and is not ported (it raises).
    """
    _check_ported(cfg, mesh)
    device = _device(cfg)
    updates_per_epoch = _updates_per_epoch(cfg)
    if cfg.steps_per_epoch % cfg.aggregate_k_gradients:
        raise ValueError("steps_per_epoch must be divisible by aggregate_k_gradients")
    model = build_model(prior, criterion, cfg)
    if cfg.attention_impl == "fused":
        _check_fused(model, cfg)
    if init_params is not None:
        model.load_state_dict(init_params, strict=True)
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
            if cfg.verbose:
                print(f"resumed from {path} (epoch {ckpt_epoch})")

    epoch_stats = []
    timers = StepTimers()
    total_loss = float("inf")
    positional = [float("nan")] * cfg.bptt
    for epoch in range(start_epoch, cfg.epochs + 1):
        t0 = time.perf_counter()
        loss_acc = 0.0
        pos_loss_acc = torch.zeros(cfg.bptt, device=device)
        pos_cnt_acc = torch.zeros(cfg.bptt, device=device)
        grad_norm_acc = torch.zeros((), device=device)
        timers.reset()
        for _ in range(updates_per_epoch // upc):
            # One channel: prior sampling, forward, backward and the update.
            with timers.channel("fused_step", device=device):
                if data_iter is not None:
                    batches = [next(data_iter) for _ in range(cfg.aggregate_k_gradients)]
                    xs, ys, tys = (torch.stack([torch.as_tensor(b[i]) for b in batches]) for i in range(3))
                    metrics = step_fn(state, xs, ys, tys)
                else:
                    metrics = step_fn(state)
                loss_acc += float(metrics["loss"])  # the host sync of the call
            pos_loss_acc += metrics["pos_loss"]
            pos_cnt_acc += metrics["pos_cnt"]
            grad_norm_acc += metrics["grad_norm"]
        total_loss = loss_acc / updates_per_epoch
        positional = (pos_loss_acc / pos_cnt_acc.clamp_min(1.0)).tolist()
        val_score = None
        if validate_fn is not None and epoch % cfg.validation_period == 0:
            val_score = validate_fn(model)
        lr_now = float(schedule((epoch - 1) * updates_per_epoch))
        stats = {
            "epoch": epoch,
            "mean_loss": total_loss,
            "lr": lr_now,
            "epoch_time": time.perf_counter() - t0,
            "step_time": (timers.means().get("fused_step") or 0.0) / upc,
            "val_score": val_score,
            "grad_norm": float(grad_norm_acc) / (updates_per_epoch // upc),
        }
        epoch_stats.append(stats)
        if cfg.checkpoint_dir and cfg.checkpoint_every > 0 and epoch % cfg.checkpoint_every == 0:
            save_checkpoint(f"{cfg.checkpoint_dir}/epoch_{epoch}", _checkpoint(state, epoch))
            if cfg.checkpoint_keep > 0:
                prune_state_checkpoints(cfg.checkpoint_dir, cfg.checkpoint_keep)
        if cfg.verbose:
            print(
                f"| epoch {epoch:3d} | time {stats['epoch_time']:5.2f}s "
                f"| mean loss {total_loss:5.3f} | lr {lr_now:.2e}"
                + (f" | val {val_score}" if val_score is not None else "")
            )

    model.eval()
    return TrainResult(
        final_loss=total_loss,
        positional_losses=positional,
        model=model,
        criterion=criterion,
        config=cfg,
        epoch_stats=epoch_stats,
    )
