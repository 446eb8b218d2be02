"""Spawned gloo ranks on the CPU for the port's device-mesh tests.

:func:`run_ranks` starts ``world`` processes with ``spawn``, each a rank of a
gloo process group on the CPU, runs one of the case functions below in each
and returns every rank's result. The ranks import torch and pfn_tpu_torch,
never jax or pfn_tpu (each checks): the test files compute the JAX references
in the parent and pass numpy arrays. One spawn runs all of a file's cases.
"""

from __future__ import annotations

import os
import socket
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.distributed as dist


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, target, payload, out_dir):
    torch.set_num_threads(1)
    from pfn_tpu_torch.parallel import init_distributed

    init_distributed(backend="gloo", device="cpu", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                     rank=rank)
    try:
        result = target(payload)
        bad = sorted(m for m in sys.modules if m == "jax" or m == "pfn_tpu" or m.startswith(("jax.", "pfn_tpu.")))
        assert not bad, bad
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(target, world: int, payload, timeout: float = 600.0) -> list:
    """``target(payload)`` on each of ``world`` spawned gloo ranks; the
    results in rank order. A failing rank raises here with its traceback; a
    run past ``timeout`` seconds is killed and raises TimeoutError."""
    with tempfile.TemporaryDirectory() as out:
        ctx = torch.multiprocessing.start_processes(_entry, args=(world, _free_port(), target, payload, out),
                                                    nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{target.__name__} on {world} ranks ran past {timeout} s")
        return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False) for r in range(world)]


def place(full: np.ndarray, local, coords: dict, sizes: dict, spec) -> None:
    """Write a rank's contiguous block ``local`` of a global array under
    ``spec`` into ``full``."""
    idx = []
    for d, axis in enumerate(spec):
        n = full.shape[d] // sizes.get(axis, 1) if axis else full.shape[d]
        c = coords.get(axis, 0) if axis else 0
        idx.append(slice(c * n, (c + 1) * n))
    full[tuple(idx)] = np.asarray(local)


def assemble(results: list, key, shape, spec) -> np.ndarray:
    """The global array from every rank's ``results[r][key]`` (a (coords,
    sizes, local) triple)."""
    full = np.zeros(shape, np.float32)
    for r in results:
        coords, sizes, local = r[key]
        place(full, local, coords, sizes, spec)
    return full


def _layout_mesh(layout: dict):
    from pfn_tpu_torch.parallel import make_mesh, make_pp_mesh

    if "pp" in layout:
        return make_pp_mesh(dp=layout.get("dp", 1), pp=layout["pp"], device="cpu")
    return make_mesh(dp=layout.get("dp", 1), tp=layout.get("tp", 1), sp=layout.get("sp", 1), ep=layout.get("ep", 1),
                     device="cpu")


def _tagged(mesh, t):
    return dict(mesh.coords), dict(mesh.shape), t.detach().numpy()


# ---- collectives and mesh ---------------------------------------------------

def collective_cases(p):
    """The shape and this rank's coordinates of each mesh of
    ``p["meshes"]`` (make_mesh keywords); then all_gather over a data axis
    (backward: reduce-scatter) and a model axis (backward: own slice),
    all_reduce / copy_to, ppermute and its inverse, on a dp2 x tp2 mesh."""
    from pfn_tpu_torch.parallel import collectives as C

    from pfn_tpu_torch.parallel import make_mesh

    out = {"meshes": {}}
    for kw in p["meshes"]:
        m = make_mesh(**kw, device="cpu")
        out["meshes"][tuple(sorted(kw.items()))] = (dict(m.shape), dict(m.coords))
    mesh = _layout_mesh({"dp": 2, "tp": 2})
    r = dist.get_rank()
    out.update(coords=dict(mesh.coords), shape=dict(mesh.shape))
    for axis in ("dp", "tp"):
        x = torch.full((2, 3), float(r + 1), requires_grad=True)
        g = C.all_gather(x, mesh, axis, dim=0)
        (g * torch.arange(1.0, 5.0)[:, None]).sum().backward()
        out[f"gather_{axis}"] = (g.detach().numpy(), x.grad.numpy())
        x = torch.full((3,), float(r + 1), requires_grad=True)
        s = C.all_reduce(x, mesh, axis)
        (s * (mesh.axis_index(axis) + 1)).sum().backward()
        out[f"reduce_{axis}"] = (s.detach().numpy(), x.grad.numpy())
    x = torch.full((3,), float(r + 1), requires_grad=True)
    (C.copy_to(x, mesh, "tp") * (mesh.axis_index("tp") + 1)).sum().backward()
    out["copy_tp"] = x.grad.numpy()
    x = torch.full((2,), float(mesh.axis_index("tp")), requires_grad=True)
    y = C.ppermute(x, mesh, "tp", 1)
    (y * (mesh.axis_index("tp") + 10)).sum().backward()
    out["ppermute"] = (y.detach().numpy(), x.grad.numpy())
    return out


# ---- sharded attention ------------------------------------------------------

def sharded_attention_cases(p):
    from pfn_tpu_torch.models import PFNTransformer, TransformerConfig
    from pfn_tpu_torch.ops.attention import pfn_attention, pfn_sharded_attention
    from pfn_tpu_torch.parallel.mesh import shard

    spec = ("dp", "tp", "sp", None)
    out = {}
    for name, layout in p["layouts"].items():
        mesh = _layout_mesh(layout)
        q, k, v = (shard(torch.from_numpy(a), mesh, spec) for a in p["fwd"])
        for sep in p["seps"]:
            out[(name, "fwd", sep)] = _tagged(mesh, pfn_sharded_attention(q, k, v, sep, mesh, prefix_impl="dense"))
        sep = torch.tensor([p["seps"][2]], dtype=torch.int32)
        out[(name, "dispatch")] = _tagged(mesh, pfn_attention(q, k, v, sep, impl="auto", mesh=mesh))
        q, k, v = (shard(torch.from_numpy(a), mesh, spec).clone().requires_grad_() for a in p["grad"])
        w = shard(torch.from_numpy(p["w"]), mesh, spec)
        (w * pfn_sharded_attention(q, k, v, p["grad_sep"], mesh, prefix_impl="dense")).sum().backward()
        for t, n in zip((q, k, v), "qkv"):
            out[(name, "grad", n)] = _tagged(mesh, t.grad)
        # Global shapes that do not divide the mesh raise (JAX: dense fallback).
        cfg = TransformerConfig(num_features=1, n_out=4, emsize=8, nhead=2, nhid=8, nlayers=1, mesh=mesh)
        try:
            PFNTransformer(cfg)(torch.zeros(1, 7, 1), torch.zeros(1, 7), 3)
            out[(name, "indivisible")] = None
        except ValueError as e:
            out[(name, "indivisible")] = str(e)
    return out


# ---- one update on a mesh ---------------------------------------------------

PRIOR = types.SimpleNamespace(num_features=2, num_outputs=1)


def gathered_grads(model) -> dict:
    from pfn_tpu_torch.parallel.mesh import blocks_of, unshard

    mesh, specs = model.config.mesh, model.param_specs
    return {n: (unshard(p.grad, mesh, specs[n], blocks_of(n)) if n in specs else p.grad).numpy()
            for n, p in model.named_parameters()}


def one_update(case: dict, mesh) -> dict:
    """One update through ``make_train_step_from_batch`` from the weights
    ``case["weights"]`` on the global batch ``case["batch"]``; the gathered
    parameters and gradients, loss and grad norm."""
    from pfn_tpu_torch.parallel.mesh import gathered_state_dict, load_full_state_dict_
    from pfn_tpu_torch.train import TrainConfig, TrainState, bar_criterion, build_model
    from pfn_tpu_torch.train.loop import _make_optimizer, make_train_step_from_batch

    cfg = TrainConfig(**case["cfg"])
    crit = bar_criterion(torch.from_numpy(case["borders"]))
    model = build_model(PRIOR, crit, cfg, mesh=mesh)
    load_full_state_dict_(model, {n: torch.from_numpy(a) for n, a in case["weights"].items()})
    optimizer, _, schedule = _make_optimizer(cfg, model)
    state = TrainState(model, optimizer, torch.Generator().manual_seed(0))
    xs, ys, tys = (torch.from_numpy(a) for a in case["batch"])
    m = make_train_step_from_batch(crit, cfg, schedule)(state, xs, ys, tys)
    return {"params": {n: t.numpy() for n, t in gathered_state_dict(model).items()}, "grads": gathered_grads(model),
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def mesh_update_cases(p):
    return {case["name"]: one_update(case, _layout_mesh(case["layout"])) for case in p["cases"]}


def resume_cases(p):
    """train() on the mesh of each case of ``p["cases"]``: 2 epochs straight,
    and 1 epoch then a resume to 2 from its checkpoint; the gathered
    parameters of both. The epoch-1 checkpoint is also copied to
    ``<dir>/<case>/epoch1`` for a resume on one rank."""
    import shutil

    from pfn_tpu_torch.priors import RidgePrior
    from pfn_tpu_torch.train import TrainConfig, mse_criterion, train

    out = {}
    for case in p["cases"]:
        mesh = _layout_mesh(case["layout"])
        root = os.path.join(p["dir"], case["name"])
        for name, epochs in (("straight", [2]), ("resumed", [1, 2])):
            ckdir = os.path.join(root, name)
            for e in epochs:
                cfg = TrainConfig(**case["cfg"], epochs=e, checkpoint_dir=ckdir, checkpoint_every=1)
                result = train(RidgePrior(num_features=2), mse_criterion(), cfg, mesh=mesh)
                if name == "resumed" and e == 1 and dist.get_rank() == 0:
                    shutil.copytree(ckdir, os.path.join(root, "epoch1"))
                dist.barrier()
            out[(case["name"], name)] = {n: t.numpy() for n, t in result.model.state_dict().items()}
            out[(case["name"], name + "_loss")] = result.final_loss
    return out


# ---- MoE --------------------------------------------------------------------

def moe_forward_cases(p):
    """MoEFFN forward on a mesh: the rank's output rows and its aux share."""
    from pfn_tpu_torch.models.moe import MoEFFN
    from pfn_tpu_torch.parallel.mesh import shard

    out = {}
    for name, layout in p["layouts"].items():
        mesh = _layout_mesh(layout)
        moe = MoEFFN(p["D"], p["H"], p["E"], capacity_factor=p["cf"], mesh=mesh)
        moe.load_state_dict({n: torch.from_numpy(a) for n, a in p["moe"].items()})
        for n in ("w1", "b1", "w2", "b2"):  # the rank's experts
            getattr(moe, n).data = shard(getattr(moe, n).data, mesh, ("ep",)).contiguous()
        x = shard(torch.from_numpy(p["x"]), mesh, ("dp", "sp", None))
        y, aux = moe(x)
        out[(name, "y")] = _tagged(mesh, y)
        out[(name, "aux")] = float(aux)
    out["updates"] = {case["name"]: one_update(case, _layout_mesh(case["layout"])) for case in p["cases"]}
    return out


# ---- pipeline ---------------------------------------------------------------

class _FixedPrior:
    """A prior whose every draw is the given global batch."""

    num_features, num_outputs = 1, 1

    def __init__(self, x, y, ty):
        self.batch = (x, y, ty)

    def sample(self, batch_size, seq_len, generator=None, device=None):
        return self.batch


def pipeline_cases(p):
    """PipelinedPFN on each layout: forward rows, the gradients of a squared
    error under the global mean, and one make_pp_train_step update."""
    from pfn_tpu_torch.models import TransformerConfig
    from pfn_tpu_torch.parallel import PipelinedPFN, make_pp_train_step, to_pipeline_params
    from pfn_tpu_torch.parallel.pipeline import from_pipeline_params
    from pfn_tpu_torch.parallel.mesh import shard, sync_grads_
    from pfn_tpu_torch.train import TrainConfig, bar_criterion

    sd = {n: torch.from_numpy(a) for n, a in p["weights"].items()}
    x, y, target = (torch.from_numpy(a) for a in p["data"])
    out = {}
    for name, (layout, impl, num_micro) in p["cases"].items():
        mesh = _layout_mesh(layout)
        cfg = TransformerConfig(**p["model"], attention_impl=impl)
        model = PipelinedPFN(cfg, mesh, num_micro)
        model.load_state_dict(to_pipeline_params(sd, model), strict=True)
        rows = [shard(a, mesh, ("dp",)) for a in (x, y, target)]
        pred = model(rows[0], rows[1], p["sep"])
        out[(name, "out")] = _tagged(mesh, pred)
        ((pred - rows[2]) ** 2).sum().div(target.numel()).backward()
        sync_grads_(model.named_parameters(), model.param_specs, mesh)
        grads = {n: q.grad.numpy() for n, q in model.named_parameters()}
        out[(name, "grads")] = (dict(mesh.coords), from_pipeline_params(grads, model))
    layout, impl, num_micro = p["step"]
    mesh = _layout_mesh(layout)
    model = PipelinedPFN(TransformerConfig(**p["model"], attention_impl=impl), mesh, num_micro)
    model.load_state_dict(to_pipeline_params(sd, model), strict=True)
    optimizer = torch.optim.Adam(model.parameters(), lr=p["lr"])
    cfg = TrainConfig(batch_size=x.shape[0], bptt=x.shape[1], eval_pos_sampler="fixed", fixed_eval_pos=p["sep"],
                      device="cpu")
    prior = _FixedPrior(*(torch.from_numpy(a) for a in p["batch"]))
    crit = bar_criterion(torch.from_numpy(p["borders"]))
    m = make_pp_train_step(model, prior, crit, cfg, optimizer)(torch.Generator().manual_seed(0))
    out["step"] = (float(m["loss"]), from_pipeline_params({n: q.detach().numpy() for n, q in model.named_parameters()},
                                                          model))
    return out


# ---- config and CLI ---------------------------------------------------------

def cli_cases(p):
    """config.build with mesh.enabled on the world, then the CLI's run; what
    each rank printed."""
    import contextlib
    import io

    from pfn_tpu_torch import config
    from pfn_tpu_torch.train import cli

    cfg = config.ExperimentConfig()
    cfg.mesh.enabled = True
    cfg.mesh.sp = p.get("sp", 1)
    cfg.train.device = "cpu"
    _, _, _, mesh = config.build(cfg)
    out = {"shape": dict(mesh.shape), "coords": dict(mesh.coords), "device": str(mesh.device)}
    if p.get("argv"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = cli.main(p["argv"])
        out["printed"] = buf.getvalue()
        out["final_loss"] = result.final_loss
        out["state"] = {n: t.numpy() for n, t in result.model.state_dict().items()}
    return out
