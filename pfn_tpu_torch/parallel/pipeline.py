"""Pipeline parallelism (GPipe) for the PFN encoder stack.

Port of ``pfn_tpu/parallel/pipeline.py``. The layer stack is split over the
``pp`` axis of a ``("dp", "pp")`` mesh (:func:`make_pp_mesh`): stage s holds
``nlayers / pp`` consecutive layers, named ``layer_0`` ... as in the
one-device model, so :func:`to_pipeline_params` is a relabelling. The
embedding and the decoder head are small and run on every stage.

Schedule: a shift register of ``M + S - 1`` ticks over M microbatches of the
rank's batch rows. At tick t stage s runs microbatch t - s (where 0 <= t - s <
M), and every stage passes its output one stage on (``ppermute`` by one
all-to-all); the last stage's outputs are summed out over pp. The JAX
package gets the backward from ``jax.grad`` through ``shard_map``; here it is
one ``autograd.Function`` whose backward runs the reverse schedule: each
stage back-propagates its ticks through its layers in reverse order and
passes the input gradients one stage back, so every rank makes the same
collective calls in the same order. A tick outside a stage's microbatches
computes nothing and sends zeros.

As in the JAX package the pipeline has no dropout, no SeqBN (whole-batch
statistics), no token sharding and no MoE layers (their loss would be
dropped); the stages take ``exact_gelu`` from the config, which the JAX
stages leave at tanh.
"""

from __future__ import annotations

import torch
from torch import nn

from pfn_tpu_torch.models.decoders import MLPDecoder
from pfn_tpu_torch.models.encoders import LinearEncoder
from pfn_tpu_torch.models.positional import NoPositionalEncoding
from pfn_tpu_torch.models.transformer import PFNEncoderLayer, TransformerConfig
from pfn_tpu_torch.parallel.collectives import ppermute_raw, sum_over
from pfn_tpu_torch.parallel.mesh import Mesh, make_pp_mesh, shard, sync_grads_

__all__ = ["PFNEmbed", "PFNEncoderStage", "PipelinedPFN", "from_pipeline_params", "make_pp_mesh", "make_pp_train_step",
           "to_pipeline_params"]


class PFNEmbed(nn.Module):
    """The token construction: encoder(x) + y_encoder(y) on train tokens,
    then the positional encoding."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        c = config
        self.dtype = c.dtype
        self.encoder = (c.encoder or LinearEncoder)(c.num_features, c.emsize)
        self.y_encoder = (c.y_encoder or LinearEncoder)(1, c.emsize)
        self.pos_encoder = (c.pos_encoder or NoPositionalEncoding)(c.emsize, max_len=c.max_len)

    def forward(self, x, y, single_eval_pos):
        x_emb = self.encoder(x.to(self.dtype).float())
        y_emb = self.y_encoder(y[..., None].to(self.dtype).float())
        pos = torch.arange(x.shape[1], device=x.device)[None, :, None]
        tokens = x_emb + torch.where(pos < single_eval_pos, y_emb, torch.zeros_like(y_emb))
        return self.pos_encoder(tokens)


class PFNEncoderStage(nn.Module):
    """``layers_per_stage`` consecutive encoder layers, ``layer_{i}``."""

    def __init__(self, config: TransformerConfig, layers_per_stage: int):
        super().__init__()
        c = config
        for i in range(layers_per_stage):
            self.add_module(f"layer_{i}", PFNEncoderLayer(c.emsize, c.nhead, c.nhid, dtype=c.dtype,
                                                          attention_impl=c.attention_impl, exact_gelu=c.exact_gelu))

    def forward(self, x, single_eval_pos):
        for layer in self.children():
            x = layer(x, single_eval_pos)
        return x


def _ticks(mesh: Mesh, num_micro: int):
    S, s = mesh.axis_size("pp"), mesh.axis_index("pp")
    return S, s, [(t, t - s, 0 <= t - s < num_micro) for t in range(num_micro + S - 1)]


class _Pipeline(torch.autograd.Function):
    """The shift register over pp, forward and reverse."""

    @staticmethod
    def forward(ctx, tokens, stage, sep, mesh, num_micro, keep_graph):
        S, s, ticks = _ticks(mesh, num_micro)
        micro = tokens.reshape(num_micro, -1, *tokens.shape[1:])
        outputs = torch.zeros_like(micro)
        state = torch.zeros_like(micro[0])
        saved = {}
        for t, m, valid in ticks:
            send = torch.zeros_like(state)
            if valid:
                x_in = (micro[m] if s == 0 else state).detach().requires_grad_(keep_graph)
                with torch.set_grad_enabled(keep_graph):
                    out = stage(x_in, sep)
                if keep_graph:
                    saved[t] = (x_in, out)
                send = out.detach()
                if s == S - 1:
                    outputs[m] = send
            state = ppermute_raw(send, mesh, "pp", 1)
        ctx.saved, ctx.args = saved, (mesh, num_micro)
        return sum_over(outputs, mesh, ("pp",)).reshape(tokens.shape)

    @staticmethod
    def backward(ctx, grad):
        mesh, num_micro = ctx.args
        S, s, ticks = _ticks(mesh, num_micro)
        d_out = grad.reshape(num_micro, -1, *grad.shape[1:])
        d_micro = torch.zeros_like(d_out)
        recv = torch.zeros_like(d_out[0])
        for t, m, valid in reversed(ticks):
            send = torch.zeros_like(recv)
            if valid:
                x_in, out = ctx.saved.pop(t)
                torch.autograd.backward(out, d_out[m] if s == S - 1 else recv)  # the stage's weight grads too
                send = x_in.grad
                if s == 0:
                    d_micro[m] = send
            recv = ppermute_raw(send, mesh, "pp", -1)
        # The embedding runs on every stage and feeds stage 0 only.
        return sum_over(d_micro, mesh, ("pp",)).reshape(grad.shape), None, None, None, None, None


class PipelinedPFN(nn.Module):
    """A PFN whose encoder stack runs as a ``pp``-stage pipeline on a
    ``("dp", "pp")`` mesh. This rank holds the embedding, its stage's layers
    and the decoder. ``model(x, y, sep)`` is ``PFNTransformer``'s forward on
    the rank's batch rows ((B/dp, T, F) -> (B/dp, T, n_out)); the rows split
    into ``num_micro`` microbatches."""

    def __init__(self, config: TransformerConfig, mesh: Mesh, num_micro: int):
        super().__init__()
        c = config
        self.config, self.mesh, self.num_micro = c, mesh, num_micro
        self.pp = mesh.axis_size("pp")
        checks = [
            (c.nlayers % self.pp == 0, f"nlayers={c.nlayers} must divide over pp={self.pp} stages"),
            (c.dropout == 0.0, "the pipelined path is dropout-free"),
            (not c.input_normalization, "SeqBN is whole-batch normalization: incompatible with microbatches"),
            (c.mesh is None, "the pipeline's mesh is ('dp', 'pp'): the config takes no mesh, so no token sharding"),
            (c.num_experts == 0, "MoE layers' aux loss would be dropped: combine ep with dp/tp/sp instead"),
        ]
        for ok, reason in checks:
            if not ok:
                raise ValueError(reason)
        self.layers_per_stage = c.nlayers // self.pp
        self.embed = PFNEmbed(c)
        self.stage = PFNEncoderStage(c, self.layers_per_stage)
        if c.decoder is not None:
            self.decoder = c.decoder(c.emsize, c.nhid, c.n_out)
        else:
            self.decoder = MLPDecoder(c.emsize, c.nhid, c.n_out, approximate=not c.exact_gelu)
        # The stage's weights are this rank's alone (split over pp); the rest is on every stage.
        self.param_specs = {n: ("pp",) for n, _ in self.named_parameters() if n.startswith("stage.")}

    def forward(self, x, y, single_eval_pos):
        B = x.shape[0]
        if B % self.num_micro:
            raise ValueError(f"the rank's batch {B} must divide into {self.num_micro} microbatches")
        tokens = self.embed(x, y, single_eval_pos)
        keep_graph = torch.is_grad_enabled() and tokens.requires_grad
        tokens = _Pipeline.apply(tokens, self.stage, single_eval_pos, self.mesh, self.num_micro, keep_graph)
        return self.decoder(tokens.float())


def to_pipeline_params(state_dict: dict, pp_model: PipelinedPFN, stage: int | None = None) -> dict:
    """A ``PFNTransformer`` state_dict relabelled for ``pp_model``'s stage
    ``stage`` (None: this rank's): the encoders and positional encoding
    under ``embed.``, layer ``stage * L + i`` as ``stage.layer_{i}``, the
    decoder as it is."""
    s = pp_model.mesh.axis_index("pp") if stage is None else stage
    L = pp_model.layers_per_stage
    out = {}
    for name, t in state_dict.items():
        head, _, rest = name.partition(".")
        if head in ("encoder", "y_encoder", "pos_encoder"):
            out[f"embed.{name}"] = t
        elif head == "decoder":
            out[name] = t
        elif head == "transformer_encoder":
            index, _, leaf = rest.removeprefix("layers.").partition(".")
            if s * L <= int(index) < (s + 1) * L:
                out[f"stage.layer_{int(index) - s * L}.{leaf}"] = t
    return out


def from_pipeline_params(tensors: dict, pp_model: PipelinedPFN) -> dict:
    """The inverse of :func:`to_pipeline_params` on this rank's stage:
    ``pp_model``'s named tensors (its parameters, their gradients) under the
    one-device ``PFNTransformer``'s names."""
    s, L = pp_model.mesh.axis_index("pp"), pp_model.layers_per_stage
    out = {}
    for name, t in tensors.items():
        head, _, rest = name.partition(".")
        if head == "embed":
            out[rest] = t
        elif head == "stage":
            index, _, leaf = rest.removeprefix("layer_").partition(".")
            out[f"transformer_encoder.layers.{s * L + int(index)}.{leaf}"] = t
        else:
            out[name] = t
    return out


def make_pp_train_step(pp_model: PipelinedPFN, prior, criterion, cfg, optimizer):
    """The pipeline's train step, ``train_step(generator) -> {"loss"}``: the
    global batch and sep drawn from ``generator`` (the same on every rank),
    the rank's rows, the pipelined forward, the masked mean loss over eval
    positions (numerator and denominator summed over dp), the reverse
    schedule, the gradients summed over dp, and ``optimizer.step()``. As in
    the JAX package there is no clip; the optimizer is the caller's."""
    from pfn_tpu_torch.train.loop import _eval_pos_weights, _loss_terms, _sample_eval_pos

    mesh = pp_model.mesh
    weights = _eval_pos_weights(cfg, mesh.device)

    def train_step(generator: torch.Generator) -> dict:
        x, y, target_y = prior.sample(cfg.batch_size, cfg.bptt, generator=generator, device=generator.device)
        sep = _sample_eval_pos(generator, cfg, weights)
        x, y, target_y = (shard(a, mesh, ("dp",)) for a in (x, y, target_y))
        pp_model.train()
        optimizer.zero_grad(set_to_none=True)
        num, den = _loss_terms(criterion, pp_model(x, y, sep), target_y, sep, mesh)
        (num / den).backward()
        sync_grads_(pp_model.named_parameters(), pp_model.param_specs, mesh)
        optimizer.step()
        return {"loss": sum_over(num.detach(), mesh, ("dp",)) / den}

    return train_step
