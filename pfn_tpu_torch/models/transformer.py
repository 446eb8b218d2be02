"""The PFN transformer.

Port of ``pfn_tpu/models/transformer.py``. Behaviour:
  * Train tokens are encoder(x) + y_encoder(y); eval tokens are encoder(x)
    only, via ``where(pos < sep)``, so shapes do not depend on sep.
  * PFN attention is a parameter of the attention op, never a mask.
  * Post-LN encoder layers with a GELU FFN; out_proj and linear2 start at
    zero, so the stack starts as the identity.
  * The encoder runs on every position (the train rows are the keys of
    every query); the decoder on the rows the caller reads, ``rows=(start,
    stop)`` given on the host, else on every position, as in the JAX model.
    Every decoder works row by row (``models/decoders.py``), so those rows
    equal the same rows of the whole output.
  * Options, as in the JAX model: ``encoder``, ``y_encoder``, ``pos_encoder``
    and ``decoder`` factories (the port's protocols take the input width
    too: see ``models/encoders.py``, ``positional.py``, ``decoders.py``),
    SeqBN input normalization, dropout after the attention's out-proj, after
    the FFN's GELU and after linear2, the exact (erf) GELU, and the MoE FFN
    (``num_experts > 0``, ``models/moe.py``), whose load-balancing loss
    ``forward(..., return_aux=True)`` returns summed over the layers.

On a device mesh (``config.mesh``, ``pfn_tpu_torch.parallel``) each rank runs
its part of the model (``parallel.mesh.shard_module_`` leaves it the slices of
its parameters): x and y are its batch rows, whole sequences; the tokens are
split over ``sp`` after the embedding (the output is the rank's positions);
the attention runs the rank's heads of ``tp`` (in_proj split head by head,
out_proj by its input columns, the output all-reduced) and the FFN its
hidden units; MoE layers their experts of ``ep``; fsdp slices are gathered at
use. SeqBN takes its statistics over the global batch. Dropout under a mesh
raises (its masks would need the global shape). Global shapes that do not
divide the mesh raise, where the JAX package falls back to dense attention.
The JAX config's ``token_sharding`` and ``expert_sharding`` fields are not
ported: here they could only repeat what ``mesh`` says (the tokens split over
sp, the experts over ep), so the model reads the mesh; ``parallel``'s
``token_sharding`` and ``expert_sharding`` give those specs.

Dropout: the layer is deterministic exactly where the JAX train loop makes
it so: in eval mode, or at ``dropout == 0``. Otherwise ``forward`` needs an
explicit ``generator`` and draws every mask from it (the train loop passes
its own, which its checkpoints save, so a resumed run stays bitwise equal to
an uninterrupted one); it never draws from torch's global RNG. Dropout stays
outside the attention kernels, as in the JAX package.

Casting follows flax exactly (no autocast): x and y are cast to the compute
dtype and promoted back to f32 by the f32 encoders, so embeddings are f32;
qkv, out_proj, linear1 and linear2 compute in the compute dtype; both
LayerNorms run in f32 (eps 1e-5), so the residual stream is f32; the decoder
is fed f32. Submodule names give the reference's torch state_dict keys
(``pfn_tpu/train/checkpoints.py:100-165``).
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from pfn_tpu_torch.models.decoders import MLPDecoder
from pfn_tpu_torch.models.encoders import LinearEncoder
from pfn_tpu_torch.models.init import lecun_normal_
from pfn_tpu_torch.models.moe import MoEFFN
from pfn_tpu_torch.models.positional import NoPositionalEncoding
from pfn_tpu_torch.ops.attention import _mesh_divisible, pfn_attention
from pfn_tpu_torch.parallel.collectives import all_reduce, copy_to
from pfn_tpu_torch.parallel.mesh import gather_at_use
from pfn_tpu_torch.utils.profiling import span, split_backward_at


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Static model configuration, the JAX package's fields: ``mesh`` (a
    ``parallel.Mesh``), ``num_experts`` and ``moe_capacity_factor`` (the MoE
    FFN); the sharding fields follow from ``mesh`` (module docstring)."""

    num_features: int
    n_out: int
    emsize: int = 200
    nhead: int = 2
    nhid: int = 200
    nlayers: int = 6
    dropout: float = 0.0
    input_normalization: bool = False
    attention_impl: str = "auto"  # 'auto' | 'flash' | 'prefix' | 'dense' | 'fused' (as 'auto' here)
    dtype: torch.dtype = torch.float32  # compute dtype; parameters are f32
    encoder: Callable | None = None
    y_encoder: Callable | None = None
    pos_encoder: Callable | None = None
    decoder: Callable | None = None
    max_len: int = 5000
    exact_gelu: bool = False
    mesh: object = None
    num_experts: int = 0
    moe_capacity_factor: float = 1.25


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=dtype): inputs, kernel and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: each entry kept with probability 1 - p (a uniform
    draw from ``generator`` below 1 - p) and scaled by 1 / (1 - p), the rest
    zero. ``generator`` None (a deterministic layer) or p == 0: x as it is."""
    if generator is None or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class MultiheadPFNAttention(nn.Module):
    """Multi-head self-attention with the PFN mask rule: a combined qkv
    projection (torch's ``in_proj``) with xavier-uniform init, and a
    zero-initialised out-projection."""

    def __init__(self, emsize: int, nhead: int, dtype: torch.dtype = torch.float32, attention_impl: str = "auto",
                 mesh=None):
        super().__init__()
        if emsize % nhead:
            raise ValueError(f"emsize {emsize} is not divisible by nhead {nhead}")
        self.nhead = nhead
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.mesh = mesh
        self.in_proj_weight = nn.Parameter(torch.empty(3 * emsize, emsize))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * emsize))
        self.out_proj = nn.Linear(emsize, emsize)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor, single_eval_pos) -> torch.Tensor:
        B, T, D = x.shape
        dt, mesh = self.dtype, self.mesh
        head_dim = D // self.nhead
        H = self.in_proj_weight.shape[0] // (3 * head_dim)  # this rank's heads (all without tp)
        if H != self.nhead:
            x = copy_to(x, mesh, "tp")
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        qkv = qkv.reshape(B, T, 3, H, head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, T, Dh)
        out = pfn_attention(q, k, v, single_eval_pos, impl=self.attention_impl, mesh=mesh)
        out = out.transpose(1, 2).reshape(B, T, H * head_dim)
        if H == self.nhead:
            return _linear(out, self.out_proj, dt)
        partial = F.linear(out.to(dt), self.out_proj.weight.to(dt)).float()
        return all_reduce(partial, mesh, "tp").to(dt) + self.out_proj.bias.to(dt)


class PFNEncoderLayer(nn.Module):
    """Post-LN encoder layer with a GELU FFN, as
    torch.nn.TransformerEncoderLayer(activation='gelu'), plus the zero init
    of linear2."""

    def __init__(self, emsize: int, nhead: int, nhid: int, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto", exact_gelu: bool = False, dropout: float = 0.0, mesh=None,
                 num_experts: int = 0, moe_capacity_factor: float = 1.25):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.nhid = nhid
        self.mesh = mesh
        self.gelu_approximate = "none" if exact_gelu else "tanh"
        self.self_attn = MultiheadPFNAttention(emsize, nhead, dtype=dtype, attention_impl=attention_impl, mesh=mesh)
        if num_experts > 0:
            if dropout:
                raise ValueError("MoEFFN has no counterpart to the dense FFN's dropout: train MoE models with "
                                 "dropout 0")
            self.moe = MoEFFN(emsize, nhid, num_experts, capacity_factor=moe_capacity_factor, dtype=dtype, mesh=mesh)
        else:
            self.linear1 = nn.Linear(emsize, nhid)
            self.linear2 = nn.Linear(nhid, emsize)
            lecun_normal_(self.linear1.weight)
            nn.init.zeros_(self.linear1.bias)
            nn.init.zeros_(self.linear2.weight)
            nn.init.zeros_(self.linear2.bias)
        self.norm1 = nn.LayerNorm(emsize, eps=1e-5)
        self.norm2 = nn.LayerNorm(emsize, eps=1e-5)

    def forward(self, x: torch.Tensor, single_eval_pos, generator: torch.Generator | None = None,
                return_aux: bool = False):
        """``generator``: the dropout masks' source; None for a
        deterministic layer. ``return_aux``: also return the MoE
        load-balancing loss (0 for the dense FFN)."""
        p = self.dropout
        attn = dropout(self.self_attn(x, single_eval_pos), p, generator)
        x = self.norm1((x + attn).float())
        aux = x.new_zeros(())
        if hasattr(self, "moe"):
            h, aux = self.moe(x)
        elif self.linear1.weight.shape[0] != self.nhid:  # the rank's hidden units of tp
            h = F.linear(copy_to(x, self.mesh, "tp").to(self.dtype), self.linear1.weight.to(self.dtype),
                         self.linear1.bias.to(self.dtype))
            h = F.gelu(h, approximate=self.gelu_approximate)
            h = all_reduce(F.linear(h, self.linear2.weight.to(self.dtype)).float(), self.mesh, "tp")
            h = h.to(self.dtype) + self.linear2.bias.to(self.dtype)
        else:
            h = _linear(x, self.linear1, self.dtype)
            h = dropout(F.gelu(h, approximate=self.gelu_approximate), p, generator)
            h = dropout(_linear(h, self.linear2, self.dtype), p, generator)
        out = self.norm2((x + h).float())
        return (out, aux) if return_aux else out


class SeqBN(nn.Module):
    """Normalization over the flattened (B*T, D) tokens with a learned
    affine (reference utils.py:76-86, transformer.py:24), as the JAX
    package's SeqBN: always the current batch's statistics (biased
    variance, eps 1e-5), no running averages, in train and eval mode alike.
    Its parameters are ``weight`` and ``bias`` (flax ``scale``, ``bias``)."""

    def __init__(self, d_model: int, mesh=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d_model))
        self.bias = nn.Parameter(torch.zeros(d_model))
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        flat = x.reshape(B * T, D)
        if self.mesh is not None and self.mesh.axis_size("dp") > 1:
            # The global batch's statistics: sums over dp (the rank holds
            # whole sequences, so sp ranks hold the same ones).
            n = B * T * self.mesh.axis_size("dp")
            mean = all_reduce(flat.sum(dim=0), self.mesh, "dp") / n
            var = all_reduce((flat - mean).square().sum(dim=0), self.mesh, "dp") / n
        else:
            mean = flat.mean(dim=0)
            var = flat.var(dim=0, unbiased=False)
        flat = (flat - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias
        return flat.reshape(B, T, D)


class _EncoderStack(nn.Module):
    """Holds the layers under ``transformer_encoder.layers.N``."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class PFNTransformer(nn.Module):
    """The PFN: ``model(x, y, single_eval_pos)`` -> (B, T, n_out).

    x: (B, T, F) features; y: (B, T) targets, read at positions <
    ``single_eval_pos`` only. ``single_eval_pos`` is an int or a one-element
    tensor. The output covers all positions; rows < single_eval_pos are train
    tokens whose outputs callers ignore. ``generator``: the dropout masks'
    source, needed in training with dropout > 0 (module docstring).
    ``return_aux``: also return the MoE layers' load-balancing loss, summed
    over the layers (0 without experts). On a mesh: the rank's part (module
    docstring); ``param_specs`` names the parameters it holds slices of.

    ``rows``: None (decode every row) or ``(start, stop)``, which decodes
    rows start .. stop-1 only and returns (B, stop - start, n_out). Each
    bound is an int or any object with ``__index__``, read only once the
    encoder's kernels are enqueued: a bound still being copied from the
    device (the train loop's sep) is waited for while the device has the
    encoder to run. Not on a sequence-parallel mesh, whose ranks hold only
    their positions.
    """

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        c, mesh = config, config.mesh
        if mesh is not None:
            if c.dropout > 0:
                raise ValueError("dropout under a device mesh is not supported: each rank would draw its own "
                                 "masks, not its slice of the global ones")
            if c.nhead % mesh.axis_size("tp") or (c.num_experts and c.num_experts % mesh.axis_size("ep")):
                raise ValueError(f"nhead {c.nhead} and num_experts {c.num_experts} must divide over tp and ep")
        self.param_specs: dict = {}
        self.encoder = (c.encoder or LinearEncoder)(c.num_features, c.emsize)
        self.y_encoder = (c.y_encoder or LinearEncoder)(1, c.emsize)
        if c.input_normalization:
            self.input_ln = SeqBN(c.emsize, mesh=mesh)
        self.pos_encoder = (c.pos_encoder or NoPositionalEncoding)(c.emsize, max_len=c.max_len)
        self.transformer_encoder = _EncoderStack(
            PFNEncoderLayer(c.emsize, c.nhead, c.nhid, dtype=c.dtype, attention_impl=c.attention_impl,
                            exact_gelu=c.exact_gelu, dropout=c.dropout, mesh=mesh, num_experts=c.num_experts,
                            moe_capacity_factor=c.moe_capacity_factor)
            for _ in range(c.nlayers)
        )
        if c.decoder is not None:
            self.decoder = c.decoder(c.emsize, c.nhid, c.n_out)
        else:
            self.decoder = MLPDecoder(c.emsize, c.nhid, c.n_out, approximate=not c.exact_gelu)

    def _run(self, module: nn.Module, prefix: str, *args, **kwargs):
        """``module(*args, **kwargs)``, with its parameter slices gathered at
        use where the model holds slices: over dp (fsdp), and over tp and ep
        except in the encoder layers, which split their own work over them."""
        if not self.param_specs:
            return module(*args, **kwargs)
        keep_local = ("tp", "ep") if prefix.startswith("transformer_encoder.") else ()
        params = {n: (gather_at_use(prefix + n, p, self.config.mesh, self.param_specs[prefix + n], keep_local)
                      if prefix + n in self.param_specs else p)
                  for n, p in module.named_parameters()}
        return torch.func.functional_call(module, params, args, kwargs)

    def forward(self, x: torch.Tensor, y: torch.Tensor, single_eval_pos,
                generator: torch.Generator | None = None, return_aux: bool = False, rows=None):
        c, mesh = self.config, self.config.mesh
        deterministic = not self.training or c.dropout == 0.0
        if not deterministic and generator is None:
            raise ValueError("dropout > 0 in training draws its masks from an explicit torch.Generator: "
                             "pass generator= (the train loop passes its own)")
        T = x.shape[1]
        if mesh is not None and not _mesh_divisible(
                (x.shape[0] * mesh.axis_size("dp"), c.nhead, T, c.emsize // c.nhead), mesh):
            raise ValueError(f"batch {x.shape[0]} a rank, {c.nhead} heads and T {T} do not divide the mesh "
                             f"{mesh.shape}")
        if rows is not None and mesh is not None and mesh.axis_size("sp") > 1:
            raise ValueError("rows= on a sequence-parallel mesh: each rank holds only its own positions")
        with span("model.forward"):
            # The encoders take the compute-dtype-rounded inputs as f32 values.
            x_emb = self._run(self.encoder, "encoder.", x.to(c.dtype).float())
            y_emb = self._run(self.y_encoder, "y_encoder.", y[..., None].to(c.dtype).float())
            pos = torch.arange(T, device=x.device)[None, :, None]
            tokens = x_emb + torch.where(pos < single_eval_pos, y_emb, torch.zeros_like(y_emb))
            if c.input_normalization:
                tokens = self._run(self.input_ln, "input_ln.", tokens)
            tokens = self._run(self.pos_encoder, "pos_encoder.", tokens, deterministic=deterministic)
            if mesh is not None and mesh.axis_size("sp") > 1:  # this rank's positions of sp
                Tq = T // mesh.axis_size("sp")
                tokens = tokens[:, mesh.axis_index("sp") * Tq:(mesh.axis_index("sp") + 1) * Tq]
            masks = None if deterministic else generator
            aux = tokens.new_zeros(())
            for i, layer in enumerate(self.transformer_encoder.layers):
                tokens, layer_aux = self._run(layer, f"transformer_encoder.layers.{i}.", tokens, single_eval_pos, masks,
                                              return_aux=True)
                aux = aux + layer_aux
            decoder_input = tokens.float()
            split_backward_at(decoder_input)
            produced = decoder_input.shape[0] * decoder_input.shape[1]
            if rows is not None:
                start, stop = (operator.index(r) for r in rows)
                if not 0 <= start <= stop <= decoder_input.shape[1]:
                    raise ValueError(f"rows ({start}, {stop}) outside the {decoder_input.shape[1]} positions")
                decoder_input = decoder_input[:, start:stop]
            with span("model.decoder") as s:
                out = self._run(self.decoder, "decoder.", decoder_input)
                if s is not None:
                    s.rows = (decoder_input.shape[0] * decoder_input.shape[1], produced)
            return (out, aux) if return_aux else out


def num_params(model: nn.Module) -> int:
    """Number of parameter entries (the JAX package's ``num_params`` of the
    params tree), which ``get_openai_lr`` takes."""
    return sum(p.numel() for p in model.parameters())
