"""Mixture-of-Experts FFN with expert parallelism (Switch-style top-1).

Port of ``pfn_tpu/models/moe.py``: an optional replacement for the encoder
layer's FFN. The router computes in f32; each token goes to its argmax
expert, at its place in that expert's queue (a cumsum over the sequence);
tokens past the capacity C = max(1, int(capacity_factor * T / E)) are
dropped onto the residual (the FFN branch gives 0). Dispatch is a
scatter-add into E*C + 1 slots (the last one takes the dropped tokens) and
combine a gather, never a dense one-hot. Each expert is Linear -> tanh GELU
-> Linear with the second linear starting at zero. The experts' products are
batched matmuls over E, as the JAX package's ``jnp.einsum``; neither package
has a kernel of its own here.

The load-balancing loss E * sum_e f_e * p_e (f: the fraction routed to e, p:
the mean router probability) is returned, not sown; the model sums it over
layers and the train loop adds ``moe_aux_weight`` times the sum.

On a mesh (``mesh=``):
  * ``ep``: the rank holds experts [i*E/ep, (i+1)*E/ep) and runs them on its
    whole local batch (the batch is not split over ep); each token's output
    comes from the rank of its expert, summed over ep (zeros elsewhere, so
    the sum is exact).
  * ``sp``: the queue positions and the capacity run over the global
    sequence: the cumsum over the rank's positions starts from the counts of
    the ranks before it on sp (an all-gather of (B, E) counts).
  * ``dp``, ``sp``: f and p are global means. The returned value is the
    rank's share, linear in its own router probabilities; the shares of the
    dp and sp ranks sum to the loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pfn_tpu_torch.models.init import lecun_normal_
from pfn_tpu_torch.parallel.collectives import all_reduce, copy_to, gather_list, sum_over


class MoEFFN(nn.Module):
    """(B, T, D) -> ((B, T, D), aux) through top-1-routed experts.
    Parameters (the JAX layout, E leading): ``router`` (a Linear D -> E),
    ``w1`` (E, D, nhid), ``b1`` (E, nhid), ``w2`` (E, nhid, D), ``b2`` (E, D)."""

    def __init__(self, emsize: int, nhid: int, num_experts: int, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        E = num_experts
        self.num_experts, self.capacity_factor, self.dtype, self.mesh = E, capacity_factor, dtype, mesh
        self.router = nn.Linear(emsize, E)
        nn.init.normal_(self.router.weight, std=0.02)
        nn.init.zeros_(self.router.bias)
        # flax lecun_normal(batch_axis=0) on (E, D, nhid): fan_in = D.
        self.w1 = nn.Parameter(lecun_normal_(torch.empty(E, emsize, nhid), fan_in=emsize))
        self.b1 = nn.Parameter(torch.zeros(E, nhid))
        self.w2 = nn.Parameter(torch.zeros(E, nhid, emsize))  # zero init, per expert
        self.b2 = nn.Parameter(torch.zeros(E, emsize))

    def forward(self, x: torch.Tensor):
        B, T, D = x.shape
        E, mesh, dt = self.num_experts, self.mesh, self.dtype
        sp = mesh.axis_size("sp") if mesh is not None else 1
        C = max(1, int(self.capacity_factor * T * sp / E))

        gates = torch.softmax(F.linear(x.float(), self.router.weight.float(), self.router.bias.float()), dim=-1)
        gate, expert_idx = gates.max(dim=-1)  # (B, T): the first maximum, as argmax
        onehot = F.one_hot(expert_idx, E).float()  # (B, T, E)
        queue = onehot.cumsum(dim=1)
        if sp > 1:  # the counts of the ranks before this one on sp
            counts = torch.stack(gather_list(onehot.sum(dim=1), mesh, "sp"))  # (sp, B, E)
            queue = queue + counts[: mesh.axis_index("sp")].sum(dim=0)[:, None, :]
        pos = (queue * onehot).sum(dim=-1) - 1.0  # (B, T)
        keep = (pos >= 0) & (pos < C)

        n_tokens = B * T * (mesh.axis_size("dp") * sp if mesh is not None else 1)
        frac_routed = sum_over(onehot.sum(dim=(0, 1)), mesh, ("dp", "sp")) / n_tokens
        aux = E * (frac_routed * gates.sum(dim=(0, 1)) / n_tokens).sum()

        # This rank's experts: all of them, or its E/ep on an ep mesh.
        ep = mesh.axis_size("ep") if mesh is not None else 1
        E_l = E // ep
        first = (mesh.axis_index("ep") if ep > 1 else 0) * E_l
        local = keep & (expert_idx >= first) & (expert_idx < first + E_l)
        slot = torch.where(local, (expert_idx - first) * C + pos.clamp(0, C - 1).long(), E_l * C)  # (B, T)
        xd = copy_to(x.to(dt), mesh, "ep")
        index = slot[..., None].expand(B, T, D)
        x_e = torch.zeros(B, E_l * C + 1, D, dtype=dt, device=x.device).scatter_add(1, index, xd)[:, :-1]
        x_e = x_e.reshape(B, E_l, C, D)

        w1, b1, w2, b2 = (w.to(dt) for w in (self.w1, self.b1, self.w2, self.b2))
        h = torch.einsum("becd,edh->bech", x_e, w1) + b1[None, :, None, :]
        h = F.gelu(h, approximate="tanh")
        y_e = torch.einsum("bech,ehd->becd", h, w2) + b2[None, :, None, :]

        y_flat = y_e.reshape(B, E_l * C, D)
        gathered = torch.gather(y_flat, 1, slot.clamp_max(E_l * C - 1)[..., None].expand(B, T, D))
        gathered = all_reduce(torch.where(local[..., None], gathered, torch.zeros_like(gathered)), mesh, "ep")
        return gathered * (gate * keep).to(dt)[..., None], aux
