"""The reference's first training updates: the batches drawn again from the
training generator's seed, and each update worked out from the equations.

An update sums the gradients of k microbatches, each the mean loss over the
rows at and after its ``sep`` (the same ``sep`` for all its datasets), clips
the sum to a global norm of 1 by g / max(1, |g|), and takes an Adam step
(b1 0.9, b2 0.999, eps 1e-8, bias-corrected) at the learning rate ``lr``.
"""

from __future__ import annotations

import torch

from pfnbench import check
from pfnbench.reference import part

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def sep_weights(kind: str, max_len: int) -> torch.Tensor:
    """The eval-position sampler's unnormalised weights over 0 .. max_len-1
    in float32, on the host: uniform; weighted, 1/(max_len - i); mixture,
    0.9 of the normalised weighted and 0.1 uniform over the first
    min(300, max_len)."""
    pos = torch.arange(max_len, dtype=torch.float32)
    if kind == "uniform":
        return torch.ones(max_len, dtype=torch.float32)
    w = 1.0 / (max_len - pos)
    if kind == "weighted":
        return w
    if kind == "mixture":
        w = w / w.sum()
        cap = min(300, max_len)
        return 0.9 * w + 0.1 * torch.where(pos < cap, 1.0 / cap, 0.0)
    raise ValueError(f"unknown eval-position sampler {kind!r}")


def replay(generator: torch.Generator, train: dict, prior: dict, batch_size: int, k: int, steps: int,
           mode: str = "f32") -> list[list[dict]]:
    """The batches of the first ``steps`` updates from ``generator``, drawn
    as the training step draws them: per microbatch the prior's datasets,
    then one sep."""
    prior_mod = part("prior", prior["kind"])
    weights = sep_weights(train["eval_pos_sampler"], train.get("eval_pos_max") or train["bptt"]).to(generator.device)
    out = []
    for _ in range(steps):
        mbs = []
        for _ in range(k):
            mb = prior_mod.draw(generator, batch_size, train["bptt"], prior, mode)
            mb["sep"] = int(torch.multinomial(weights, 1, generator=generator))
            mbs.append(mb)
        out.append(mbs)
    return out


def follow(net, params0: dict, model: dict, n_out: int, criterion: str, borders, steps: list[list[dict]], lr: float,
           prec: dict | None = None, drop_half: bool = False) -> dict:
    """Run the updates ``steps`` (from :func:`replay`) from ``params0``
    through ``net``, the reference model of the configuration's kind
    (``part("model", kind)``), of sizes ``model`` and head width ``n_out``;
    ``prec`` None is ``net.F32``.

    Returns the loss of each update (the mean over its microbatches of each
    one's mean loss), the per-leaf norms of the first update's clipped
    gradient, the per-leaf norms of the parameters' change after the last
    update, and the first update's norm before the clip. ``drop_half``
    leaves out the second half of every microbatch's datasets (a planted
    fault)."""
    crit = part("criterion", criterion)
    prec = net.F32 if prec is None else prec
    names = list(params0)
    params = {n: params0[n].detach().float().clone().requires_grad_(True) for n in names}
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    losses, first_grads, first_norm = [], None, None
    for t, mbs in enumerate(steps, 1):
        grads = {n: torch.zeros_like(params[n]) for n in names}
        loss_sum = 0.0
        for mb in mbs:
            x, y, sep = mb["x"].float(), mb["y"].float(), mb["sep"]
            if drop_half:
                x, y = x[: x.shape[0] // 2], y[: y.shape[0] // 2]
            B, T = y.shape
            den = max(B * (T - sep), 1)
            num_total = 0.0
            step = net.block_rows(model, n_out, T)
            for s in range(0, B, step):
                out = net.forward(params, model, x[s:s + step], y[s:s + step], sep, prec)
                num = crit.nll(out, y[s:s + step], borders)[:, sep:].sum()
                for n, g in zip(names, torch.autograd.grad(num / den, [params[n] for n in names])):
                    grads[n] += g
                num_total += float(num.detach())
            loss_sum += num_total / den
        losses.append(loss_sum / len(mbs))
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
            divisor = max(1.0, float(norm))
            for n in names:
                grads[n] /= divisor
            if t == 1:
                first_norm = float(norm)
                first_grads = check.leaf_norms(grads)
            for n in names:
                m[n].mul_(BETA1).add_(grads[n], alpha=1 - BETA1)
                v[n].mul_(BETA2).addcmul_(grads[n], grads[n], value=1 - BETA2)
                m_hat = m[n] / (1 - BETA1 ** t)
                v_hat = v[n] / (1 - BETA2 ** t)
                params[n] -= lr * m_hat / (v_hat.sqrt() + EPS)
    with torch.no_grad():
        change = check.leaf_norms({n: params[n] - params0[n].float() for n in names})
    return {"losses": losses, "grad_leaf_norms": first_grads, "change_leaf_norms": change, "grad_norm": first_norm}
