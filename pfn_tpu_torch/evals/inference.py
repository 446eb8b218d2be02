"""Approximate-inference oracles: SVI (diagonal-normal guide), adaptive HMC
and SVGD.

Port of ``pfn_tpu/evals/inference.py`` (which replaces the reference's Pyro
AutoDiagonalNormal SVI, NUTS and SVGD, reference
mcmc_svi_transformer_on_bayesian.py:211-267, tabular.py:414-462). They are
the oracles the PFN is compared against, not the product.

How it maps to PyTorch:
  * Parameters are a dict of tensors. ``log_joint(params)`` returns a tensor
    of shape ``batch_shape``: the leading ``batch_shape`` dims of every leaf
    index independent problems, which replaces the JAX package's
    ``jax.vmap`` over problems. The problems share nothing, so the gradient
    of the summed log densities is each problem's own gradient, and Adam,
    being elementwise, updates each problem as its own optimizer would.
  * Every draw comes from an explicit ``torch.Generator`` on the data's
    device, in place of a key.
  * Adam is ``torch.optim.Adam`` with its default eps (1e-8), whose update
    equals optax's ``adam``: lr * m_hat / (sqrt(v_hat) + eps).
  * HMC adapts one step size per problem by dual averaging (the JAX
    function, vmapped, does the same).
  * ``svgd`` takes no key (the JAX function's is unused) and a
    ``log_prob`` over the particle batch, (n, dim) -> (n,), in place of a
    per-particle function vmapped.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from pfn_tpu_torch.priors.transforms import median


def _event_sum(t: torch.Tensor, batch_ndim: int) -> torch.Tensor:
    """Sum over every dim after the first ``batch_ndim``."""
    return t.sum(dim=tuple(range(batch_ndim, t.ndim))) if t.ndim > batch_ndim else t


# ---------------------------------------------------------------------------
# SVI with a diagonal-normal guide (AutoDiagonalNormal parity)
# ---------------------------------------------------------------------------

class SVIResult(NamedTuple):
    mu: dict
    log_sigma: dict
    losses: torch.Tensor  # (num_steps, *batch_shape): the negative ELBO estimate of each step

    def sample(self, generator: torch.Generator, num_samples: int = 1) -> dict:
        """Parameter draws from the fitted guide: each leaf (num_samples,
        *leaf shape)."""
        return {name: m + self.log_sigma[name].exp()
                * torch.randn((num_samples, *m.shape), generator=generator, device=m.device, dtype=m.dtype)
                for name, m in self.mu.items()}


def svi(log_joint: Callable, init_params: dict, generator: torch.Generator, num_steps: int = 400,
        lr: float = 1e-3, num_particles: int = 1, batch_shape: tuple = ()) -> SVIResult:
    """Fit q(theta) = N(mu, diag(sigma^2)) by maximising the ELBO with the
    reparameterisation trick (Trace_ELBO parity, one particle by default),
    sigma starting at exp(-2.3) ~ 0.1. ``batch_shape``: the leading dims of
    every leaf that index independent problems, the shape of
    ``log_joint``'s value."""
    nb = len(batch_shape)
    mu = {k: torch.as_tensor(v).detach().clone().requires_grad_() for k, v in init_params.items()}
    log_sigma = {k: torch.full_like(v, -2.3).requires_grad_() for k, v in mu.items()}
    optimizer = torch.optim.Adam([*mu.values(), *log_sigma.values()], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    # log q(theta) = -0.5 sum(eps^2) - sum(log sigma) - n log(2 pi) / 2.
    log_q_const = 0.5 * sum(math.prod(m.shape[nb:]) for m in mu.values()) * math.log(2 * math.pi)
    losses = []
    for _ in range(num_steps):
        optimizer.zero_grad(set_to_none=True)
        elbo = 0.0
        for _ in range(num_particles):
            eps = {k: torch.randn(m.shape, generator=generator, device=m.device, dtype=m.dtype) for k, m in mu.items()}
            theta = {k: mu[k] + log_sigma[k].exp() * eps[k] for k in mu}
            log_q = -sum(0.5 * _event_sum(eps[k] * eps[k], nb) + _event_sum(log_sigma[k], nb) for k in mu)
            elbo = elbo + log_joint(theta) - (log_q - log_q_const)
        loss = -elbo / num_particles
        loss.sum().backward()
        optimizer.step()
        losses.append(loss.detach())
    return SVIResult(mu={k: v.detach() for k, v in mu.items()},
                     log_sigma={k: v.detach() for k, v in log_sigma.items()}, losses=torch.stack(losses))


# ---------------------------------------------------------------------------
# Adaptive HMC (the NUTS-role oracle)
# ---------------------------------------------------------------------------

def _ravel(params: dict, nb: int):
    """(flat (*batch, D) tensor, unravel) of a dict of leaves whose first
    ``nb`` dims are the batch."""
    names = list(params)
    batch = params[names[0]].shape[:nb]
    shapes = [params[k].shape[nb:] for k in names]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([params[k].reshape(*batch, -1) for k in names], dim=-1)

    def unravel(q: torch.Tensor) -> dict:
        lead = q.shape[:-1]
        return {k: part.reshape((*lead, *s)) for k, s, part in zip(names, shapes, q.split(sizes, dim=-1))}

    return flat, unravel


def hmc(log_prob: Callable, init_params: dict, generator: torch.Generator, num_samples: int = 500,
        num_warmup: int = 300, num_leapfrog: int = 20, init_step_size: float = 0.1, target_accept: float = 0.8,
        batch_shape: tuple = ()):
    """Adaptive HMC over a dict of parameters.

    Warm-up adapts each problem's step size by dual averaging toward
    ``target_accept`` (Hoffman & Gelman 2014: gamma 0.05, t0 10, kappa
    0.75); sampling keeps it fixed at the averaged value. A trajectory whose
    energy is NaN is rejected and counts as acceptance 0. The log density
    and gradient at the current point are kept from the step that reached
    it, so a trajectory costs ``num_leapfrog`` gradients (the JAX function
    computes them again, to the same values). Returns (samples,
    each leaf (num_samples, *leaf shape); the mean acceptance of the
    sampling phase, shape ``batch_shape``)."""
    nb = len(batch_shape)
    q, unravel = _ravel({k: torch.as_tensor(v).detach() for k, v in init_params.items()}, nb)
    device, dtype = q.device, q.dtype

    def value_and_grad(q):
        q = q.detach().requires_grad_()
        v = log_prob(unravel(q))
        return v.detach(), torch.autograd.grad(v.sum(), q)[0]

    def hmc_step(q, v, g, eps):
        """One trajectory of ``num_leapfrog`` leapfrog steps from q, whose
        log density v and gradient g are known; returns the next (q, v, g)
        and the acceptance probability."""
        p = torch.randn(q.shape, generator=generator, device=device, dtype=dtype)
        u = torch.rand(batch_shape, generator=generator, device=device, dtype=dtype)
        h0 = v - 0.5 * (p ** 2).sum(-1)
        e = eps[..., None]
        q_new, p_new = q, p + 0.5 * e * g
        for i in range(num_leapfrog):
            q_new = q_new + e * p_new
            v_new, g_new = value_and_grad(q_new)
            p_new = p_new + (e if i < num_leapfrog - 1 else 0.5 * e) * g_new
        h1 = v_new - 0.5 * (p_new ** 2).sum(-1)
        log_accept = torch.minimum(torch.zeros_like(h1), h1 - h0)
        accept = torch.log(u) < log_accept  # False where the energy is NaN
        q, v, g = (torch.where(accept[..., None], q_new, q), torch.where(accept, v_new, v),
                   torch.where(accept[..., None], g_new, g))
        return q, v, g, torch.nan_to_num(log_accept.exp())

    # Dual-averaging warm-up.
    mu_da = math.log(10.0 * init_step_size)
    gamma, t0, kappa = 0.05, 10.0, 0.75
    log_eps = torch.full(batch_shape, math.log(init_step_size), device=device, dtype=dtype)
    log_eps_bar = log_eps.clone()
    h_bar = torch.zeros(batch_shape, device=device, dtype=dtype)
    v, g = value_and_grad(q)
    for t in range(1, num_warmup + 1):
        q, v, g, a = hmc_step(q, v, g, log_eps.exp())
        h_bar = (1 - 1 / (t + t0)) * h_bar + (target_accept - a) / (t + t0)
        log_eps = mu_da - math.sqrt(t) / gamma * h_bar
        w = t ** (-kappa)
        log_eps_bar = w * log_eps + (1 - w) * log_eps_bar
    eps = log_eps_bar.exp()
    qs, accepts = [], []
    for _ in range(num_samples):
        q, v, g, a = hmc_step(q, v, g, eps)
        qs.append(q)
        accepts.append(a)
    return unravel(torch.stack(qs)), torch.stack(accepts).mean(0)


# ---------------------------------------------------------------------------
# SVGD (Stein variational gradient descent)
# ---------------------------------------------------------------------------

def svgd(log_prob: Callable, init_particles: torch.Tensor, num_steps: int = 500, lr: float = 1e-2) -> torch.Tensor:
    """SVGD with an RBF kernel and the median heuristic bandwidth (the
    reference's optional SVGD path, mcmc_svi...py:222-232). ``log_prob``
    maps the particles (n, dim) to their log densities (n,); the bandwidth
    takes the true median of the n^2 squared distances (the mean of the two
    middle values, as ``jnp.median``; ``torch.median`` would take the lower
    one)."""
    x = torch.as_tensor(init_particles).detach()
    n = x.shape[0]
    for _ in range(num_steps):
        xg = x.requires_grad_()
        glp = torch.autograd.grad(log_prob(xg).sum(), xg)[0]
        x = x.detach()
        diff = x[:, None, :] - x[None, :, :]
        d2 = (diff ** 2).sum(-1)
        h = torch.sqrt(0.5 * median(d2.reshape(1, -1)).reshape(()) / math.log(n + 1.0)) + 1e-8
        K = torch.exp(-d2 / (2 * h ** 2))
        # dK[i, j] = (x_i - x_j) / h^2 * K[i, j], the gradient of k(x_j, x_i)
        # in x_j; the repulsion term is its sum over j (axis 1: axis 0 flips
        # the sign and collapses the particles onto the mode).
        dK = diff / h ** 2 * K[..., None]
        x = x + lr * (K @ glp + dK.sum(1)) / n
    return x
