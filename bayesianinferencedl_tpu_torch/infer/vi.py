"""Automatic differentiation variational inference (ADVI; Kucukelbir et al.
2017): a Gaussian posterior approximation by stochastic gradient ascent on
the ELBO.

q(Y) = N(mu, L L^T) lives in the whitened frame theta = m_ref + L_ref Y
(the prior's by default, or ``ref=(mean, chol)``, e.g. a Laplace frame);
theta_mean and theta_chol push the fit back to working coordinates
exactly. Each step draws n_mc reparameterised points Y = mu + eps L^T and
takes one forward and one reverse pass over the whole (n_mc, d) batch
through the differentiable misfit
(``Pipeline.batched_forward_fn(..., differentiable=True)``); the entropy is
analytic (sum log diag L). Adam runs on the leaves [mu, raw] with a step
size that decays linearly over the global step index.

q is Gaussian: exact where the posterior is Gaussian in the frame (the
full-rank family then recovers it), a mode-seeking KL(q||p) approximation
otherwise (mean-field shrinks correlated marginals; one basin of a
multimodal posterior). The per-step normals come from a
``torch.Generator`` in step order, or pre-drawn as eps (n_steps, n_mc, d).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.infer.samplers import inv_chol
from bayesianinferencedl_tpu_torch.models.surrogate import adam_init, adam_update
from bayesianinferencedl_tpu_torch.parallel.mesh import mean_all
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul

# the default of lr_decay: the step size decays linearly from lr to lr * lr_decay
# over the run (the reference's default, shared with SVGD's)
LR_DECAY = 0.05


class VIResult(NamedTuple):
    mu: torch.Tensor  # (d,) variational mean, whitened ref frame
    L: torch.Tensor  # (d, d) variational Cholesky factor, whitened ref frame (diagonal for mean-field)
    theta_mean: torch.Tensor  # (d,) posterior mean, working coordinates
    theta_chol: torch.Tensor  # (d, d) posterior Cholesky factor, working coordinates
    elbo_trace: torch.Tensor  # (n_steps,) per-step Monte-Carlo ELBO (entropy constant dropped)
    n_forward: int  # differentiable forward evaluations, n_mc x n_steps


def vi_sample(res: VIResult, gen: Optional[torch.Generator] = None, shape=(), *,
              eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """theta ~ q in working coordinates: theta_mean + eps @ theta_chol^T.
    eps (*shape, d): the standard normals, else drawn from gen."""
    d = res.theta_mean.shape[0]
    if eps is None:
        eps = torch.randn((*shape, d), generator=gen, dtype=res.theta_mean.dtype,
                          device=res.theta_mean.device)
    with fp32_matmul():
        return res.theta_mean + eps @ res.theta_chol.T


def _chol_of(params: dict, rank: str) -> torch.Tensor:
    """Unconstrained params -> lower-triangular L with a positive diagonal."""
    raw = params["raw"]
    if rank == "meanfield":
        return torch.diag(torch.exp(raw))
    return torch.tril(raw, -1) + torch.diag(torch.exp(torch.diagonal(raw)))


def _log_det(params: dict, rank: str) -> torch.Tensor:
    raw = params["raw"]
    return torch.sum(raw) if rank == "meanfield" else torch.sum(torch.diagonal(raw))


def run_advi(
    misfit_fn: Callable,
    prior: GaussianPrior,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int = 1500,
    n_mc: int = 32,
    rank: str = "full",
    lr: float = 0.05,
    lr_decay: float = LR_DECAY,
    theta0: Optional[torch.Tensor] = None,
    ref=None,
    segment: Optional[int] = None,
    eps: Optional[torch.Tensor] = None,
    group=None,
) -> VIResult:
    """Fit q = N(mu, L L^T) in the whitened ref frame by maximising the
    reparameterised ELBO and return it pushed back to working coordinates.
    misfit_fn is batched and differentiable, on working coordinates.

    rank: "full" (dense lower-triangular L) or "meanfield" (diagonal). The
    step size decays linearly from lr to lr * lr_decay over the run (the
    final iterate is the estimate). theta0 starts mu (default the frame's
    centre); L starts at the identity. eps (n_steps, n_mc, d): pre-drawn
    normals for every step, else drawn from gen in step order. One eager
    loop runs every step: ``segment``, the reference's scan chunk size, is
    accepted and changes nothing (its segments run on the global step
    index, so neither does it there). group: the mesh the Monte Carlo axis
    is sharded over (``parallel.sharding.sharded_advi``): n_mc and eps are
    this rank's, and the loss and each gradient become means over the
    ranks before every replicated Adam update."""
    if rank not in ("full", "meanfield"):
        raise ValueError(f"rank must be 'full' or 'meanfield', got {rank!r}")
    d = prior.dim
    ref_mean, ref_chol = ref if ref is not None else (prior.mean, prior.chol)
    dtype, dev = ref_mean.dtype, ref_mean.device
    Li = inv_chol(prior.chol)

    if theta0 is None:
        mu0 = torch.zeros((d,), dtype=dtype, device=dev)
    else:
        with fp32_matmul():
            mu0 = (torch.as_tensor(theta0, dtype=dtype, device=dev) - ref_mean) @ inv_chol(ref_chol).T
    raw0 = torch.zeros((d,) if rank == "meanfield" else (d, d), dtype=dtype, device=dev)
    params = [mu0.clone(), raw0]  # the leaves in the reference's order: mu, raw
    opt = adam_init(params)

    def loss_of(mu, raw, e):
        p = {"mu": mu, "raw": raw}
        Y = mu + e @ _chol_of(p, rank).T
        theta = ref_mean + Y @ ref_chol.T
        w = (theta - prior.mean) @ Li.T
        nlp = misfit_fn(theta) + 0.5 * torch.sum(w * w, dim=-1)
        return torch.mean(nlp) - _log_det(p, rank)

    elbo = []
    for t in range(n_steps):
        e = (torch.randn((n_mc, d), generator=gen, dtype=dtype, device=dev) if eps is None
             else torch.as_tensor(eps[t], dtype=dtype, device=dev))
        with torch.enable_grad(), fp32_matmul():
            mu, raw = (p.detach().requires_grad_() for p in params)
            loss = loss_of(mu, raw, e)
            grads = torch.autograd.grad(loss, (mu, raw))
        if group is not None:
            loss, *grads = mean_all(group, [loss.detach(), *grads])
        frac = torch.tensor(t, dtype=dtype, device=dev) / max(n_steps, 1)
        opt = adam_update(params, list(grads), opt, lr * (1.0 - (1.0 - lr_decay) * frac))
        elbo.append(-loss.detach())  # the ELBO up to the dropped entropy constant

    mu, raw = params
    L = _chol_of({"mu": mu, "raw": raw}, rank)
    with fp32_matmul():
        theta_mean = ref_mean + mu @ ref_chol.T
        theta_chol = ref_chol @ L
    return VIResult(
        mu=mu, L=L, theta_mean=theta_mean, theta_chol=theta_chol,
        elbo_trace=torch.stack(elbo) if elbo else ref_mean.new_zeros((0,)),
        n_forward=n_mc * n_steps,
    )
