"""Preconditioned Crank-Nicolson MCMC over a batch of chains.

pCN proposal (prior N(m, C)):   theta' = m + sqrt(1-b^2)(theta - m) + b L xi
acceptance:                     min(1, exp(Phi(theta) - Phi(theta')))
with Phi the data misfit only — the prior cancels, which keeps the kernel
dimension-robust. Burn-in adapts log beta per chain by Robbins-Monro toward
23.4% acceptance; sampling then freezes the adapted betas.

The misfit is batched: it takes the whole (C, d) chain batch. The step loop
is a Python loop with no host synchronisation inside it. ``pcn_step`` and
``run_pcn`` accept pre-drawn standard normals and uniforms, so a test can
replay another implementation's random stream.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior

TARGET_ACCEPT = 0.234


class PCNState(NamedTuple):
    theta: torch.Tensor  # (C, d)
    phi: torch.Tensor  # (C,) data misfit at theta
    n_accept: torch.Tensor  # (C,) int32


class PCNResult(NamedTuple):
    state: PCNState
    samples: torch.Tensor  # (n_kept, C, d)
    phi_trace: torch.Tensor  # (n_kept, C)
    accept_rate: torch.Tensor  # (C,)
    beta: torch.Tensor  # (C,) final (possibly adapted) step sizes


def pcn_init(misfit_fn: Callable, theta0: torch.Tensor) -> PCNState:
    phi0 = misfit_fn(theta0)
    return PCNState(theta=theta0, phi=phi0, n_accept=torch.zeros_like(phi0, dtype=torch.int32))


def pcn_step(
    misfit_fn: Callable,
    prior: GaussianPrior,
    beta: torch.Tensor,
    state: PCNState,
    gen: Optional[torch.Generator] = None,
    *,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> tuple[PCNState, torch.Tensor]:
    """One pCN step for the chain batch. beta: scalar or per-chain (C,).
    normals (C, d) / uniforms (C,): the step's draws, else drawn from gen.
    Returns (state, accept mask)."""
    theta, phi = state.theta, state.phi
    dtype, dev = theta.dtype, theta.device
    if normals is None:
        normals = torch.randn(theta.shape, generator=gen, dtype=dtype, device=dev)
    if uniforms is None:
        uniforms = torch.rand(phi.shape, generator=gen, dtype=dtype, device=dev)
    beta = torch.as_tensor(beta, dtype=dtype, device=dev)
    b = beta[..., None] if beta.dim() == theta.dim() - 1 else beta
    xi = normals @ prior.chol.T
    mean = prior.mean
    prop = mean + torch.sqrt(1.0 - b**2) * (theta - mean) + b * xi
    phi_prop = misfit_fn(prop)
    accept = torch.log(uniforms) < phi - phi_prop
    new = PCNState(
        theta=torch.where(accept[..., None], prop, theta),
        phi=torch.where(accept, phi_prop, phi),
        n_accept=state.n_accept + accept.to(torch.int32),
    )
    return new, accept


def run_pcn(
    misfit_fn: Callable,
    prior: GaussianPrior,
    theta0: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int,
    n_burn: int = 0,
    beta=0.25,
    thin: int = 1,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> PCNResult:
    """Run pCN chains from theta0 (C, d): ``n_burn`` adaptive burn-in steps,
    then every ``thin``-th state of the remaining steps is kept.
    normals (n_steps, C, d) / uniforms (n_steps, C): optional pre-drawn
    draws for every step, in step order (burn-in first)."""
    state = pcn_init(misfit_fn, theta0)
    dtype = theta0.dtype
    draws = lambda t: dict(
        normals=None if normals is None else normals[t],
        uniforms=None if uniforms is None else uniforms[t],
    )
    log_beta = torch.log(torch.as_tensor(beta, dtype=dtype, device=theta0.device).expand(state.phi.shape))
    lo, hi = math.log(1e-4), math.log(0.9999)
    for t in range(n_burn):
        state, acc = pcn_step(misfit_fn, prior, torch.exp(log_beta), state, gen, **draws(t))
        eta = 0.5 / (1.0 + t) ** 0.6
        log_beta = torch.clamp(log_beta + eta * (acc.to(dtype) - TARGET_ACCEPT), lo, hi)
    if n_burn > 0:
        state = state._replace(n_accept=torch.zeros_like(state.n_accept))

    beta_final = torch.exp(log_beta)
    n_out = (n_steps - n_burn) // thin
    samples, phis = [], []
    t = n_burn
    for _ in range(n_out):
        for _ in range(thin):
            state, _ = pcn_step(misfit_fn, prior, beta_final, state, gen, **draws(t))
            t += 1
        samples.append(state.theta)
        phis.append(state.phi)
    n_ran = n_out * thin
    C, d = theta0.shape
    return PCNResult(
        state=state,
        samples=torch.stack(samples) if samples else theta0.new_zeros((0, C, d)),
        phi_trace=torch.stack(phis) if phis else theta0.new_zeros((0, C)),
        accept_rate=state.n_accept.to(torch.float32) / max(n_ran, 1),
        beta=beta_final,
    )


def gaussian_misfit(forward: Callable, data: torch.Tensor, noise_sigma: float) -> Callable:
    """Phi(theta) = ||d - G(theta)||^2 / (2 sigma^2), reduced over the last
    axis."""

    def phi(theta):
        r = forward(theta) - data
        return 0.5 * torch.sum(r * r, -1) / noise_sigma**2

    return phi
