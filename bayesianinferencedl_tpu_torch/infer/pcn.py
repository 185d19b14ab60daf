"""Preconditioned Crank-Nicolson MCMC over a batch of chains.

pCN proposal (prior N(m, C)):   theta' = m + sqrt(1-b^2)(theta - m) + b L xi
acceptance:                     min(1, exp(Phi(theta) - Phi(theta')))
with Phi the data misfit only — the prior cancels, which keeps the kernel
dimension-robust. Burn-in adapts log beta per chain by Robbins-Monro toward
23.4% acceptance; sampling then freezes the adapted betas. A tempered level
(infer/tempering.py) runs the same step at inverse temperature lambda,
accepting with min(1, exp(lambda (Phi(theta) - Phi(theta')))).

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
from bayesianinferencedl_tpu_torch.infer.segmented import accept_rate_spec, drive_segments
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul

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
    lam: Optional[torch.Tensor] = None,
) -> tuple[PCNState, torch.Tensor]:
    """One pCN step for the chain batch. beta: scalar or per-chain (C,).
    normals (C, d) / uniforms (C,): the step's draws, else drawn from gen.
    lam: per-chain inverse temperatures (C,) tempering the acceptance, or
    None for the untempered target. Returns (state, accept mask)."""
    theta, phi = state.theta, state.phi
    dtype, dev = theta.dtype, theta.device
    if normals is None:
        normals = torch.randn(theta.shape, generator=gen, dtype=dtype, device=dev)
    if uniforms is None:
        uniforms = torch.rand(phi.shape, generator=gen, dtype=dtype, device=dev)
    beta = torch.as_tensor(beta, dtype=dtype, device=dev)
    b = beta[..., None] if beta.dim() == theta.dim() - 1 else beta
    with fp32_matmul():
        xi = normals @ prior.chol.T
    mean = prior.mean
    prop = mean + torch.sqrt(1.0 - b**2) * (theta - mean) + b * xi
    phi_prop = misfit_fn(prop)
    log_alpha = phi - phi_prop if lam is None else lam * (phi - phi_prop)
    accept = torch.log(uniforms) < log_alpha
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
    adapt: bool = True,
    adapt_t0: float = 0.0,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> PCNResult:
    """Run pCN chains from theta0 (C, d): ``n_burn`` burn-in steps, adaptive
    unless ``adapt`` is False (then beta stays as given), then every
    ``thin``-th state of the remaining steps is kept. beta:
    scalar or per-chain (C,). adapt_t0: the global index of the first step,
    which a segmented run passes so the Robbins-Monro clock runs on
    across segments. normals (n_steps, C, d) / uniforms (n_steps, C):
    optional pre-drawn draws for every step, in step order (burn-in
    first)."""
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
        if adapt:
            eta = 0.5 / (1.0 + t + adapt_t0) ** 0.6
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


def run_pcn_aux(
    misfit_aux_fn: Callable,
    prior: GaussianPrior,
    theta0: torch.Tensor,
    aux0: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int,
    n_burn: int = 0,
    beta=0.25,
    adapt: bool = True,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> tuple[PCNResult, torch.Tensor]:
    """pCN whose likelihood carries per-chain auxiliary state:
    misfit_aux_fn(props (C, d), aux) -> (phi (C,), aux_prop), for example
    the fom misfit returning its solution fields, which warm-start the next
    proposal's solve (``api.fom_misfit_aux``: local proposals, few
    iterations). aux (C, ...) is kept per chain on accept as theta is. The
    step size adapts per chain in the first n_burn steps (clock from 0);
    only post-burn accepts count. Draws as for ``run_pcn``. Returns
    (PCNResult, the final aux)."""
    dtype, dev = theta0.dtype, theta0.device
    phi, aux = misfit_aux_fn(theta0, aux0)
    state = PCNState(theta=theta0, phi=phi, n_accept=torch.zeros_like(phi, dtype=torch.int32))
    log_beta = torch.log(torch.as_tensor(beta, dtype=dtype, device=dev).expand(phi.shape))
    lo, hi = math.log(1e-4), math.log(0.9999)
    samples, phis = [], []
    for t in range(n_steps):
        xi = normals[t] if normals is not None else torch.randn(theta0.shape, generator=gen,
                                                                dtype=dtype, device=dev)
        u = uniforms[t] if uniforms is not None else torch.rand(phi.shape, generator=gen, dtype=dtype,
                                                                device=dev)
        b = torch.exp(log_beta)[..., None]
        with fp32_matmul():
            xi = xi @ prior.chol.T
        prop = prior.mean + torch.sqrt(1.0 - b**2) * (state.theta - prior.mean) + b * xi
        phi_prop, aux_prop = misfit_aux_fn(prop, aux)
        accept = torch.log(u) < (state.phi - phi_prop)
        aux = torch.where(accept.reshape((-1,) + (1,) * (aux.dim() - 1)), aux_prop, aux)
        state = PCNState(theta=torch.where(accept[..., None], prop, state.theta),
                         phi=torch.where(accept, phi_prop, state.phi),
                         n_accept=state.n_accept + (accept & (t >= n_burn)).to(torch.int32))
        if adapt:  # eta is 0 after burn-in, as in the reference's clipped update
            eta = 0.5 / (1.0 + t) ** 0.6 if t < n_burn else 0.0
            log_beta = torch.clamp(log_beta + eta * (accept.to(dtype) - TARGET_ACCEPT), lo, hi)
        if t >= n_burn:
            samples.append(state.theta)
            phis.append(state.phi)
    C, d = theta0.shape
    kept = max(n_steps - n_burn, 0)
    return PCNResult(
        state=state,
        samples=torch.stack(samples) if samples else theta0.new_zeros((0, C, d)),
        phi_trace=torch.stack(phis) if phis else theta0.new_zeros((0, C)),
        accept_rate=state.n_accept.to(torch.float32) / max(kept, 1),
        beta=torch.exp(log_beta),
    ), aux


def run_pcn_segmented(
    misfit_fn: Callable,
    prior: GaussianPrior,
    theta0: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int,
    n_burn: int = 0,
    beta=0.25,
    segment: int = 64,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> PCNResult:
    """pCN in segments of at most ``segment`` steps (``infer.segmented``),
    for likelihoods with a full-order solve in every step. Chain states and
    adapted betas carry across segments, the adaptation clock runs on and
    the accept rate covers the whole post-burn run, so the result has the
    law of one long run. Draws as for ``run_pcn``, for the whole run."""
    betas0 = torch.as_tensor(beta, dtype=theta0.dtype, device=theta0.device).expand(
        theta0.shape[:-1])
    part = lambda a, start, this: None if a is None else a[start:start + this]

    def seg(carry, this, burn, start):
        thetas, betas = carry
        res = run_pcn(
            misfit_fn, prior, thetas, gen, n_steps=this, n_burn=burn, beta=betas,
            adapt_t0=float(start), normals=part(normals, start, this),
            uniforms=part(uniforms, start, this),
        )
        return res, (res.state.theta, res.beta)

    res, (_, betas), samples, phis, rates, _ = drive_segments(
        seg, (theta0, betas0), n_steps=n_steps, n_burn=n_burn, segment=segment,
        rates={"accept": accept_rate_spec()},
    )
    return PCNResult(state=res.state, samples=samples, phi_trace=phis,
                     accept_rate=rates["accept"], beta=betas)


def gaussian_misfit(forward: Callable, data: torch.Tensor, noise_sigma: float) -> Callable:
    """Phi(theta) = ||d - G(theta)||^2 / (2 sigma^2), reduced over the last
    axis."""

    def phi(theta):
        r = forward(theta) - data
        return 0.5 * torch.sum(r * r, -1) / noise_sigma**2

    return phi


def marginal_misfit(forward: Callable, data: torch.Tensor, *, a0: float, b0: float) -> Callable:
    """The potential with the observation noise sigma unknown and integrated
    out under the conjugate prior sigma^2 ~ InvGamma(a0, b0). With
    S(theta) = ||d - G(theta)||^2 and m observations,

        p(d | theta) = (2 pi)^(-m/2) b0^a0 / Gamma(a0)
                       * Gamma(a0 + m/2) / (b0 + S/2)^(a0 + m/2),

    so Phi(theta) = (a0 + m/2) log(b0 + S/2) + const, with the constant kept
    exact: the tempered samplers' evidence then stays the true
    prior-predictive mass of the data. The noise prior must be proper
    (a0 > 0, b0 > 0): in the Jeffreys limit the theta posterior is improper
    wherever the forward model can interpolate the data. Given theta the
    noise stays conjugate, sigma^2 ~ InvGamma(a0 + m/2, b0 + S/2)
    (utils/ppc.py noise_posterior). Reduced over the last axis."""
    m = data.shape[-1]
    if not (a0 > 0.0 and b0 > 0.0):
        raise ValueError(f"need a proper noise prior: a0 > 0, b0 > 0 (got {a0}, {b0})")
    const = (
        0.5 * m * math.log(2.0 * math.pi)
        - a0 * math.log(b0)
        + math.lgamma(a0)
        - math.lgamma(a0 + 0.5 * m)
    )

    def phi(theta):
        r = forward(theta) - data
        s = torch.sum(r * r, -1)
        return (a0 + 0.5 * m) * torch.log(b0 + 0.5 * s) + const

    return phi
