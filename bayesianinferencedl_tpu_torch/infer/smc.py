"""Adaptive tempered sequential Monte Carlo: annealed importance sampling
with resampling and pCN mutations.

A population of particles moves through the tempered path

    pi_lambda(theta) ~ exp(-lambda Phi(theta)) mu0(theta),  0 = l_0 < ... = 1,

by reweighting and resampling. Each stage picks the largest step in lambda
whose incremental weights keep an ESS fraction (bisection), adds the log
mean of those weights to log Z (an estimator unbiased in Z, independent of
the stepping-stone estimate of infer/evidence.py), resamples
systematically and mutates with ``n_mutations`` pCN sweeps at the new
lambda; the sweeps' step size adapts across stages by a population
Robbins-Monro rule toward 23.4% acceptance.

G independent populations (groups) run as one batch, as the reference
vmaps its sampler over keys: every mutation sweep is one batched misfit
over all G x N particles (on the fom likelihood, one stencil-kernel
launch), and a group that has reached lambda = 1 is frozen by masks while
the others go on. Each group's result equals a single-population run on
its draws. The stage loop reads the groups' lambdas back once a stage;
nothing inside a sweep does.

Every draw can be injected: the initial particles, one resampling uniform
per stage and group, and the normals and uniforms of each stage's
mutations; without them they come from a ``torch.Generator``, per stage the
uniform first, then per mutation the normals and the uniforms.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from bayesianinferencedl_tpu_torch.infer.pcn import TARGET_ACCEPT
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul


class SMCResult(NamedTuple):
    particles: torch.Tensor  # (G, N, d) equally weighted particles (resampled at lambda = 1)
    phi: torch.Tensor  # (G, N) misfits at the final particles
    log_evidence: torch.Tensor  # (G,) log E_mu0[exp(-Phi)] per group, unbiased in Z
    n_stages: torch.Tensor  # (G,) int32 tempering stages each group used
    lambdas: torch.Tensor  # (max_stages, G) schedules, padded with 1.0 past n_stages
    ess_frac: torch.Tensor  # (max_stages, G) pre-resampling ESS / N per stage, padded 0
    accept_rate: torch.Tensor  # (max_stages, G) mutation acceptance per stage, padded 0
    beta: torch.Tensor  # (G,) the final adapted pCN step sizes


def _ess_frac(log_inc: torch.Tensor) -> torch.Tensor:
    """ESS fraction 1 / (N sum w_i^2) of incremental weights (normalised),
    over the last axis."""
    N = log_inc.shape[-1]
    lw = log_inc - torch.logsumexp(log_inc, dim=-1, keepdim=True)
    return torch.exp(-torch.logsumexp(2.0 * lw, dim=-1)) / N


def _next_lambda(lam: torch.Tensor, phi: torch.Tensor, target: float, *, iters: int = 32) -> torch.Tensor:
    """The largest lambda' in (lam, 1] whose incremental weights
    -(lambda' - lam) Phi keep ESS / N >= target, by a fixed number of
    bisection steps. lam (...,), phi (..., N)."""
    frac_at = lambda lp: _ess_frac(-(lp - lam)[..., None] * phi)
    one = torch.ones_like(lam)
    lo, hi = lam.clone(), one
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = frac_at(mid) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    # if even the full jump keeps the target, take it (it ends the run)
    return torch.where(frac_at(one) >= target, one, lo)


def _systematic_resample(u: torch.Tensor, log_w: torch.Tensor) -> torch.Tensor:
    """Systematic resampling: uniforms u (...,) and log weights (..., N) ->
    parent indices (..., N): stratified positions (u + i) / N against the
    weights' cumulative sum (side="left"), clipped to N - 1 because the
    float cumsum may end below 1."""
    N = log_w.shape[-1]
    w = torch.softmax(log_w, dim=-1)
    cdf = torch.cumsum(w, dim=-1)
    pos = (u[..., None] + torch.arange(N, dtype=w.dtype, device=w.device)) / N
    idx = torch.searchsorted(cdf.contiguous(), pos.contiguous(), side="left")
    return torch.clamp(idx, 0, N - 1)


def run_smc(
    misfit_fn: Callable,
    prior: GaussianPrior,
    gen: Optional[torch.Generator] = None,
    *,
    n_particles: int = 4096,
    n_groups: int = 1,
    n_mutations: int = 5,
    ess_target: float = 0.5,
    beta: float = 0.5,
    max_stages: int = 64,
    theta0: Optional[torch.Tensor] = None,
    resample_uniforms: Optional[torch.Tensor] = None,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> SMCResult:
    """Adaptive tempered SMC from the prior to the posterior, for n_groups
    populations of n_particles each, as one batch.

    misfit_fn: the untempered data misfit on working coordinates, batched
    over (B, d). n_mutations pCN sweeps follow each resampling; the sweeps'
    beta adapts toward 23.4% acceptance across stages, clipped to [1e-4,
    0.9999]. max_stages bounds the stages; a group that hits it ends with
    lambda < 1 (check n_stages < max_stages).

    Draws, each optional: theta0 (G, N, d) initial particles (default prior
    draws); resample_uniforms (max_stages, G); normals (max_stages,
    n_mutations, G, N, d) and uniforms (max_stages, n_mutations, G, N).

    log_evidence estimates log Z = log E_mu0[exp(-Phi)] per group (the
    AIS/SMC identity Z = prod_t mean_i inc_i^(t)); the particles are an
    equally weighted posterior sample."""
    G, N = n_groups, n_particles
    dtype, dev = prior.mean.dtype, prior.mean.device
    d = prior.dim
    if theta0 is None:
        theta = prior.sample(gen, (G, N))
    else:
        theta = torch.as_tensor(theta0, dtype=dtype, device=dev).reshape(G, N, d)
    eval_phi = lambda th: misfit_fn(th.reshape(G * N, d)).reshape(G, N)
    phi = eval_phi(theta)

    lam = torch.zeros(G, dtype=dtype, device=dev)
    logz = torch.zeros(G, dtype=dtype, device=dev)
    b = torch.full((G,), beta, dtype=dtype, device=dev)
    n_st = torch.zeros(G, dtype=torch.int32, device=dev)
    lams = torch.ones((max_stages, G), dtype=dtype, device=dev)  # padded at 1: the target reached
    esss = torch.zeros((max_stages, G), dtype=dtype, device=dev)
    accs = torch.zeros((max_stages, G), dtype=dtype, device=dev)
    log_n = math.log(N)
    for t in range(max_stages):
        active = lam < 1.0
        if not bool(active.any()):  # the stage loop's one read-back
            break
        lam_new = torch.where(active, _next_lambda(lam, phi, ess_target), lam)
        log_inc = -(lam_new - lam)[:, None] * phi
        # the unbiased increment: the log mean of the incremental weights
        # (the weights are equal after the previous stage's resampling)
        logz = torch.where(active, logz + torch.logsumexp(log_inc, dim=-1) - log_n, logz)
        ess = _ess_frac(log_inc)
        u = (torch.rand((G,), generator=gen, dtype=dtype, device=dev) if resample_uniforms is None
             else torch.as_tensor(resample_uniforms[t], dtype=dtype, device=dev))
        parents = _systematic_resample(u, log_inc)
        keep = active[:, None, None]
        theta = torch.where(keep, torch.gather(theta, 1, parents[..., None].expand(G, N, d)), theta)
        phi = torch.where(active[:, None], torch.gather(phi, 1, parents), phi)

        # n_mutations pCN sweeps targeting pi_lam_new, one batched misfit each
        acc = torch.zeros(G, dtype=dtype, device=dev)
        sb = torch.sqrt(1.0 - b * b)[:, None, None]
        for k in range(n_mutations):
            z = (torch.randn((G, N, d), generator=gen, dtype=dtype, device=dev) if normals is None
                 else torch.as_tensor(normals[t, k], dtype=dtype, device=dev))
            with fp32_matmul():
                xi = z @ prior.chol.T
            prop = prior.mean + sb * (theta - prior.mean) + b[:, None, None] * xi
            phi_p = eval_phi(prop)
            log_alpha = lam_new[:, None] * (phi - phi_p)
            uu = (torch.rand((G, N), generator=gen, dtype=dtype, device=dev) if uniforms is None
                  else torch.as_tensor(uniforms[t, k], dtype=dtype, device=dev))
            ok = (torch.log(uu) < log_alpha) & active[:, None]
            theta = torch.where(ok[..., None], prop, theta)
            phi = torch.where(ok, phi_p, phi)
            acc = acc + torch.mean(ok.to(dtype), dim=-1)
        acc = acc / n_mutations
        # population Robbins-Monro on log beta toward the pCN target rate
        eta = 0.5 / math.sqrt(1.0 + t)
        b_new = torch.clamp(b * torch.exp(eta * (acc - TARGET_ACCEPT)), 1e-4, 0.9999)
        b = torch.where(active, b_new, b)
        lams[t] = torch.where(active, lam_new, lams[t])
        esss[t] = torch.where(active, ess, esss[t])
        accs[t] = torch.where(active, acc, accs[t])
        n_st = n_st + active.to(torch.int32)
        lam = lam_new
    return SMCResult(particles=theta, phi=phi, log_evidence=logz, n_stages=n_st, lambdas=lams,
                     ess_frac=esss, accept_rate=accs, beta=b)
