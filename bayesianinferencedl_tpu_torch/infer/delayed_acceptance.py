"""Delayed-acceptance pCN: the exact fine posterior at near-coarse cost.

A subchain of S cheap steps targets the coarse (surrogate) posterior
pi_c ~ exp(-Phi_c) x prior; its endpoint is then Metropolis-corrected
against the exact potential Phi_f (Christen & Fox 2005). Because the S-step
coarse kernel is reversible w.r.t. pi_c, the outer acceptance ratio is

    alpha = min{1, exp[(Phi_f(t) - Phi_f(t*)) - (Phi_c(t) - Phi_c(t*))]}

(the prior terms cancel), and the stationary law is exactly
pi_f ~ exp(-Phi_f) x prior for any S. With an accurate surrogate the outer
acceptance sits near 1 and the sampler advances S steps per fine evaluation:
one batched fine misfit for all chains per outer step.

Inner step sizes adapt per chain (Robbins-Monro) during burn-in only, so the
sampling-phase kernel is homogeneous and exactness holds for the kept
samples. The step loop is a Python loop with no host synchronisation inside
it. Every sampler here takes optional pre-drawn normals and uniforms, so a
test can replay another implementation's random stream; without them the
draws come from a ``torch.Generator`` in step order: per inner step its
normals, then its uniforms; per outer step the inner draws, then the outer
uniform.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from bayesianinferencedl_tpu_torch.infer.pcn import TARGET_ACCEPT, PCNState, pcn_step
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.infer.segmented import (
    accept_rate_spec,
    drive_segments,
    inner_accept_rate_spec,
)


class DAState(NamedTuple):
    theta: torch.Tensor  # (C, d)
    phi_f: torch.Tensor  # (C,) fine (exact) misfit at theta
    phi_c: torch.Tensor  # (C,) coarse (surrogate) misfit at theta
    n_accept: torch.Tensor  # (C,) int32 outer accepts


class InnerKernel(NamedTuple):
    """The coarse subchain kernel. Exactness only needs the S-step kernel to
    be reversible w.r.t. the coarse posterior, so any MH kernel qualifies.

    init(theta, phi_c) -> inner state; step(beta, state, gen, normals=,
    uniforms=) -> (state, accept mask); theta/phi extract the endpoint and
    its coarse misfit; target is the Robbins-Monro acceptance target."""

    init: Callable
    step: Callable
    theta: Callable
    phi: Callable
    target: float


def pcn_inner_kernel(misfit_coarse: Callable, prior: GaussianPrior, lam=None) -> InnerKernel:
    """pCN subchains on the (batched) coarse misfit; lam: per-chain inverse
    temperatures (a tempered level's target exp(-lam Phi_c) x prior), or
    None."""

    def init(theta, phi_c):
        return PCNState(theta=theta, phi=phi_c, n_accept=torch.zeros_like(phi_c, dtype=torch.int32))

    def step(beta, s, gen, *, normals=None, uniforms=None):
        return pcn_step(misfit_coarse, prior, beta, s, gen, normals=normals, uniforms=uniforms,
                        lam=lam)

    return InnerKernel(
        init=init, step=step, theta=lambda s: s.theta, phi=lambda s: s.phi, target=TARGET_ACCEPT,
    )


def make_inner_kernel(inner: str, misfit_coarse: Callable, prior: GaussianPrior,
                      lam=None) -> InnerKernel:
    if inner == "pcn":
        return pcn_inner_kernel(misfit_coarse, prior, lam)
    if inner == "mala":
        raise NotImplementedError(
            "the MALA inner kernel of delayed acceptance is not ported yet: ROADMAP.md "
            "queue 1, item 18"
        )
    raise ValueError(f"unknown DA inner kernel {inner!r} (use 'pcn' or 'mala')")


class DAResult(NamedTuple):
    state: DAState
    samples: torch.Tensor  # (n_kept, C, d), one per outer step
    phi_trace: torch.Tensor  # (n_kept, C) fine misfits
    accept_rate: torch.Tensor  # (C,) outer (fine-correction) accept rate
    inner_accept_rate: torch.Tensor  # (C,) coarse subchain accept rate
    beta: torch.Tensor  # (C,) final adapted inner step sizes
    n_fine_evals: int  # fine-model batch evaluations run


def da_init(misfit_fine: Callable, misfit_coarse: Callable, theta0: torch.Tensor) -> DAState:
    phi_f = misfit_fine(theta0)
    phi_c = misfit_coarse(theta0)
    return DAState(theta=theta0, phi_f=phi_f, phi_c=phi_c,
                   n_accept=torch.zeros_like(phi_f, dtype=torch.int32))


def da_step(
    misfit_fine: Callable,
    kernel: InnerKernel,
    beta,
    subchain: int,
    state: DAState,
    gen: Optional[torch.Generator] = None,
    *,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    outer_uniform: Optional[torch.Tensor] = None,
    lam: Optional[torch.Tensor] = None,
) -> tuple[DAState, torch.Tensor, torch.Tensor]:
    """One outer step: ``subchain`` coarse kernel steps, then one fine MH
    correction. normals (subchain, C, d), uniforms (subchain, C) and
    outer_uniform (C,): the step's draws, else drawn from gen. lam:
    per-chain inverse temperatures of a tempered level, scaling the
    correction's log ratio as the kernel's coarse target is scaled, or None.

    Returns (state, outer accept (C,) bool, inner accept count (C,) int32)."""
    inner = kernel.init(state.theta, state.phi_c)
    n_inner = torch.zeros_like(state.n_accept)
    for i in range(subchain):
        inner, acc = kernel.step(
            beta, inner, gen,
            normals=None if normals is None else normals[i],
            uniforms=None if uniforms is None else uniforms[i],
        )
        n_inner = n_inner + acc.to(torch.int32)
    theta_prop = kernel.theta(inner)
    phi_c_prop = kernel.phi(inner)
    phi_f_prop = misfit_fine(theta_prop)
    # if the subchain never moved, both differences are 0: a harmless self-accept
    log_alpha = (state.phi_f - phi_f_prop) - (state.phi_c - phi_c_prop)
    if lam is not None:
        log_alpha = lam * log_alpha
    u = outer_uniform
    if u is None:
        u = torch.rand(state.phi_f.shape, generator=gen, dtype=state.phi_f.dtype,
                       device=state.phi_f.device)
    accept = torch.log(u) < log_alpha
    new = DAState(
        theta=torch.where(accept[..., None], theta_prop, state.theta),
        phi_f=torch.where(accept, phi_f_prop, state.phi_f),
        phi_c=torch.where(accept, phi_c_prop, state.phi_c),
        n_accept=state.n_accept + accept.to(torch.int32),
    )
    return new, accept, n_inner


def run_da_pcn(
    misfit_fine: Callable,
    misfit_coarse: Callable,
    prior: GaussianPrior,
    theta0: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int,
    n_burn: int = 0,
    beta=0.25,
    subchain: int = 8,
    adapt_t0: float = 0.0,
    inner: str = "pcn",
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    outer_uniforms: Optional[torch.Tensor] = None,
) -> DAResult:
    """Delayed-acceptance pCN from theta0 (C, d); n_steps and n_burn count
    outer steps. During burn-in the inner step size of each chain adapts
    toward 0.234 effective acceptance (inner fraction x outer accept); the
    sampling phase runs the frozen kernel. beta: scalar or per-chain (C,).

    normals (n_steps, subchain, C, d), uniforms (n_steps, subchain, C) and
    outer_uniforms (n_steps, C): optional pre-drawn draws for every outer
    step, burn-in first."""
    dtype, dev = theta0.dtype, theta0.device
    kernel = make_inner_kernel(inner, misfit_coarse, prior)
    state = da_init(misfit_fine, misfit_coarse, theta0)
    log_beta = torch.log(torch.as_tensor(beta, dtype=dtype, device=dev)).expand(state.phi_f.shape)
    lo, hi = math.log(1e-4), math.log(0.9999)  # pCN's beta lives in (0, 1)
    draws = lambda t: dict(
        normals=None if normals is None else normals[t],
        uniforms=None if uniforms is None else uniforms[t],
        outer_uniform=None if outer_uniforms is None else outer_uniforms[t],
    )

    for t in range(n_burn):
        state, acc_out, acc_inner = da_step(
            misfit_fine, kernel, torch.exp(log_beta), subchain, state, gen, **draws(t))
        # Robbins-Monro on the effective acceptance, inner fraction x outer
        # survival: with an accurate surrogate the outer factor is ~1 and
        # this is the usual inner-rate tuning; with a biased one it shrinks
        # the step until the subchain's accumulated (Phi_f - Phi_c) drift
        # stops killing the outer correction
        eta = 0.5 / (1.0 + t + adapt_t0) ** 0.6
        frac = acc_inner.to(dtype) / subchain
        drive = frac * acc_out.to(dtype) - kernel.target
        log_beta = torch.clamp(log_beta + eta * drive, lo, hi)
    if n_burn > 0:
        state = state._replace(n_accept=torch.zeros_like(state.n_accept))

    beta_final = torch.exp(log_beta)
    n_inner = torch.zeros_like(state.n_accept)
    samples, phis = [], []
    for t in range(n_burn, n_steps):
        state, _, acc_inner = da_step(
            misfit_fine, kernel, beta_final, subchain, state, gen, **draws(t))
        n_inner = n_inner + acc_inner
        samples.append(state.theta)
        phis.append(state.phi_f)
    n_keep = n_steps - n_burn
    C, d = theta0.shape
    return DAResult(
        state=state,
        samples=torch.stack(samples) if samples else theta0.new_zeros((0, C, d)),
        phi_trace=torch.stack(phis) if phis else theta0.new_zeros((0, C)),
        accept_rate=state.n_accept.to(torch.float32) / max(n_keep, 1),
        inner_accept_rate=n_inner.to(torch.float32) / max(n_keep * subchain, 1),
        beta=beta_final,
        n_fine_evals=n_steps + 1,
    )


def run_da_pcn_segmented(
    misfit_fine: Callable,
    misfit_coarse: Callable,
    prior: GaussianPrior,
    theta0: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int,
    n_burn: int = 0,
    beta=0.25,
    subchain: int = 8,
    segment: int = 64,
    inner: str = "pcn",
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    outer_uniforms: Optional[torch.Tensor] = None,
) -> DAResult:
    """DA-pCN in segments of at most ``segment`` outer steps
    (``infer.segmented``). Chain state and adapted betas carry across
    segments, the adaptation clock runs on, accept accounting covers the
    whole post-burn run, and each segment re-runs ``da_init`` (one fine
    evaluation more per segment). Draws as for ``run_da_pcn``, for the whole
    run."""
    betas0 = torch.as_tensor(beta, dtype=theta0.dtype, device=theta0.device).expand(
        theta0.shape[:-1])
    part = lambda a, start, this: None if a is None else a[start:start + this]

    def seg(carry, this, burn, start):
        thetas, betas = carry
        res = run_da_pcn(
            misfit_fine, misfit_coarse, prior, thetas, gen,
            n_steps=this, n_burn=burn, beta=betas, subchain=subchain, adapt_t0=float(start),
            inner=inner,
            normals=part(normals, start, this), uniforms=part(uniforms, start, this),
            outer_uniforms=part(outer_uniforms, start, this),
        )
        return res, (res.state.theta, res.beta)

    res, (_, betas), samples, phis, rates, _ = drive_segments(
        seg, (theta0, betas0), n_steps=n_steps, n_burn=n_burn, segment=segment,
        rates={"accept": accept_rate_spec(), "inner": inner_accept_rate_spec(subchain)},
    )
    return DAResult(
        state=res.state,
        samples=samples,
        phi_trace=phis,
        accept_rate=rates["accept"],
        inner_accept_rate=rates["inner"],
        beta=betas,
        n_fine_evals=n_steps + (n_steps + segment - 1) // segment,
    )
