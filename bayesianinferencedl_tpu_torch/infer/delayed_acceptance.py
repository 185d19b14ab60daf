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

from bayesianinferencedl_tpu_torch.infer.mala import (
    LOG_H,
    TARGET_ACCEPT_MALA,
    _make_nlp,
    frame,
    init_state,
    mala_step,
    misfit_grad_fn,
    tempered_mala_step,
)
from bayesianinferencedl_tpu_torch.infer.pcn import TARGET_ACCEPT, PCNState, pcn_step
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.infer.samplers import draws
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


class _TemperedMALAState(NamedTuple):
    y: torch.Tensor  # (..., d) in the prior's frame
    phi: torch.Tensor  # (...) untempered coarse misfit
    gphi: torch.Tensor  # (..., d) its gradient in y
    n_accept: torch.Tensor


def mala_inner_kernel(misfit_coarse: Callable, prior: GaussianPrior, lam=None) -> InnerKernel:
    """Gradient-informed subchains: drift-clipped whitened MALA steps on the
    coarse posterior in the prior's frame, beta being the per-chain step
    size h. The coarse misfit must be differentiable
    (``batched_forward_fn(..., differentiable=True)``); init pays one
    forward and reverse pass for the starting gradient (and recomputes the
    coarse misfit, which that pass gives anyway). lam: per-chain inverse
    temperatures of tempered DA's levels, whose subchains target
    exp(-lam Phi_c) x prior with the prior term taken in y
    (``mala.tempered_mala_step``, as the reference's tempered DA does), or
    None for the untempered target of ``mala.mala_step``."""
    to_theta, to_y = frame(prior.mean, prior.chol)
    if lam is None:
        _, eval_fn = _make_nlp(misfit_coarse, prior, prior.mean, prior.chol)
        return InnerKernel(
            init=lambda theta, phi_c: init_state(eval_fn, to_y, theta),
            step=lambda h, s, gen, **draws: mala_step(eval_fn, h, s, gen, **draws),
            theta=lambda s: to_theta(s.y), phi=lambda s: s.phi, target=TARGET_ACCEPT_MALA,
        )
    phi_grad = misfit_grad_fn(misfit_coarse, prior)

    def init(theta, phi_c):
        y = to_y(theta)
        phi, gphi = phi_grad(y)  # the coarse misfit recomputed: the pass needs it anyway
        return _TemperedMALAState(y=y, phi=phi, gphi=gphi,
                                  n_accept=torch.zeros_like(phi, dtype=torch.int32))

    def step(h, s, gen, *, normals=None, uniforms=None):
        xi, u = draws(gen, s.y.shape, s.y.dtype, s.y.device, normals, uniforms)
        y, phi, gphi, acc = tempered_mala_step(phi_grad, lam, h, s.y, s.phi, s.gphi, xi, u)
        return _TemperedMALAState(y, phi, gphi, s.n_accept + acc.to(torch.int32)), acc

    return InnerKernel(init=init, step=step, theta=lambda s: to_theta(s.y), phi=lambda s: s.phi,
                       target=TARGET_ACCEPT_MALA)


def make_inner_kernel(inner: str, misfit_coarse: Callable, prior: GaussianPrior,
                      lam=None) -> InnerKernel:
    if inner == "pcn":
        return pcn_inner_kernel(misfit_coarse, prior, lam)
    if inner == "mala":
        return mala_inner_kernel(misfit_coarse, prior, lam)
    raise ValueError(f"unknown DA inner kernel {inner!r} (use 'pcn' or 'mala')")


def adapt_inner(inner: str, log_beta, ema, frac, acc_out, eta: float, target: float, *,
                threshold: float = 0.25, weight: float = 2.0):
    """One Robbins-Monro step on the inner kernel's per-chain log step size
    from an outer step's inner accept fraction and outer accepts. pcn drives
    the effective acceptance, inner fraction x outer survival, toward the
    target: with an accurate surrogate that is the inner rate, and with a
    biased one it shrinks the step until the subchain's (Phi_f - Phi_c)
    drift stops killing the correction. That product cannot reach MALA's
    0.574 whenever the outer acceptance sits below it (it rails h to the
    floor), so mala tunes the inner rate to its target and subtracts a
    penalty, ``weight`` times the shortfall, only when ``ema``, a running
    estimate of the outer acceptance, falls below ``threshold`` (DA's 0.25
    and 2; multilevel DA passes the product of its correction rates as
    acc_out, with 0.4 and 4). Returns (log_beta, ema), log beta clipped to
    pCN's (1e-4, 0.9999) or MALA's [1e-8, 10]."""
    dtype = log_beta.dtype
    if inner == "mala":
        ema = ema + 0.05 * (acc_out.to(dtype) - ema)
        drive = (frac - target) - weight * torch.clamp(threshold - ema, min=0.0)
        return torch.clamp(log_beta + eta * drive, *LOG_H), ema
    drive = frac * acc_out.to(dtype) - target
    return torch.clamp(log_beta + eta * drive, math.log(1e-4), math.log(0.9999)), ema


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
    adapt: bool = True,
    adapt_t0: float = 0.0,
    inner: str = "pcn",
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    outer_uniforms: Optional[torch.Tensor] = None,
) -> DAResult:
    """Delayed-acceptance pCN from theta0 (C, d); n_steps and n_burn count
    outer steps. inner: "pcn" subchains, or "mala" (gradient-informed; the
    coarse misfit must be differentiable, and beta is then the initial step
    size h). During burn-in the inner step size of each chain adapts
    (``adapt_inner``) unless ``adapt`` is False; the sampling phase runs the
    frozen kernel. beta: scalar or per-chain (C,).

    normals (n_steps, subchain, C, d), uniforms (n_steps, subchain, C) and
    outer_uniforms (n_steps, C): optional pre-drawn draws for every outer
    step, burn-in first."""
    dtype, dev = theta0.dtype, theta0.device
    kernel = make_inner_kernel(inner, misfit_coarse, prior)
    state = da_init(misfit_fine, misfit_coarse, theta0)
    log_beta = torch.log(torch.as_tensor(beta, dtype=dtype, device=dev)).expand(state.phi_f.shape)
    ema = torch.full_like(state.phi_f, 0.5)  # the outer-acceptance estimate of adapt_inner
    draws = lambda t: dict(
        normals=None if normals is None else normals[t],
        uniforms=None if uniforms is None else uniforms[t],
        outer_uniform=None if outer_uniforms is None else outer_uniforms[t],
    )

    for t in range(n_burn):
        state, acc_out, acc_inner = da_step(
            misfit_fine, kernel, torch.exp(log_beta), subchain, state, gen, **draws(t))
        if adapt:
            eta = 0.5 / (1.0 + t + adapt_t0) ** 0.6
            log_beta, ema = adapt_inner(inner, log_beta, ema, acc_inner.to(dtype) / subchain,
                                        acc_out, eta, kernel.target)
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
