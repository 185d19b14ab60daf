"""Preconditioned MALA: gradient-based MCMC on the differentiable forwards.

Metropolis-adjusted Langevin in whitened coordinates, with an explicit
proposal-density correction:

* Whitening: theta = m_ref + L_ref y. The frame is the prior (m, L) by
  default, or a Laplace approximation ``ref=(m_L, L_L)`` (posterior-
  covariance preconditioning that stays exact off the Gaussian case).
* Target in y: log pi(y) = -Phi(theta(y)) - 0.5 ||L^-1 (theta(y) - m)||^2.
* Proposal: y' = y + (h/2) g(y) + sqrt(h) xi, with g the drift-clipped
  gradient of log pi (``_tamed``), xi ~ N(0, I).
* Acceptance: MH with the explicit Gaussian q densities of the drift
  actually used, so any drift is corrected exactly.

The step size h adapts per chain in burn-in (Robbins-Monro on log h toward
0.574 acceptance), then is frozen. The gradient of the current state is
carried in the state, so each step costs one forward and one reverse pass
over the whole chain batch (``_make_nlp``). The misfit is batched and must
be differentiable (``Pipeline.batched_forward_fn(..., differentiable=True)``).

Every sampler takes optional pre-drawn draws for every step (normals
(n_steps, C, d), uniforms (n_steps, C)), so a test can replay another
implementation's stream; without them they come from a
``torch.Generator`` in step order, the normals before the uniforms.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.infer.samplers import draws, inv_chol
from bayesianinferencedl_tpu_torch.infer.segmented import accept_rate_spec, drive_segments
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul

TARGET_ACCEPT_MALA = 0.574
LOG_H = (math.log(1e-8), math.log(10.0))  # the clip of an adapted log step size


class MALAState(NamedTuple):
    y: torch.Tensor  # (C, d) whitened coordinates
    nlp: torch.Tensor  # (C,) negative log posterior at y (misfit + prior)
    phi: torch.Tensor  # (C,) data misfit alone
    grad: torch.Tensor  # (C, d) d(nlp)/dy, carried so each step costs one gradient
    n_accept: torch.Tensor  # (C,) int32


class MALAResult(NamedTuple):
    state: MALAState
    samples: torch.Tensor  # (n_kept, C, d) in working coordinates (theta)
    phi_trace: torch.Tensor  # (n_kept, C) data misfit
    accept_rate: torch.Tensor  # (C,)
    step: torch.Tensor  # (C,) final (possibly adapted) step sizes h


def frame(ref_mean: torch.Tensor, ref_chol: torch.Tensor):
    """(to_theta, to_y) of the whitening frame theta = m + L y."""
    Li = inv_chol(ref_chol)

    def to_theta(Y):
        with fp32_matmul():
            return ref_mean + Y @ ref_chol.T

    def to_y(theta):
        with fp32_matmul():
            return (theta - ref_mean) @ Li.T

    return to_theta, to_y


def _make_nlp(misfit_fn: Callable, prior: GaussianPrior, ref_mean: torch.Tensor,
              ref_chol: torch.Tensor):
    """(to_theta, eval_fn) in the whitened frame, eval_fn(Y) -> (nlp, phi,
    grad) from one forward and one reverse pass over the whole chain batch
    (the rows of the gradient are the chains', which are independent). The
    passes run in full fp32."""
    to_theta, _ = frame(ref_mean, ref_chol)
    _, whiten = frame(prior.mean, prior.chol)

    def eval_fn(Y):
        with torch.enable_grad(), fp32_matmul():
            Y = Y.detach().requires_grad_()
            theta = to_theta(Y)
            phi = misfit_fn(theta)
            w = whiten(theta)
            nlp = phi + 0.5 * torch.sum(w * w, -1)
            (grad,) = torch.autograd.grad(torch.sum(nlp), Y)
        return nlp.detach(), phi.detach(), grad

    return to_theta, eval_fn


def _tamed(g: torch.Tensor, h: torch.Tensor, kappa: float = 2.0) -> torch.Tensor:
    """Noise-scale drift clip: g unchanged unless ||g|| > 2 kappa sqrt(d/h),
    where the drift move (h/2)||g|| would exceed kappa times the proposal's
    noise scale sqrt(h d). Far from the posterior a misfit gradient can be
    1e3-1e4, and the raw drift then moves O(1) a step whatever h is; the
    clip keeps the move size under the adaptation's control and leaves the
    stationary regime untouched. The q densities use the clipped drift, so
    exactness is unaffected."""
    d = g.shape[-1]
    r = 2.0 * kappa * torch.sqrt(d / h)[..., None]
    gn = torch.sqrt(torch.sum(g * g, -1, keepdim=True))
    return g * torch.clamp(r / torch.clamp(gn, min=torch.finfo(g.dtype).tiny), max=1.0)


def _langevin(y, nlp, grad, h, xi, u, evaluate):
    """One drift-clipped Langevin proposal and its MH test from (y, nlp,
    grad = d nlp / dy): evaluate(prop) -> (nlp', grad', extra). Returns
    (prop, accept, (nlp', grad', extra))."""
    hcol = h[..., None]
    g = _tamed(-grad, h)  # the clipped gradient of the log posterior
    prop = y + 0.5 * hcol * g + torch.sqrt(hcol) * xi
    nlp_p, grad_p, extra = evaluate(prop)
    g_p = _tamed(-grad_p, h)
    # explicit Gaussian proposal densities, the same per-chain h both ways
    fwd = prop - y - 0.5 * hcol * g
    bwd = y - prop - 0.5 * hcol * g_p
    log_q_fwd = -torch.sum(fwd * fwd, -1) / (2.0 * h)
    log_q_bwd = -torch.sum(bwd * bwd, -1) / (2.0 * h)
    log_alpha = (nlp - nlp_p) + (log_q_bwd - log_q_fwd)
    return prop, torch.log(u) < log_alpha, (nlp_p, grad_p, extra)


def mala_step(eval_fn, h: torch.Tensor, state: MALAState, gen: Optional[torch.Generator] = None,
              *, normals: Optional[torch.Tensor] = None,
              uniforms: Optional[torch.Tensor] = None) -> tuple[MALAState, torch.Tensor]:
    """One drift-clipped MALA step for the chain batch; h: per-chain step
    sizes (C,). normals (C, d) / uniforms (C,): the step's draws. Returns
    (state, accept mask)."""
    y = state.y
    xi, u = draws(gen, y.shape, y.dtype, y.device, normals, uniforms)

    def evaluate(Y):
        nlp, phi, grad = eval_fn(Y)
        return nlp, grad, phi

    prop, accept, (nlp_p, grad_p, phi_p) = _langevin(state.y, state.nlp, state.grad, h, xi, u,
                                                     evaluate)
    acol = accept[..., None]
    new = MALAState(
        y=torch.where(acol, prop, state.y),
        nlp=torch.where(accept, nlp_p, state.nlp),
        phi=torch.where(accept, phi_p, state.phi),
        grad=torch.where(acol, grad_p, state.grad),
        n_accept=state.n_accept + accept.to(torch.int32),
    )
    return new, accept


def tempered_mala_step(phi_grad: Callable, lam: torch.Tensor, h: torch.Tensor, y: torch.Tensor,
                       phi: torch.Tensor, gphi: torch.Tensor, xi: torch.Tensor, u: torch.Tensor):
    """One drift-clipped MALA step on the tempered targets
    -log pi_j(y) = lam_j Phi(theta(y)) + 0.5 ||y||^2 in the prior's frame,
    from the carried untempered misfit phi and its gradient gphi = d Phi /
    dy (the temperature multiplies them on use, so they swap with the state
    between levels); phi_grad(Y) -> (Phi, d Phi / dy). The within-level
    move of ``run_pt_mala`` and of tempered DA's MALA subchains. Returns
    (y, phi, gphi, accept)."""

    def nlp_grad(ph, gph, Y):
        return lam * ph + 0.5 * torch.sum(Y * Y, -1), lam[..., None] * gph + Y

    def evaluate(Y):
        ph, gph = phi_grad(Y)
        return (*nlp_grad(ph, gph, Y), (ph, gph))

    prop, accept, (_, _, (phi_p, gphi_p)) = _langevin(y, *nlp_grad(phi, gphi, y), h, xi, u, evaluate)
    acol = accept[..., None]
    return (torch.where(acol, prop, y), torch.where(accept, phi_p, phi),
            torch.where(acol, gphi_p, gphi), accept)


def misfit_grad_fn(misfit_fn: Callable, prior: GaussianPrior) -> Callable:
    """Y (..., d) in the prior's frame -> (Phi (...), d Phi / dY (..., d)),
    one forward and one reverse pass over the flattened batch in full
    fp32."""
    to_theta, _ = frame(prior.mean, prior.chol)

    def phi_grad(Y):
        lead, d = Y.shape[:-1], Y.shape[-1]
        with torch.enable_grad(), fp32_matmul():
            flat = Y.detach().reshape(-1, d).requires_grad_()
            phi = misfit_fn(to_theta(flat))
            (g,) = torch.autograd.grad(torch.sum(phi), flat)
        return phi.detach().reshape(lead), g.reshape(*lead, d)

    return phi_grad


def _adapt(log_h, acc, t_global: float, target: float):
    """One Robbins-Monro step on per-chain log h toward ``target``."""
    eta = 0.5 / (1.0 + t_global) ** 0.6
    return torch.clamp(log_h + eta * (acc.to(log_h.dtype) - target), *LOG_H)


def run_chain(step_fn, to_theta, state: MALAState, *, step, n_steps: int, n_burn: int, thin: int,
              adapt: bool, adapt_t0: float, target: float, draws: Callable) -> MALAResult:
    """The run loop of MALA and HMC: burn-in with per-chain adaptation of
    log h (frozen afterwards, the accept count reset), then every
    ``thin``-th state of the remaining steps kept. step_fn(h, state,
    **draws(t)) -> (state, accept)."""
    dtype = state.y.dtype
    log_h = torch.log(torch.as_tensor(step, dtype=dtype, device=state.y.device).expand(
        state.nlp.shape))
    for t in range(n_burn):
        state, acc = step_fn(torch.exp(log_h), state, **draws(t))
        if adapt:
            log_h = _adapt(log_h, acc, t + adapt_t0, target)
    if n_burn > 0:
        state = state._replace(n_accept=torch.zeros_like(state.n_accept))
    h_final = torch.exp(log_h)
    n_out = (n_steps - n_burn) // thin
    samples, phis = [], []
    t = n_burn
    for _ in range(n_out):
        for _ in range(thin):
            state, _ = step_fn(h_final, state, **draws(t))
            t += 1
        samples.append(to_theta(state.y))
        phis.append(state.phi)
    C, d = state.y.shape
    return MALAResult(
        state=state,
        samples=torch.stack(samples) if samples else state.y.new_zeros((0, C, d)),
        phi_trace=torch.stack(phis) if phis else state.y.new_zeros((0, C)),
        accept_rate=state.n_accept.to(torch.float32) / max(n_out * thin, 1),
        step=h_final,
    )


def init_state(eval_fn, to_y, theta0: torch.Tensor) -> MALAState:
    """The whitened state at theta0 (C, d), with its nlp, misfit and
    gradient."""
    y0 = to_y(theta0)
    nlp0, phi0, grad0 = eval_fn(y0)
    return MALAState(y=y0, nlp=nlp0, phi=phi0, grad=grad0,
                     n_accept=torch.zeros_like(nlp0, dtype=torch.int32))


def run_mala(
    misfit_fn: Callable,
    prior: GaussianPrior,
    theta0: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int,
    n_burn: int = 0,
    step=0.1,
    thin: int = 1,
    adapt: bool = True,
    adapt_t0: float = 0.0,
    ref: Optional[tuple] = None,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> MALAResult:
    """Run preconditioned MALA chains from theta0 (C, d), in working
    coordinates in and out. step: scalar or per-chain initial h; burn-in
    adapts per-chain log h toward 57.4% acceptance when adapt=True, clipped
    to [1e-8, 10]. ref=(mean, chol) overrides the whitening frame (default
    the prior's). adapt_t0: the global index of the first step (segmented
    runs). Draws as in the module docstring, for every step."""
    ref_mean, ref_chol = ref if ref is not None else (prior.mean, prior.chol)
    to_theta, eval_fn = _make_nlp(misfit_fn, prior, ref_mean, ref_chol)
    state = init_state(eval_fn, frame(ref_mean, ref_chol)[1], theta0)
    pick = lambda a, t: None if a is None else a[t]
    draws = lambda t: dict(gen=gen, normals=pick(normals, t), uniforms=pick(uniforms, t))
    return run_chain(lambda h, s, **kw: mala_step(eval_fn, h, s, **kw), to_theta, state, step=step,
                     n_steps=n_steps, n_burn=n_burn, thin=thin, adapt=adapt, adapt_t0=adapt_t0,
                     target=TARGET_ACCEPT_MALA, draws=draws)


def segmented(runner: Callable, prior: GaussianPrior, theta0: torch.Tensor, *, step, n_steps: int,
              n_burn: int, segment: int, ref: Optional[tuple], draws: dict) -> MALAResult:
    """A MALA or HMC run in segments of at most ``segment`` steps
    (``infer.segmented``): the chain states (carried in working coordinates,
    re-whitened by each segment) and the adapted step sizes carry across
    segments, the adaptation clock runs on, and the accept rate covers the
    whole post-burn run. runner(thetas, hs, n_steps=, n_burn=, adapt_t0=,
    **draws) is run_mala or run_hmc with its other arguments bound; draws
    holds per-step arrays for the whole run."""
    steps0 = torch.as_tensor(step, dtype=theta0.dtype, device=theta0.device).expand(
        theta0.shape[:-1])
    to_theta, _ = frame(*(ref if ref is not None else (prior.mean, prior.chol)))

    def seg(carry, this, burn, start):
        thetas, hs = carry
        part = {k: None if a is None else a[start:start + this] for k, a in draws.items()}
        res = runner(thetas, hs, n_steps=this, n_burn=burn, adapt_t0=float(start), **part)
        return res, (to_theta(res.state.y), res.step)

    res, (_, hs), samples, phis, rates, _ = drive_segments(
        seg, (theta0, steps0), n_steps=n_steps, n_burn=n_burn, segment=segment,
        rates={"accept": accept_rate_spec()},
    )
    return MALAResult(state=res.state, samples=samples, phi_trace=phis,
                      accept_rate=rates["accept"], step=hs)


def run_mala_segmented(
    misfit_fn: Callable,
    prior: GaussianPrior,
    theta0: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int,
    n_burn: int = 0,
    step=0.1,
    segment: int = 64,
    ref: Optional[tuple] = None,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> MALAResult:
    """MALA in segments of at most ``segment`` steps (``segmented``), for
    likelihoods with a full-order solve and its adjoint in every step.
    Draws as for ``run_mala``, for the whole run."""

    def runner(thetas, hs, **kw):
        return run_mala(misfit_fn, prior, thetas, gen, step=hs, thin=1, adapt=True, ref=ref, **kw)

    return segmented(runner, prior, theta0, step=step, n_steps=n_steps, n_burn=n_burn,
                     segment=segment, ref=ref, draws=dict(normals=normals, uniforms=uniforms))
