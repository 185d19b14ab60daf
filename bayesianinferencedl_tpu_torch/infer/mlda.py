"""Multilevel delayed acceptance (MLDA): a recursive ladder of surrogates.

Delayed acceptance (``infer/delayed_acceptance.py``) screens proposals
through one surrogate before the exact model. MLDA (Dodwell et al. 2015;
Lykkegaard et al. 2023) nests the screens: level l proposes by S_l steps of
the level-(l-1) kernel and Metropolis-corrects with the collapsed
Christen-Fox ratio

    alpha_l = min{1, exp[(Phi_l(t) - Phi_l(t*)) - (Phi_{l-1}(t) - Phi_{l-1}(t*))]}.

The S-fold composition of a kernel reversible w.r.t. pi_{l-1} is again
reversible w.r.t. it, so by induction each level is an MH kernel whose
invariant law is exactly pi_l ~ exp(-Phi_l) x prior, and the top level
targets the finest posterior for any subchain lengths. theta is the same
5-vector at every rung (a coarser rung is a coarser PDE mesh, not a coarser
parameter), so no transfer operator is needed.

The loops are Python loops of batched calls, with no host synchronisation
inside them. Burn-in adapts the base step size per chain on the product of
the per-level acceptance fractions (the probability that a base move
survives every correction) toward the base kernel's target; with MALA
subchains the base rate is tuned to its own target with a penalty when the
product of the correction rates collapses (``adapt_inner``). After burn-in
nothing adapts.

Draws: every step takes optional pre-drawn draws, so a test can replay
another implementation's stream. For a kernel of depth D they are
``(normals, uniforms)``: the base normals with one leading axis per level
above the base, (S_{D-1}, ..., S_1, C, d), and a tuple of D uniform arrays,
base first, entry j with the leading axes of the levels above j, the last
(C,). A level step hands subchain step i the i-th slice of the normals and
of every uniform array but its own. Without them the draws come from a
``torch.Generator`` in nesting order: each subchain's steps (the base's
normals, then its uniform, innermost), then the level's accept uniform.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from bayesianinferencedl_tpu_torch.infer.delayed_acceptance import (
    InnerKernel,
    adapt_inner,
    make_inner_kernel,
)
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.infer.segmented import accept_rate_spec, drive_segments, per_kept_spec

Draws = Optional[tuple]  # (normals, (uniforms, ...)) of one step, or None


class MLKernel(NamedTuple):
    """A level of the ladder, usable as the subchain kernel of the level
    above: InnerKernel's protocol plus per-level rates and the depth.

    step(beta, state, gen, draws=None) -> (state, accept mask);
    rates(state) -> (depth, C): the acceptance fractions of the state's last
    step, base first (row 0 the base accept fraction averaged through the
    nesting, the last row this level's own accept)."""

    init: Callable  # (theta, phi_this) -> state
    step: Callable
    theta: Callable  # state -> (C, d)
    phi: Callable  # state -> (C,) this level's misfit
    rates: Callable  # state -> (depth, C)
    depth: int
    target: float  # the base kernel's acceptance target


class _BaseState(NamedTuple):
    inner: object  # the wrapped InnerKernel's state
    acc: torch.Tensor  # (C,) the last step's accept as a float


def wrap_base(kernel: InnerKernel) -> MLKernel:
    """Lift a DA InnerKernel (pcn or mala) into the MLKernel protocol."""

    def init(theta, phi):
        return _BaseState(inner=kernel.init(theta, phi), acc=torch.zeros_like(phi))

    def step(beta, s, gen, draws: Draws = None):
        normals, uniforms = (None, (None,)) if draws is None else draws
        s2, acc = kernel.step(beta, s.inner, gen, normals=normals, uniforms=uniforms[0])
        return _BaseState(inner=s2, acc=acc.to(s.acc.dtype)), acc

    return MLKernel(init=init, step=step, theta=lambda s: kernel.theta(s.inner),
                    phi=lambda s: kernel.phi(s.inner), rates=lambda s: s.acc[None], depth=1,
                    target=kernel.target)


class LevelState(NamedTuple):
    theta: torch.Tensor  # (C, d)
    phi: torch.Tensor  # (C,) this level's misfit at theta
    phi_sub: torch.Tensor  # (C,) the level below's misfit at theta
    rate_stack: torch.Tensor  # (depth, C) the last step's per-level fractions


def level_kernel(eval_this: Callable, eval_sub: Callable, sub: MLKernel, subchain: int) -> MLKernel:
    """One rung: ``subchain`` steps of ``sub`` (targeting pi_sub), corrected
    against ``eval_this``. eval_* are batched misfits (C, d) -> (C,)."""

    def init(theta, phi_this):
        return LevelState(theta=theta, phi=phi_this, phi_sub=eval_sub(theta),
                          rate_stack=phi_this.new_zeros((sub.depth + 1,) + tuple(phi_this.shape)))

    def step(beta, s, gen, draws: Draws = None):
        st = sub.init(s.theta, s.phi_sub)
        rates = []
        for i in range(subchain):
            sd = None if draws is None else (draws[0][i], tuple(u[i] for u in draws[1][:-1]))
            st, _ = sub.step(beta, st, gen, sd)
            rates.append(sub.rates(st))
        theta_p, phi_sub_p = sub.theta(st), sub.phi(st)
        phi_p = eval_this(theta_p)
        # the collapsed Christen-Fox ratio; a frozen subchain gives 0, a
        # harmless self-accept, as in da_step
        log_alpha = (s.phi - phi_p) - (s.phi_sub - phi_sub_p)
        u = draws[1][-1] if draws is not None else torch.rand(
            s.phi.shape, generator=gen, dtype=s.phi.dtype, device=s.phi.device)
        accept = torch.log(u) < log_alpha
        rate_stack = torch.cat([torch.stack(rates).mean(0), accept.to(s.phi.dtype)[None]], 0)
        new = LevelState(
            theta=torch.where(accept[..., None], theta_p, s.theta),
            phi=torch.where(accept, phi_p, s.phi),
            phi_sub=torch.where(accept, phi_sub_p, s.phi_sub),
            rate_stack=rate_stack,
        )
        return new, accept

    return MLKernel(init=init, step=step, theta=lambda s: s.theta, phi=lambda s: s.phi,
                    rates=lambda s: s.rate_stack, depth=sub.depth + 1, target=sub.target)


def build_mlda_kernel(misfits: Sequence[Callable], prior: GaussianPrior, subchains: Sequence[int], *,
                      inner: str = "pcn") -> MLKernel:
    """misfits: batched, cheapest to finest (L + 1 of them); subchains: L
    entries, entry l the level-l kernel steps per level-(l + 1) proposal."""
    if len(misfits) < 2:
        raise ValueError("MLDA needs at least 2 misfit levels (use run_pcn for 1)")
    if len(subchains) != len(misfits) - 1:
        raise ValueError(f"need {len(misfits) - 1} subchain lengths for {len(misfits)} levels, "
                         f"got {len(subchains)}")
    kernel = wrap_base(make_inner_kernel(inner, misfits[0], prior))
    for lvl in range(1, len(misfits)):
        kernel = level_kernel(misfits[lvl], misfits[lvl - 1], kernel, subchains[lvl - 1])
    return kernel


def mlda_evals_per_step(subchains: Sequence[int]) -> tuple[int, ...]:
    """Batch evaluations of each misfit level per top-level step, cheapest
    first (a pCN base; a MALA base pays one base evaluation more per level-1
    re-init). Level l is evaluated prod(subchains[l:]) times as base steps
    or corrections, plus prod(subchains[l + 2:]) times inside the level-(l +
    1) kernel's re-inits, one per level-(l + 2) step."""
    L = len(subchains)
    return tuple(math.prod(subchains[lvl:]) + (math.prod(subchains[lvl + 2:]) if lvl <= L - 2 else 0)
                 for lvl in range(L + 1))


class MLDAResult(NamedTuple):
    state: LevelState
    samples: torch.Tensor  # (n_kept, C, d), one per top step
    phi_trace: torch.Tensor  # (n_kept, C) finest misfits
    accept_rate: torch.Tensor  # (C,) top-level accept rate
    level_rates: torch.Tensor  # (n_levels, C) mean per-level fractions, base first
    beta: torch.Tensor  # (C,) final adapted base step sizes
    evals_per_step: tuple  # batch evaluations of each level per top step, cheapest first


def run_mlda(
    misfits: tuple,
    prior: GaussianPrior,
    theta0: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int,
    n_burn: int = 0,
    beta=0.25,
    subchains: tuple = (8, 4),
    adapt: bool = True,
    adapt_t0: float = 0.0,
    inner: str = "pcn",
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[tuple] = None,
) -> MLDAResult:
    """Multilevel DA from theta0 (C, d); n_steps and n_burn count top-level
    steps, each prod(subchains) base steps and one finest evaluation.
    misfits: batched, cheapest first, the exact target last. beta: scalar or
    per-chain (C,) base step size (MALA's h for inner="mala"). adapt_t0: the
    global index of the first step, which a segmented run passes.

    normals (n_steps, S_L, ..., S_1, C, d) and uniforms, a tuple of L + 1
    arrays with leading n_steps (the module docstring's layout): optional
    pre-drawn draws for every top step, burn-in first."""
    dtype, dev = theta0.dtype, theta0.device
    subchains = tuple(subchains)
    kernel = build_mlda_kernel(misfits, prior, subchains, inner=inner)
    phi_top0 = misfits[-1](theta0)
    state = kernel.init(theta0, phi_top0)
    log_beta = torch.log(torch.as_tensor(beta, dtype=dtype, device=dev)).expand(phi_top0.shape)
    ema = torch.full_like(phi_top0, 0.5)  # adapt_inner's running correction rate (mala)
    draws = lambda t: None if normals is None else (normals[t], tuple(u[t] for u in uniforms))

    for t in range(n_burn):
        state, _ = kernel.step(torch.exp(log_beta), state, gen, draws(t))
        if adapt:
            eta = 0.5 / (1.0 + t + adapt_t0) ** 0.6
            r = kernel.rates(state)
            if inner == "mala":
                # the DA rule with the product of the correction rates as
                # the outer rate and a stiffer penalty (0.4, 4): a MALA base
                # mixes toward the base rung's posterior, so over-long steps
                # land subchain ends where the mid rung vetoes them
                log_beta, ema = adapt_inner("mala", log_beta, ema, r[0], torch.prod(r[1:], 0), eta,
                                            kernel.target, threshold=0.4, weight=4.0)
            else:  # the product of every level's rate toward the target
                log_beta, ema = adapt_inner("pcn", log_beta, ema, torch.prod(r[:-1], 0), r[-1], eta,
                                            kernel.target)

    beta_final = torch.exp(log_beta)
    samples, phis, accs, rstacks = [], [], [], []
    for t in range(n_burn, n_steps):
        state, acc = kernel.step(beta_final, state, gen, draws(t))
        samples.append(state.theta)
        phis.append(state.phi)
        accs.append(acc)
        rstacks.append(kernel.rates(state))
    C, d = theta0.shape
    L1 = len(misfits)
    return MLDAResult(
        state=state,
        samples=torch.stack(samples) if samples else theta0.new_zeros((0, C, d)),
        phi_trace=torch.stack(phis) if phis else theta0.new_zeros((0, C)),
        accept_rate=(torch.stack(accs).to(torch.float32).mean(0) if accs
                     else torch.full((C,), float("nan"), device=dev)),
        level_rates=(torch.stack(rstacks).to(torch.float32).mean(0) if rstacks
                     else torch.full((L1, C), float("nan"), device=dev)),
        beta=beta_final,
        evals_per_step=mlda_evals_per_step(subchains),
    )


def level_rates_spec():
    """The per-level acceptance fractions of a segmented run: a segment's
    value is its mean over its kept steps."""
    return per_kept_spec(lambda r: r.level_rates)


def run_mlda_segmented(
    misfits: tuple,
    prior: GaussianPrior,
    theta0: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int,
    n_burn: int = 0,
    beta=0.25,
    subchains: tuple = (8, 4),
    segment: int = 64,
    inner: str = "pcn",
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[tuple] = None,
) -> MLDAResult:
    """MLDA in segments of at most ``segment`` top steps
    (``infer.segmented``). Chain states and adapted base betas carry across
    segments (each segment re-evaluates every rung at its start), the
    adaptation clock runs on, and the rates cover the whole post-burn run.
    Draws as for ``run_mlda``, for the whole run."""
    betas0 = torch.as_tensor(beta, dtype=theta0.dtype, device=theta0.device).expand(theta0.shape[:-1])
    part = lambda start, this: (None, None) if normals is None else (
        normals[start:start + this], tuple(u[start:start + this] for u in uniforms))

    def seg(carry, this, burn, start):
        thetas, betas = carry
        nrm, uni = part(start, this)
        res = run_mlda(misfits, prior, thetas, gen, n_steps=this, n_burn=burn, beta=betas,
                       subchains=subchains, adapt_t0=float(start), inner=inner, normals=nrm,
                       uniforms=uni)
        return res, (res.state.theta, res.beta)

    res, (_, betas), samples, phis, rates, _ = drive_segments(
        seg, (theta0, betas0), n_steps=n_steps, n_burn=n_burn, segment=segment,
        rates={"accept": accept_rate_spec(), "levels": level_rates_spec()},
    )
    return MLDAResult(state=res.state, samples=samples, phi_trace=phis, accept_rate=rates["accept"],
                      level_rates=rates["levels"], beta=betas, evals_per_step=res.evals_per_step)
