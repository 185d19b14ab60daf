"""Hamiltonian Monte Carlo with jittered fixed-length trajectories, and its
trajectory length chosen by the cross-chain ChEES criterion.

The frame machinery is MALA's (``infer.mala``): whitened coordinates
theta = m_ref + L_ref y (the prior's frame, or a Laplace approximation's via
``ref``), so the identity mass matrix in y is the preconditioner.

* One step: refresh p ~ N(0, I); integrate ``n_leap`` leapfrog steps of
  per-chain size eps = h u, u ~ U[1 - jitter, 1 + jitter] drawn per chain
  and step (the jitter breaks the periodic orbits of a fixed length);
  accept with exp(H(start) - H(end)), H = nlp + ||p||^2 / 2.
* The leapfrog force is the drift-clipped gradient (``mala._tamed``): far
  from the posterior raw misfit gradients explode the integrator before
  the adaptation can react. Leapfrog with any position-dependent force is
  volume-preserving and reversible under a momentum flip, and the MH test
  uses the true Hamiltonian, so the chain stays exact.
* Per-chain h adapts in burn-in toward 0.651 acceptance, then freezes.

One step costs ``n_leap`` forward and reverse passes over the chain batch.
Every sampler takes optional pre-drawn draws for every step: the momenta
``normals`` (n_steps, C, d), the jitter draws ``jitters`` (n_steps, C) in
[-1, 1) and the acceptance ``uniforms`` (n_steps, C); without them they come
from a ``torch.Generator`` in that order.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from bayesianinferencedl_tpu_torch.infer.mala import (
    MALAResult,
    MALAState,
    _adapt,
    _make_nlp,
    _tamed,
    frame,
    init_state,
    run_chain,
    segmented,
)
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.parallel.mesh import mean_all

TARGET_ACCEPT_HMC = 0.651


def hmc_step(
    eval_fn,
    h: torch.Tensor,
    n_leap: int,
    jitter: float,
    state: MALAState,
    gen: Optional[torch.Generator] = None,
    *,
    normals: Optional[torch.Tensor] = None,
    jitters: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> tuple[MALAState, torch.Tensor]:
    """One jittered-trajectory HMC step for the chain batch; h: per-chain
    leapfrog step sizes (C,). normals (C, d) (the momenta), jitters (C,) in
    [-1, 1) and uniforms (C,): the step's draws. Returns (state, accept)."""
    y0 = state.y
    dtype, dev = y0.dtype, y0.device
    if normals is None:
        normals = torch.randn(y0.shape, generator=gen, dtype=dtype, device=dev)
    if jitters is None:
        jitters = torch.rand(h.shape, generator=gen, dtype=dtype, device=dev) * 2.0 - 1.0
    if uniforms is None:
        uniforms = torch.rand(state.nlp.shape, generator=gen, dtype=dtype, device=dev)
    u = 1.0 + jitter * jitters
    eps = (h * u)[..., None]  # (C, 1)

    p0 = normals
    H0 = state.nlp + 0.5 * torch.sum(p0 * p0, -1)
    # leapfrog: a half kick, n_leap x (drift, kick), then undo half the last kick
    p = p0 - 0.5 * eps * _tamed(state.grad, h)
    y, nlp, phi, grad = y0, state.nlp, state.phi, state.grad
    for _ in range(n_leap):
        y = y + eps * p
        nlp, phi, grad = eval_fn(y)
        p = p - eps * _tamed(grad, h)
    p = p + 0.5 * eps * _tamed(grad, h)

    # an integrator that overflowed gives a non-finite H: a reject
    H1 = nlp + 0.5 * torch.sum(p * p, -1)
    log_alpha = torch.where(torch.isfinite(H1), H0 - H1, -torch.inf)
    accept = torch.log(uniforms) < log_alpha
    acol = accept[..., None]
    new = MALAState(
        y=torch.where(acol, y, state.y),
        nlp=torch.where(accept, nlp, state.nlp),
        phi=torch.where(accept, phi, state.phi),
        grad=torch.where(acol, grad, state.grad),
        n_accept=state.n_accept + accept.to(torch.int32),
    )
    return new, accept


def _hmc_draws(gen, normals, jitters, uniforms):
    pick = lambda a, t: None if a is None else a[t]
    return lambda t: dict(gen=gen, normals=pick(normals, t), jitters=pick(jitters, t),
                          uniforms=pick(uniforms, t))


def run_hmc(
    misfit_fn: Callable,
    prior: GaussianPrior,
    theta0: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int,
    n_burn: int = 0,
    step=0.1,
    n_leap: int = 8,
    jitter: float = 0.2,
    thin: int = 1,
    adapt: bool = True,
    adapt_t0: float = 0.0,
    ref: Optional[tuple] = None,
    normals: Optional[torch.Tensor] = None,
    jitters: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> MALAResult:
    """Run preconditioned HMC chains: ``run_mala``'s contract (working
    coordinates in and out, per-chain h adapted in burn-in, here toward
    65.1%, ``ref`` overriding the frame). n_steps and n_burn count
    trajectories, each ``n_leap`` gradient evaluations. Draws as in the
    module docstring, for every trajectory."""
    if n_leap < 1:
        raise ValueError(
            f"n_leap={n_leap}: run_hmc needs >= 1 leapfrog step (n_leap=0 means AUTO only at "
            "the api level, run_hmc_chees / api.run_inversion(hmc_leap=0); this path needs a "
            "fixed length)"
        )
    ref_mean, ref_chol = ref if ref is not None else (prior.mean, prior.chol)
    to_theta, eval_fn = _make_nlp(misfit_fn, prior, ref_mean, ref_chol)
    state = init_state(eval_fn, frame(ref_mean, ref_chol)[1], theta0)
    return run_chain(lambda h, s, **kw: hmc_step(eval_fn, h, n_leap, jitter, s, **kw), to_theta,
                     state, step=step, n_steps=n_steps, n_burn=n_burn, thin=thin, adapt=adapt,
                     adapt_t0=adapt_t0, target=TARGET_ACCEPT_HMC,
                     draws=_hmc_draws(gen, normals, jitters, uniforms))


def run_hmc_segmented(
    misfit_fn: Callable,
    prior: GaussianPrior,
    theta0: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int,
    n_burn: int = 0,
    step=0.1,
    n_leap: int = 8,
    jitter: float = 0.2,
    segment: Optional[int] = None,
    ref: Optional[tuple] = None,
    normals: Optional[torch.Tensor] = None,
    jitters: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> MALAResult:
    """HMC in segments (``mala.segmented``); segment=None sizes a segment to
    ~64 solves with their adjoints: max(1, 32 // n_leap) trajectories.
    Draws as for ``run_hmc``, for the whole run."""
    if segment is None:
        segment = max(1, 32 // n_leap)

    def runner(thetas, hs, **kw):
        return run_hmc(misfit_fn, prior, thetas, gen, step=hs, n_leap=n_leap, jitter=jitter,
                       thin=1, adapt=True, ref=ref, **kw)

    return segmented(runner, prior, theta0, step=step, n_steps=n_steps, n_burn=n_burn,
                     segment=segment, ref=ref,
                     draws=dict(normals=normals, jitters=jitters, uniforms=uniforms))


def _chees_probe(
    misfit_fn, prior, ref_mean, ref_chol, state: MALAState, log_h: torch.Tensor, t0: float,
    gen: Optional[torch.Generator] = None, *, n_leap: int, jitter: float, n_adapt: int,
    n_meas: int, normals=None, jitters=None, uniforms=None, group=None,
):
    """One trajectory-length probe: n_adapt steps of step-size adaptation at
    this n_leap (global clock from t0), then n_meas frozen-h steps
    accumulating the ChEES statistic (Hoffman, Radul & Sountsov 2021), the
    mean squared change of the centred squared radius,
    E[(||y' - mu||^2 - ||y - mu||^2)^2] with mu the cross-chain mean; a
    rejected move contributes 0. Divided by n_leap (by the caller) it is
    the criterion per gradient evaluation. Draws (n_adapt + n_meas, ...)
    as for ``run_hmc``. Returns (state, log_h, chees, accept_rate), the last
    two Python floats. group: the mesh over which the chain batch is
    sharded (``parallel.sharding.sharded_hmc_chees``); the centring mean
    and the two statistics become means over its ranks, so every rank
    scores every candidate alike."""
    _, eval_fn = _make_nlp(misfit_fn, prior, ref_mean, ref_chol)
    draws = _hmc_draws(gen, normals, jitters, uniforms)
    for t in range(n_adapt):
        state, acc = hmc_step(eval_fn, torch.exp(log_h), n_leap, jitter, state, **draws(t))
        log_h = _adapt(log_h, acc, t + t0, TARGET_ACCEPT_HMC)
    h = torch.exp(log_h)
    js, accs = [], []
    for t in range(n_adapt, n_adapt + n_meas):
        mu = torch.mean(state.y, 0)
        if group is not None:
            mu = mean_all(group, mu)
        r0 = torch.sum((state.y - mu) ** 2, -1)
        state, acc = hmc_step(eval_fn, h, n_leap, jitter, state, **draws(t))
        r1 = torch.sum((state.y - mu) ** 2, -1)
        js.append(torch.mean((r1 - r0) ** 2))
        accs.append(torch.mean(acc.to(state.y.dtype)))
    chees, acc = torch.mean(torch.stack(js)), torch.mean(torch.stack(accs))
    if group is not None:
        chees, acc = mean_all(group, chees), mean_all(group, acc)
    return state, log_h, float(chees), float(acc)


def run_hmc_chees(
    misfit_fn: Callable,
    prior: GaussianPrior,
    theta0: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int,
    n_burn: int = 0,
    step=0.1,
    leap_candidates=(1, 2, 4, 8, 16, 32),
    jitter: float = 0.2,
    n_adapt: int = 24,
    n_meas: int = 24,
    thin: int = 1,
    ref: Optional[tuple] = None,
    draws: Optional[dict] = None,
    group=None,
):
    """HMC with the trajectory length chosen by measurement: each candidate
    n_leap is probed with the ChEES criterion per gradient evaluation and
    the production chain runs at the best. The cross-chain statistic takes
    the place of NUTS's per-chain recursion.

    Schedule: max(n_burn // 2, 8) trajectories first at the median
    candidate (to reach the typical set), then each candidate's probe
    (n_adapt adaptation + n_meas measurement steps; state and per-chain h
    carry through), then ``run_hmc`` for the remaining burn-in (at least 8)
    and the kept run at the winner. draws: {"pre": d, "probes": [d, ...],
    "main": d}, each d a dict of ``run_hmc``'s draw arrays for that part.

    group: the mesh the chain batch is sharded over, passed to the probes
    (``_chees_probe``); the runs before and after them are chain-local.

    Returns (MALAResult, info), info = {"n_leap", "candidates",
    "chees_per_grad", "accept"}."""
    ref_mean, ref_chol = ref if ref is not None else (prior.mean, prior.chol)
    cands = tuple(int(L) for L in leap_candidates)
    draws = draws or {}
    # phase 1: reach the typical set at the median candidate
    pre = max(n_burn // 2, 8)
    res0 = run_hmc(misfit_fn, prior, theta0, gen, n_steps=pre, n_burn=pre, step=step,
                   n_leap=cands[len(cands) // 2], jitter=jitter, ref=ref, **draws.get("pre", {}))
    state = res0.state._replace(n_accept=torch.zeros_like(res0.state.n_accept))
    log_h = torch.log(res0.step)

    # phase 2: probe every candidate (state and per-chain h carry through)
    chees, accept = [], []
    probe_draws = draws.get("probes", [{}] * len(cands))
    for i, L in enumerate(cands):
        state, log_h, j, a = _chees_probe(
            misfit_fn, prior, ref_mean, ref_chol, state, log_h,
            float(pre + i * (n_adapt + n_meas)), gen, n_leap=L, jitter=jitter, n_adapt=n_adapt,
            n_meas=n_meas, group=group, **probe_draws[i])
        chees.append(j / L)  # per gradient evaluation
        accept.append(a)
    L_star = cands[max(range(len(cands)), key=lambda i: chees[i])]

    # phase 3: the remaining burn-in and the kept run at the winner
    tail_burn = max(n_burn - pre, 8)
    res = run_hmc(misfit_fn, prior, frame(ref_mean, ref_chol)[0](state.y), gen,
                  n_steps=(n_steps - n_burn) + tail_burn, n_burn=tail_burn, step=torch.exp(log_h),
                  n_leap=L_star, jitter=jitter, thin=thin, ref=ref, **draws.get("main", {}))
    info = {"n_leap": L_star, "candidates": list(cands), "chees_per_grad": chees, "accept": accept}
    return res, info
