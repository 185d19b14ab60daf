"""Parallel tempering: exact sampling of multimodal posteriors.

K replicas per chain group target pi_j(x) ~ exp(-lambda_j Phi(x)) mu0(x),
0 < lambda_1 < ... < lambda_K = 1, with mu0 the prior that every level's pCN
proposal shares, and adjacent levels exchange states with the Metropolis
swap rule

    alpha = min(1, exp((lambda_{j+1} - lambda_j) (Phi(x_{j+1}) - Phi(x_j)))) .

The prior factors cancel in the swap, so the cold level (lambda = 1) samples
the exact posterior; hot levels see a flatter likelihood, hop between basins
and pass the hops down the ladder.

States are (K, G, d) tensors, temperature levels x chain groups. A step is
one batched misfit over all K*G proposals (pCN), one forward and reverse
pass over them (MALA, ``run_pt_mala``), or one DA outer step per level with
one batched fine misfit (tempered delayed acceptance, with pCN or MALA
subchains), then an alternating-parity exchange pass written as a
where-shuffle along K. The
loop is a Python loop with no host synchronisation inside it. Every sampler
takes optional pre-drawn draws so a test can replay another implementation's
stream; without them they come from a ``torch.Generator`` in step order:
the move's draws (``pcn_step``'s or ``da_step``'s), then the swap uniforms.

After burn-in the samplers accumulate, per level, the mean untempered misfit,
its second moment and the stepping-stone ratios that infer/evidence.py turns
into the log evidence.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from bayesianinferencedl_tpu_torch.infer.delayed_acceptance import (
    DAState,
    adapt_inner,
    da_step,
    make_inner_kernel,
)
from bayesianinferencedl_tpu_torch.infer.mala import (
    LOG_H,
    TARGET_ACCEPT_MALA,
    frame,
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
    swap_rate_spec,
)

# the adjacent-pair swap acceptance the adaptive ladder steers toward, the
# diffusion-limit optimum (Atchade, Roberts & Rosenthal 2011)
TARGET_SWAP = 0.234
_LOG_BETA = (math.log(1e-4), math.log(0.9999))  # pCN's beta lives in (0, 1)
# caps on a log gap: adjacent-level ratios lambda_{j+1}/lambda_j in
# [e^1e-4, e^3]; the upper cap keeps a flat-likelihood pair from railing its
# gap and parking the hot level at lambda = 0
_LOG_GAP = (math.log(1e-4), math.log(3.0))


class PTResult(NamedTuple):
    samples: torch.Tensor  # (n_kept, G, d) cold-level samples
    phi_trace: torch.Tensor  # (n_kept, G) cold-level misfits
    accept_rate: torch.Tensor  # (K, G) within-level post-burn acceptance
    swap_rate: torch.Tensor  # (K-1,) mean swap acceptance per adjacent pair
    beta: torch.Tensor  # (K, G) final adapted step sizes
    theta: torch.Tensor  # (K, G, d) final states (resume)
    lambdas: torch.Tensor  # (K, G) final ladder (resume)
    phi_level_mean: torch.Tensor  # (K, G) post-burn E_lambda[Phi] per level
    phi2_level_mean: torch.Tensor  # (K, G) post-burn E_lambda[Phi^2] per level
    ss_level_mean: torch.Tensor  # (K-1, G) E_{lambda_j}[exp(-(lambda_{j+1} - lambda_j) Phi)], float64


class PTMALAResult(NamedTuple):
    samples: torch.Tensor  # (n_kept, G, d) cold-level samples, working coordinates
    phi_trace: torch.Tensor  # (n_kept, G) cold-level misfits
    accept_rate: torch.Tensor  # (K, G) within-level post-burn acceptance
    swap_rate: torch.Tensor  # (K-1,) mean swap acceptance per adjacent pair
    step: torch.Tensor  # (K, G) final adapted MALA step sizes h
    theta: torch.Tensor  # (K, G, d) final states, working coordinates (resume)
    lambdas: torch.Tensor  # (K, G) final ladder (resume)
    phi_level_mean: torch.Tensor  # (K, G) post-burn E_lambda[Phi] per level
    phi2_level_mean: torch.Tensor  # (K, G) post-burn E_lambda[Phi^2] per level
    ss_level_mean: torch.Tensor  # (K-1, G) stepping-stone ratios, float64


class PTDAResult(NamedTuple):
    samples: torch.Tensor  # (n_kept, G, d) cold-level samples
    phi_trace: torch.Tensor  # (n_kept, G) cold-level fine misfits
    accept_rate: torch.Tensor  # (K, G) outer (fine-correction) acceptance
    inner_accept_rate: torch.Tensor  # (K, G) coarse subchain acceptance
    swap_rate: torch.Tensor  # (K-1,)
    beta: torch.Tensor  # (K, G) adapted inner step sizes
    theta: torch.Tensor  # (K, G, d) final states (resume)
    n_fine_evals: int  # fine-model batch evaluations, each over K*G states
    lambdas: torch.Tensor  # (K, G) final ladder (resume)
    phi_level_mean: torch.Tensor  # (K, G) post-burn E_lambda[Phi_f]
    phi2_level_mean: torch.Tensor  # (K, G) post-burn E_lambda[Phi_f^2]
    ss_level_mean: torch.Tensor  # (K-1, G) stepping-stone ratios on Phi_f, float64


def geometric_ladder(n_temps: int, lambda_min: float = 0.05, dtype=torch.float32,
                     device="cpu") -> torch.Tensor:
    """Inverse temperatures lambda_min = lambda_1 < ... < lambda_K = 1,
    geometrically spaced."""
    if n_temps == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    exps = torch.linspace(math.log10(lambda_min), 0.0, n_temps, dtype=torch.float64)
    return (10.0 ** exps).to(dtype=dtype, device=device)


def _lam_from_gaps(log_gap: torch.Tensor) -> torch.Tensor:
    """The (K, G) ladder from (K-1, G) log gaps, g_j = log lambda_{j+1} -
    log lambda_j = exp(log_gap_j) > 0, with the cold level pinned at 1: any
    real log gaps give a valid strictly increasing ladder ending at 1."""
    g = torch.exp(log_gap)
    csum = torch.flip(torch.cumsum(torch.flip(g, (0,)), 0), (0,))  # csum[j] = sum_{i >= j} g_i
    return torch.cat([torch.exp(-csum), g.new_ones((1, g.shape[1]))], 0)


def _ladder_init(ladder, n_temps, lambda_min, G, dtype, device):
    """The (K, G) initial ladder and its (K-1, G) log gaps, from an explicit
    ``ladder`` ((K,) or (K, G), e.g. a result's lambdas) or the geometric
    default."""
    if ladder is not None:
        lam = torch.as_tensor(ladder, dtype=dtype, device=device)
    else:
        lam = geometric_ladder(n_temps, lambda_min, dtype, device)
    lam = (lam[:, None] if lam.dim() == 1 else lam).expand(n_temps, G)
    if n_temps == 1:
        return lam, lam.new_zeros((0, G))
    return lam, torch.log(torch.diff(torch.log(lam), dim=0))


def _ladder_update(log_gap, swap_stats, t, t_global, n_burn):
    """One stochastic-approximation step on the log gaps during burn-in:
    each active pair's swap acceptance is driven toward TARGET_SWAP (a pair
    too cold shrinks its gap, too hot widens it). After burn-in the step is
    0 and the ladder is frozen, so the kept samples' kernel is fixed."""
    alpha_lower, active = swap_stats
    eta = 0.5 / (1.0 + t_global) ** 0.6 if t < n_burn else 0.0
    upd = active[:-1] * (alpha_lower[:-1] - TARGET_SWAP)
    return torch.clamp(log_gap + eta * upd, *_LOG_GAP)


def _exchange_plan(K: int, parity: int, device):
    """The pairing of one exchange pass: parity 0 proposes (0,1), (2,3), ...;
    parity 1 (1,2), (3,4), .... Returns (is_lower (K,) bool, partner (K,),
    is_upper (K,) bool): partner[j] is j+1 for the lower member of a pair,
    j-1 for the upper, j otherwise."""
    is_lower = [j % 2 == parity and j + 1 < K for j in range(K)]
    is_upper = [j >= 1 and is_lower[j - 1] for j in range(K)]
    partner = [j + 1 if is_lower[j] else j - 1 if is_upper[j] else j for j in range(K)]
    as_t = lambda v, dt: torch.tensor(v, dtype=dt, device=device)
    return as_t(is_lower, torch.bool), as_t(partner, torch.int64), as_t(is_upper, torch.bool)


def _replica_exchange(t_global, lambdas, phi_ratio, fields, u_sw, n_swap, kept, plans):
    """One alternating-parity adjacent-pair exchange pass. The parity comes
    from the global step t_global (= t + adapt_t0), so a segmented run
    continues the unsegmented run's pattern. The swap ratio is evaluated on
    the lower member, log ratio = (lambda_{j+1} - lambda_j)(Phi_{j+1} -
    Phi_j); states move between levels while (lambda, beta) stay with the
    level.

    phi_ratio: (K, G) untempered misfits (Phi_f for tempered DA); lambdas
    (K, G); fields: (K, G, ...) tensors shuffled alike; u_sw: (K, G) swap
    uniforms; kept: whether the step is post-burn (counts the swaps);
    plans: the two parities' ``_exchange_plan``. Returns (shuffled fields,
    swap counts (K-1,), (alpha (K, G), active (K, 1))): the lower members'
    swap probabilities masked to the active pairs, which the adaptive
    ladder integrates."""
    K = phi_ratio.shape[0]
    is_lower, partner, is_upper = plans[int(t_global) % 2]
    up = torch.clamp(torch.arange(1, K + 1, device=phi_ratio.device), max=K - 1)
    log_a = (lambdas[up] - lambdas) * (phi_ratio[up] - phi_ratio)
    acc_lower = (torch.log(u_sw) < log_a) & is_lower[:, None]
    # a slot swaps iff it is the lower member of an accepted pair or its partner
    do_swap = acc_lower | torch.roll(acc_lower, 1, 0) & is_upper[:, None]

    def shuffle(a):
        m = do_swap.reshape(do_swap.shape + (1,) * (a.dim() - 2))
        return torch.where(m, a[partner], a)

    fields = tuple(shuffle(a) for a in fields)
    if kept:
        n_swap = n_swap + acc_lower.to(phi_ratio.dtype).mean(1)[:-1]
    active = is_lower[:, None].to(phi_ratio.dtype)
    alpha_lower = torch.exp(torch.clamp(log_a, max=0.0)) * active
    return fields, n_swap, (alpha_lower, active)


def _levels(theta0: torch.Tensor, n_temps: int, kind: str) -> torch.Tensor:
    """(K, G, d) level states from (G, d) cold inits (every level starts
    there) or (K, G, d) resume states."""
    if theta0.dim() == 2:
        return theta0.expand(n_temps, *theta0.shape)
    if theta0.shape[0] != n_temps:
        raise ValueError(
            f"resume states theta0 carry {theta0.shape[0]} temperature levels but "
            f"n_temps={n_temps}: a PT run must be resumed with the ladder size it was saved "
            f"with ({kind}.theta is (n_temps, G, d))"
        )
    return theta0


class _Accumulators:
    """The post-burn per-level sums of Phi, Phi^2 and the stepping-stone
    ratios (level j's state scored against the next level's gap). The ratios
    exp(-(lambda_{j+1} - lambda_j) Phi) are taken and summed in float64
    whatever the run's dtype: in float32 they underflow to 0 once the
    exponent passes ~87 (a hot level at a small noise), and a group whose
    ratios all underflow has log Z = -inf."""

    def __init__(self, phi):
        self.phi = torch.zeros_like(phi)
        self.phi2 = torch.zeros_like(phi)
        self.ss = torch.zeros_like(phi[:-1], dtype=torch.float64)

    def add(self, lambdas, phi):
        self.phi = self.phi + phi
        self.phi2 = self.phi2 + phi * phi
        self.ss = self.ss + torch.exp((-(lambdas[1:] - lambdas[:-1]) * phi[:-1]).double())

    def means(self, n_keep):
        n = max(n_keep, 1)
        return self.phi / n, self.phi2 / n, self.ss / n


def _stack(xs, shape, like):
    return torch.stack(xs) if xs else like.new_zeros((0, *shape))


def run_pt_pcn(
    misfit_fn: Callable,
    prior: GaussianPrior,
    theta0: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int,
    n_burn: int = 0,
    beta=0.25,
    n_temps: int = 4,
    lambda_min: float = 0.05,
    adapt: bool = True,
    adapt_t0: float = 0.0,
    adapt_ladder: bool = False,
    ladder=None,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    swap_uniforms: Optional[torch.Tensor] = None,
) -> PTResult:
    """Parallel-tempered pCN over G chain groups x K temperature levels.

    misfit_fn: the untempered, batched data misfit Phi, (B, d) -> (B,); each
    step evaluates it once on all K*G proposals. theta0: (G, d) cold inits or
    (K, G, d) resume states. beta: scalar or (K, G); every level adapts its
    per-chain step size toward 0.234 acceptance during burn-in (unless
    ``adapt`` is False). adapt_ladder: also tune each group's ladder during burn-in, driving every
    adjacent pair's swap acceptance toward TARGET_SWAP with the cold level
    pinned at 1 (the geometric ladder from lambda_min, or ``ladder``, is the
    starting point); frozen afterwards. adapt_t0: the global index of the
    first step (segmented runs). normals (n_steps, K, G, d), uniforms and
    swap_uniforms (n_steps, K, G): optional pre-drawn draws, burn-in first.
    Returns cold-level samples only."""
    K = n_temps
    theta = _levels(theta0, K, "PTResult")
    _, G, d = theta.shape
    dtype, dev = theta.dtype, theta.device
    lam0, log_gap = _ladder_init(ladder, K, lambda_min, G, dtype, dev)

    def phi_all(th):  # (K, G, d) -> (K, G)
        return misfit_fn(th.reshape(K * G, d)).reshape(K, G)

    state = PCNState(theta=theta, phi=phi_all(theta), n_accept=torch.zeros((K, G), dtype=torch.int32,
                                                                           device=dev))
    log_beta = torch.log(torch.as_tensor(beta, dtype=dtype, device=dev).expand(K, G))
    n_swap = torch.zeros((max(K - 1, 0),), dtype=dtype, device=dev)
    plans = [_exchange_plan(K, p, dev) for p in (0, 1)]
    acc_sums = _Accumulators(state.phi)
    pick = lambda a, t: None if a is None else a[t]
    samples, phis = [], []
    for t in range(n_steps):
        lambdas = _lam_from_gaps(log_gap) if adapt_ladder else lam0
        state, acc = pcn_step(phi_all, prior, torch.exp(log_beta), state, gen,
                              normals=pick(normals, t), uniforms=pick(uniforms, t), lam=lambdas)
        t_global = t + adapt_t0
        if adapt:
            eta = 0.5 / (1.0 + t_global) ** 0.6 if t < n_burn else 0.0
            log_beta = torch.clamp(log_beta + eta * (acc.to(dtype) - TARGET_ACCEPT), *_LOG_BETA)
        if K > 1:
            u_sw = pick(swap_uniforms, t)
            if u_sw is None:
                u_sw = torch.rand((K, G), generator=gen, dtype=dtype, device=dev)
            (th, ph), n_swap, stats = _replica_exchange(
                t_global, lambdas, state.phi, (state.theta, state.phi), u_sw, n_swap, t >= n_burn, plans)
            state = state._replace(theta=th, phi=ph)
            if adapt_ladder:
                log_gap = _ladder_update(log_gap, stats, t, t_global, n_burn)
        if t >= n_burn:
            acc_sums.add(lambdas, state.phi)
            samples.append(state.theta[-1])
            phis.append(state.phi[-1])
        if t + 1 == n_burn:  # the post-burn counters start from 0
            state = state._replace(n_accept=torch.zeros_like(state.n_accept))
            n_swap = torch.zeros_like(n_swap)
    n_keep = n_steps - n_burn
    phi_mean, phi2_mean, ss_mean = acc_sums.means(n_keep)
    return PTResult(
        samples=_stack(samples, (G, d), theta),
        phi_trace=_stack(phis, (G,), theta),
        accept_rate=state.n_accept.to(torch.float32) / max(n_keep, 1),
        # each adjacent pair is proposed every other step
        swap_rate=n_swap / max(n_keep / 2, 1),
        beta=torch.exp(log_beta),
        theta=state.theta,
        lambdas=_lam_from_gaps(log_gap) if adapt_ladder else lam0,
        phi_level_mean=phi_mean,
        phi2_level_mean=phi2_mean,
        ss_level_mean=ss_mean,
    )


def run_pt_mala(
    misfit_fn: Callable,
    prior: GaussianPrior,
    theta0: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int,
    n_burn: int = 0,
    step=0.1,
    n_temps: int = 4,
    lambda_min: float = 0.05,
    adapt: bool = True,
    adapt_t0: float = 0.0,
    adapt_ladder: bool = False,
    ladder=None,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    swap_uniforms: Optional[torch.Tensor] = None,
) -> PTMALAResult:
    """Gradient-informed parallel tempering: MALA within-level moves and
    replica exchange. Level j runs drift-clipped whitened MALA on its
    tempered target -log pi_j(y) = lambda_j Phi(theta(y)) + ||y||^2 / 2 in
    the prior's frame (``mala.tempered_mala_step``), at one forward and
    reverse pass over the whole (K*G, d) batch a step; the misfit and its
    gradient in y are carried per level and swap with the state, so a swap
    costs no evaluation. Swaps follow ``run_pt_pcn``'s rule on the carried
    untempered misfits, so the cold level samples the exact posterior.

    misfit_fn: batched and differentiable. theta0 (G, d) cold inits or
    (K, G, d) resume states, in working coordinates. step: scalar or (K, G);
    every level adapts per-chain log h toward 57.4% acceptance in burn-in
    (adapt=True). adapt_ladder / ladder / adapt_t0 as in ``run_pt_pcn``.
    normals (n_steps, K, G, d), uniforms and swap_uniforms (n_steps, K, G):
    optional pre-drawn draws, burn-in first."""
    K = n_temps
    theta = _levels(theta0, K, "PTMALAResult")
    _, G, d = theta.shape
    dtype, dev = theta.dtype, theta.device
    lam0, log_gap = _ladder_init(ladder, K, lambda_min, G, dtype, dev)
    to_theta, to_y = frame(prior.mean, prior.chol)
    phi_grad = misfit_grad_fn(misfit_fn, prior)

    y = to_y(theta)
    phi, gphi = phi_grad(y)
    log_h = torch.log(torch.as_tensor(step, dtype=dtype, device=dev).expand(K, G))
    n_accept = torch.zeros((K, G), dtype=torch.int32, device=dev)
    n_swap = torch.zeros((max(K - 1, 0),), dtype=dtype, device=dev)
    plans = [_exchange_plan(K, p, dev) for p in (0, 1)]
    acc_sums = _Accumulators(phi)
    pick = lambda a, t: None if a is None else a[t]
    samples, phis = [], []
    for t in range(n_steps):
        lambdas = _lam_from_gaps(log_gap) if adapt_ladder else lam0
        xi, u = draws(gen, y.shape, dtype, dev, pick(normals, t), pick(uniforms, t))
        y, phi, gphi, acc = tempered_mala_step(phi_grad, lambdas, torch.exp(log_h), y, phi, gphi,
                                               xi, u)
        n_accept = n_accept + acc.to(torch.int32)
        t_global = t + adapt_t0
        if adapt:
            eta = 0.5 / (1.0 + t_global) ** 0.6 if t < n_burn else 0.0
            log_h = torch.clamp(log_h + eta * (acc.to(dtype) - TARGET_ACCEPT_MALA), *LOG_H)
        if K > 1:
            u_sw = pick(swap_uniforms, t)
            if u_sw is None:
                u_sw = torch.rand((K, G), generator=gen, dtype=dtype, device=dev)
            (y, phi, gphi), n_swap, stats = _replica_exchange(
                t_global, lambdas, phi, (y, phi, gphi), u_sw, n_swap, t >= n_burn, plans)
            if adapt_ladder:
                log_gap = _ladder_update(log_gap, stats, t, t_global, n_burn)
        if t >= n_burn:
            acc_sums.add(lambdas, phi)
            samples.append(to_theta(y[-1]))
            phis.append(phi[-1])
        if t + 1 == n_burn:  # the post-burn counters start from 0
            n_accept, n_swap = torch.zeros_like(n_accept), torch.zeros_like(n_swap)
    n_keep = n_steps - n_burn
    phi_mean, phi2_mean, ss_mean = acc_sums.means(n_keep)
    return PTMALAResult(
        samples=_stack(samples, (G, d), theta),
        phi_trace=_stack(phis, (G,), theta),
        accept_rate=n_accept.to(torch.float32) / max(n_keep, 1),
        swap_rate=n_swap / max(n_keep / 2, 1),
        step=torch.exp(log_h),
        theta=to_theta(y),
        lambdas=_lam_from_gaps(log_gap) if adapt_ladder else lam0,
        phi_level_mean=phi_mean,
        phi2_level_mean=phi2_mean,
        ss_level_mean=ss_mean,
    )


def run_pt_da(
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
    n_temps: int = 4,
    lambda_min: float = 0.05,
    adapt: bool = True,
    adapt_t0: float = 0.0,
    inner: str = "pcn",
    adapt_ladder: bool = False,
    ladder=None,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    outer_uniforms: Optional[torch.Tensor] = None,
    swap_uniforms: Optional[torch.Tensor] = None,
) -> PTDAResult:
    """Tempered delayed acceptance: the exact fine posterior on a multimodal
    problem at ~1/subchain of the fine evaluations.

    Level j's move is one DA outer step (infer/delayed_acceptance.py
    ``da_step``): ``subchain`` pCN steps on exp(-lambda_j Phi_c) mu0, then one
    Metropolis correction with log alpha = lambda_j [(Phi_f - Phi_f*) -
    (Phi_c - Phi_c*)], which is pi_j-invariant. The fine misfit runs once per
    outer step on all K*G subchain endpoints; swaps use the carried fine
    misfits, so the cold level samples the exact fine posterior. n_steps and
    n_burn count outer steps; beta: scalar or (K, G); during burn-in each
    chain's inner step size adapts toward 0.234 effective acceptance (inner
    fraction x outer accept; ``delayed_acceptance.adapt_inner``). inner:
    "pcn", or "mala" (tempered drift-clipped MALA subchains on
    lambda_j Phi_c(theta(y)) + ||y||^2 / 2 in the prior's frame; the coarse
    misfit must be differentiable and beta is the initial step size h).
    adapt (False freezes the inner step sizes), adapt_ladder / ladder / adapt_t0 as in
    ``run_pt_pcn``. normals (n_steps, subchain, K, G, d), uniforms
    (n_steps, subchain, K, G), outer_uniforms and swap_uniforms
    (n_steps, K, G): optional pre-drawn draws, burn-in first."""
    K = n_temps
    theta = _levels(theta0, K, "PTDAResult")
    _, G, d = theta.shape
    dtype, dev = theta.dtype, theta.device
    make_inner_kernel(inner, misfit_coarse, prior)  # refuses an unknown kernel before any solve
    lam0, log_gap = _ladder_init(ladder, K, lambda_min, G, dtype, dev)
    flat = lambda fn: lambda th: fn(th.reshape(K * G, d)).reshape(K, G)
    fine_all, coarse_all = flat(misfit_fine), flat(misfit_coarse)

    zeros_i = torch.zeros((K, G), dtype=torch.int32, device=dev)
    state = DAState(theta=theta, phi_f=fine_all(theta), phi_c=coarse_all(theta), n_accept=zeros_i)
    log_beta = torch.log(torch.as_tensor(beta, dtype=dtype, device=dev).expand(K, G))
    ema = torch.full((K, G), 0.5, dtype=dtype, device=dev)  # adapt_inner's outer-accept estimate
    n_in = zeros_i
    n_swap = torch.zeros((max(K - 1, 0),), dtype=dtype, device=dev)
    plans = [_exchange_plan(K, p, dev) for p in (0, 1)]
    acc_sums = _Accumulators(state.phi_f)
    pick = lambda a, t: None if a is None else a[t]
    samples, phis = [], []
    for t in range(n_steps):
        lambdas = _lam_from_gaps(log_gap) if adapt_ladder else lam0
        kernel = make_inner_kernel(inner, coarse_all, prior, lam=lambdas)
        state, acc, n_in_step = da_step(
            fine_all, kernel, torch.exp(log_beta), subchain, state, gen, normals=pick(normals, t),
            uniforms=pick(uniforms, t), outer_uniform=pick(outer_uniforms, t), lam=lambdas)
        n_in = n_in + n_in_step
        t_global = t + adapt_t0
        if adapt:
            eta = 0.5 / (1.0 + t_global) ** 0.6 if t < n_burn else 0.0
            log_beta, ema = adapt_inner(inner, log_beta, ema, n_in_step.to(dtype) / subchain, acc,
                                        eta, kernel.target)
        if K > 1:
            u_sw = pick(swap_uniforms, t)
            if u_sw is None:
                u_sw = torch.rand((K, G), generator=gen, dtype=dtype, device=dev)
            (th, pf, pc), n_swap, stats = _replica_exchange(
                t_global, lambdas, state.phi_f, (state.theta, state.phi_f, state.phi_c), u_sw,
                n_swap, t >= n_burn, plans)
            state = state._replace(theta=th, phi_f=pf, phi_c=pc)
            if adapt_ladder:
                log_gap = _ladder_update(log_gap, stats, t, t_global, n_burn)
        if t >= n_burn:
            acc_sums.add(lambdas, state.phi_f)
            samples.append(state.theta[-1])
            phis.append(state.phi_f[-1])
        if t + 1 == n_burn:  # the post-burn counters start from 0
            state = state._replace(n_accept=torch.zeros_like(state.n_accept))
            n_in, n_swap = torch.zeros_like(n_in), torch.zeros_like(n_swap)
    n_keep = n_steps - n_burn
    phi_mean, phi2_mean, ss_mean = acc_sums.means(n_keep)
    return PTDAResult(
        samples=_stack(samples, (G, d), theta),
        phi_trace=_stack(phis, (G,), theta),
        accept_rate=state.n_accept.to(torch.float32) / max(n_keep, 1),
        inner_accept_rate=n_in.to(torch.float32) / max(n_keep * subchain, 1),
        swap_rate=n_swap / max(n_keep / 2, 1),
        beta=torch.exp(log_beta),
        theta=state.theta,
        n_fine_evals=n_steps + 1,
        lambdas=_lam_from_gaps(log_gap) if adapt_ladder else lam0,
        phi_level_mean=phi_mean,
        phi2_level_mean=phi2_mean,
        ss_level_mean=ss_mean,
    )


def run_pt_da_segmented(
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
    n_temps: int = 4,
    lambda_min: float = 0.05,
    segment: int = 32,
    inner: str = "pcn",
    adapt_ladder: bool = False,
    ladder=None,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    outer_uniforms: Optional[torch.Tensor] = None,
    swap_uniforms: Optional[torch.Tensor] = None,
) -> PTDAResult:
    """``run_pt_da`` in segments of at most ``segment`` outer steps
    (``infer.segmented``): the level states, adapted betas and the ladder
    carry across segments, the adaptation clock and exchange parity run on,
    and the rates and level accumulators cover the whole post-burn run.
    segment must be even: exchange parity runs on the global step, so an
    even segment proposes each adjacent pair exactly kept/2 times and the
    accumulated swap-rate normalisation is exact. Draws as for
    ``run_pt_da``, for the whole run."""
    if segment % 2:
        raise ValueError(f"segment must be even for exact swap accounting, got {segment}")
    part = lambda a, start, this: None if a is None else a[start:start + this]

    def seg(carry, this, burn, start):
        thetas, betas, lam = carry
        res = run_pt_da(
            misfit_fine, misfit_coarse, prior, thetas, gen, n_steps=this, n_burn=burn, beta=betas,
            subchain=subchain, n_temps=n_temps, lambda_min=lambda_min, adapt_t0=float(start),
            inner=inner, adapt_ladder=adapt_ladder, ladder=lam,
            normals=part(normals, start, this), uniforms=part(uniforms, start, this),
            outer_uniforms=part(outer_uniforms, start, this),
            swap_uniforms=part(swap_uniforms, start, this),
        )
        return res, (res.theta, res.beta, res.lambdas)

    per_kept = lambda get: (get, lambda kept: kept, lambda total: max(total, 1))
    res, (_, betas, lambdas), samples, phis, rates, _ = drive_segments(
        seg, (theta0, beta, ladder), n_steps=n_steps, n_burn=n_burn, segment=segment,
        rates={
            "accept": accept_rate_spec(),
            "inner": inner_accept_rate_spec(subchain),
            "swap": swap_rate_spec(),
            # the level accumulators are post-burn means: the same count and
            # renormalise machinery as the rates
            "phi_mean": per_kept(lambda r: r.phi_level_mean),
            "phi2_mean": per_kept(lambda r: r.phi2_level_mean),
            "ss_mean": per_kept(lambda r: r.ss_level_mean),
        },
    )
    return PTDAResult(
        samples=samples,
        phi_trace=phis,
        accept_rate=rates["accept"],
        inner_accept_rate=rates["inner"],
        swap_rate=rates["swap"],
        beta=betas,
        theta=res.theta,
        n_fine_evals=n_steps + (n_steps + segment - 1) // segment,
        lambdas=lambdas,
        phi_level_mean=rates["phi_mean"],
        phi2_level_mean=rates["phi2_mean"],
        ss_level_mean=rates["ss_mean"],
    )
