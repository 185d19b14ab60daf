"""Normalizing-flow variational inference and flow-preconditioned (NeuTra)
MCMC (Rezende & Mohamed 2015; Hoffman et al. 2019).

q is the push-forward of N(0, I) through an invertible RealNVP-style
coupling flow whose first layer is ADVI's full-rank affine map
Y = mu + L z (infer/vi.py), followed by affine coupling layers with
alternating even/odd masks: the active half is scaled and shifted by a tanh
MLP of the passive half, the log-scales bounded to (-s_max, s_max). With
zeroed last coupling layers the flow is the identity, so the family
contains full-rank ADVI.

- ``run_flow_vi`` maximises the reparameterised ELBO (reverse KL, the
  log-determinant analytic: the sum of the bounded log-scales) with an
  optional geometric tempering ramp on the misfit. Mode-seeking: on well
  separated basins it collapses to one.
- ``fit_flow_mle`` fits the flow by weighted maximum likelihood on a
  particle population (forward KL, mass-covering), smoothed by a Liu-West
  kernel so that a population of few unique rows stays a proper density.
- ``flow_fit_pipeline`` composes them as production does: tempered SMC
  (infer/smc.py) -> MLE distillation -> an optional reverse-KL refinement.
- ``flow_psis_certify`` certifies a fit by PSIS (infer/psis.py): the draws
  carry their exact log q through their latent coordinates.
- ``neutra_misfit`` / ``run_neutra_pcn`` run pCN on the exact posterior
  pulled back to the flow's latent space against an N(0, I) reference
  measure; the pushed samples are exact posterior draws whatever the flow's
  quality (a bad flow costs mixing, not correctness).

Every training step is one eager forward and reverse pass over the Monte
Carlo (or minibatch) axis and one Adam update of the flow's leaves, with
the reference's Adam formula (``models.surrogate.adam_update``). Products
the reference pins to full precision run inside ``fp32_matmul()``. Every
draw comes from a ``torch.Generator`` in a fixed order, or can be passed
in pre-drawn.
"""

from __future__ import annotations

import copy
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from bayesianinferencedl_tpu_torch.infer.pcn import PCNResult, run_pcn
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.infer.psis import PSISResult, psis_correct_draws
from bayesianinferencedl_tpu_torch.infer.samplers import inv_chol
from bayesianinferencedl_tpu_torch.models.surrogate import MLP, adam_init, adam_update
from bayesianinferencedl_tpu_torch.parallel.mesh import mean_all
from bayesianinferencedl_tpu_torch.utils.device import child_generator, resolve_device
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul

# kept latent samples are pushed to working coordinates about this many rows at a time
_PUSH_ROWS = 1 << 20


class CouplingFlow(nn.Module):
    """Layer 0 is the full-rank affine map Y = mu + L z with L = tril(raw, -1)
    + diag(exp(diag(raw))); then ``n_couplings`` affine coupling layers.
    Layer l's active coordinates are those with (id + l) even; its MLP, of
    sizes (|passive|, hidden, hidden, 2 |active|), maps the passive half to
    (s, t) and the active half becomes y exp(s_max tanh(s / s_max)) + t.

    Built identity-initialised on ``device`` (the card unless the caller asks
    for the CPU): mu = 0, raw = 0, each coupling MLP drawn (from
    ``generator``) and its last layer zeroed, so forward(Z) = Z with
    log-determinant 0."""

    def __init__(self, dim: int, n_couplings: int = 6, hidden: int = 32, s_max: float = 3.0, *,
                 generator: Optional[torch.Generator] = None, dtype=torch.float32, device="cuda"):
        super().__init__()
        if dim < 2 and n_couplings > 0:
            raise ValueError("coupling layers need dim >= 2 (use n_couplings=0)")
        device = resolve_device(device)
        self.dim, self.n_couplings, self.hidden, self.s_max = int(dim), int(n_couplings), int(hidden), float(s_max)
        self.mu = nn.Parameter(torch.zeros((dim,), dtype=dtype, device=device))
        self.raw = nn.Parameter(torch.zeros((dim, dim), dtype=dtype, device=device))
        self.couplings = nn.ModuleList()
        self._masks = []
        ids = np.arange(dim)
        for layer in range(n_couplings):
            active, passive = ids[(ids + layer) % 2 == 0], ids[(ids + layer) % 2 == 1]
            self._masks.append((torch.as_tensor(active, device=device), torch.as_tensor(passive, device=device)))
            mlp = MLP((len(passive), hidden, hidden, 2 * len(active)), "tanh", generator=generator,
                      dtype=dtype, device=device)
            with torch.no_grad():
                mlp.weights[-1].zero_()
                mlp.biases[-1].zero_()
            self.couplings.append(mlp)

    def params(self) -> list[torch.Tensor]:
        """The leaves in the reference's order: mu, raw, then each coupling's
        [W0, b0, W1, b1, W2, b2]."""
        out = [self.mu, self.raw]
        for mlp in self.couplings:
            out += mlp.params()
        return out

    def _affine_chol(self) -> torch.Tensor:
        raw = self.raw
        return torch.tril(raw, -1) + torch.diag(torch.exp(torch.diagonal(raw)))

    def _scale_shift(self, layer: int, Y: torch.Tensor):
        active, passive = self._masks[layer]
        st = self.couplings[layer](Y.index_select(-1, passive))
        na = active.numel()
        s = self.s_max * torch.tanh(st[..., :na] / self.s_max)
        return active, s, st[..., na:]

    def forward(self, Z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Y = f(Z) and log|det df/dZ|, over any leading batch dims: Z (..., d)
        -> (Y (..., d), logdet (...,))."""
        with fp32_matmul():
            Y = self.mu + Z @ self._affine_chol().T
        logdet = torch.sum(torch.diagonal(self.raw)) + Z.new_zeros(Z.shape[:-1])
        for layer in range(self.n_couplings):
            active, s, t = self._scale_shift(layer, Y)
            Y = Y.index_copy(-1, active, Y.index_select(-1, active) * torch.exp(s) + t)
            logdet = logdet + torch.sum(s, dim=-1)
        return Y, logdet

    def inverse(self, Y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Z = f^-1(Y) and log|det df/dZ| at that Z, so that forward(inverse(Y))
        gives back both. The couplings invert analytically, the affine layer
        by the inverse of its Cholesky factor (the reference's _inv_chol)."""
        logdet = Y.new_zeros(Y.shape[:-1])
        for layer in reversed(range(self.n_couplings)):
            active, s, t = self._scale_shift(layer, Y)
            Y = Y.index_copy(-1, active, (Y.index_select(-1, active) - t) * torch.exp(-s))
            logdet = logdet + torch.sum(s, dim=-1)
        with fp32_matmul():
            Z = (Y - self.mu) @ inv_chol(self._affine_chol()).T
        return Z, logdet + torch.sum(torch.diagonal(self.raw))


class FlowVIResult(NamedTuple):
    flow: CouplingFlow  # the trained flow (its latent frame is the whitened ref)
    ref_mean: torch.Tensor  # (d,) the frame pushing latent Y to working coordinates
    ref_chol: torch.Tensor  # (d, d)
    elbo_trace: torch.Tensor  # (n_steps,) per-step MC ELBO, or (fit_flow_mle) minus the NLL
    theta_mean: torch.Tensor  # (d,) Monte-Carlo moment summary in working coordinates
    theta_cov: torch.Tensor  # (d, d) for reporting only: draw from the flow for anything downstream
    n_forward: int  # differentiable forward evaluations


def _flow_to_train(params: Optional[CouplingFlow], d: int, n_couplings: int, hidden: int,
                   gen, dtype, dev) -> CouplingFlow:
    """A copy of the warm start ``params``, else an identity flow drawn from gen."""
    if params is None:
        return CouplingFlow(d, n_couplings, hidden, generator=gen, dtype=dtype, device=dev)
    if (params.dim, params.n_couplings, params.hidden) != (d, n_couplings, hidden):
        raise ValueError(f"warm start has (dim, n_couplings, hidden) = "
                         f"{(params.dim, params.n_couplings, params.hidden)}, not {(d, n_couplings, hidden)}")
    return copy.deepcopy(params)


def flow_sample(res: FlowVIResult, gen: Optional[torch.Generator] = None, shape=(), *,
                with_logq: bool = False, base_scale: float = 1.0, Z: Optional[torch.Tensor] = None):
    """theta ~ q in working coordinates. with_logq=True also returns log q(theta)
    in infer/psis.py's convention (the (2 pi)^(d/2) base constant dropped,
    the frame's determinant included), exact because each draw carries its
    latent point.

    base_scale > 1 widens the base to N(0, base_scale^2 I) before the push
    (defensive importance sampling: fatter tails everywhere, log q still
    exact). Z (*shape, d): the base points themselves (already scaled),
    else base_scale times normals drawn from gen."""
    d = res.flow.dim
    dtype, dev = res.ref_mean.dtype, res.ref_mean.device
    s = torch.tensor(base_scale, dtype=dtype, device=dev)
    if Z is None:
        Z = s * torch.randn((*shape, d), generator=gen, dtype=dtype, device=dev)
    Z = torch.as_tensor(Z, dtype=dtype, device=dev)
    with torch.no_grad():
        Y, logdet = res.flow(Z)
        with fp32_matmul():
            theta = res.ref_mean + Y @ res.ref_chol.T
        if not with_logq:
            return theta
        log_det_ref = torch.sum(torch.log(torch.abs(torch.diagonal(res.ref_chol))))
        log_q = -0.5 * torch.sum((Z / s) ** 2, dim=-1) - d * torch.log(s) - logdet - log_det_ref
    return theta, log_q


def _summarised(res: FlowVIResult, gen, n_summary: int, Z) -> FlowVIResult:
    """res with its moment summary over n_summary flow draws (or Z's)."""
    th = flow_sample(res, gen, (n_summary,), Z=Z)
    mean = torch.mean(th, dim=0)
    c = th - mean
    with fp32_matmul():
        cov = c.T @ c / (th.shape[0] - 1)
    return res._replace(theta_mean=mean, theta_cov=cov)


def run_flow_vi(
    misfit_fn: Callable,
    prior: GaussianPrior,
    gen: Optional[torch.Generator] = None,
    *,
    n_couplings: int = 6,
    hidden: int = 32,
    n_steps: int = 3000,
    n_mc: int = 64,
    lr: float = 0.01,
    lr_decay: float = 0.05,
    anneal_steps: Optional[int] = None,
    lambda0: float = 0.05,
    ref=None,
    params: Optional[CouplingFlow] = None,
    n_summary: int = 4096,
    segment: Optional[int] = None,
    eps: Optional[torch.Tensor] = None,
    summary_Z: Optional[torch.Tensor] = None,
    group=None,
) -> FlowVIResult:
    """Fit the coupling flow by annealed reparameterised ELBO ascent and
    return it with a Monte-Carlo moment summary in working coordinates.
    misfit_fn is batched and differentiable, on working coordinates.

    Each step's loss is mean[lambda_t phi + prior_nlp](theta(f(eps))) -
    mean[logdet f]; lambda_t rises geometrically from lambda0 to 1 over the
    first anneal_steps steps (default n_steps // 2; 0 turns the ramp off,
    the plain mode-seeking ELBO). The trace holds the lambda = 1 ELBO. The
    step size decays linearly from lr to lr_decay * lr. ref=(mean, chol):
    the whitened frame (default the prior's); params: a flow to start from
    (copied, e.g. a fit_flow_mle result's .flow), else an identity flow.

    Draws from gen, in order: the identity flow's couplings (without
    params), each step's normals (n_mc, d), the n_summary summary draws.
    eps (n_steps, n_mc, d) and summary_Z (n_summary, d) pass them in.
    ``segment``, the reference's scan chunk size, is accepted and changes
    nothing: one eager loop runs every step. group: the mesh the Monte
    Carlo axis is sharded over (``parallel.sharding.sharded_flow_vi``):
    n_mc and eps are this rank's, the gradients and the reported ELBO
    become means over the ranks, and params and summary_Z must be the same
    on every rank."""
    if n_steps <= 0:
        raise ValueError("run_flow_vi needs n_steps > 0")
    d = prior.dim
    ref_mean, ref_chol = ref if ref is not None else (prior.mean, prior.chol)
    dtype, dev = ref_mean.dtype, ref_mean.device
    flow = _flow_to_train(params, d, n_couplings, hidden, gen, dtype, dev)
    leaves = flow.params()
    opt = adam_init(leaves)
    if anneal_steps is None:
        anneal_steps = n_steps // 2
    Li = inv_chol(prior.chol)
    log_lambda0 = torch.log(torch.tensor(lambda0, dtype=dtype, device=dev))

    trace = []
    for t in range(n_steps):
        e = (torch.randn((n_mc, d), generator=gen, dtype=dtype, device=dev) if eps is None
             else torch.as_tensor(eps[t], dtype=dtype, device=dev))
        g = torch.tensor(t, dtype=dtype, device=dev)
        lam = (torch.exp(log_lambda0 * (1.0 - torch.clamp(g / anneal_steps, max=1.0))) if anneal_steps > 0
               else torch.ones((), dtype=dtype, device=dev))
        with torch.enable_grad(), fp32_matmul():
            Y, logdet = flow(e)
            theta = ref_mean + Y @ ref_chol.T
            phi = misfit_fn(theta)
            w = (theta - prior.mean) @ Li.T
            prior_nlp = 0.5 * torch.sum(w * w, dim=-1)
            loss = torch.mean(lam * phi + prior_nlp) - torch.mean(logdet)
            grads = torch.autograd.grad(loss, leaves)
        # the lambda = 1 negative ELBO is the one reported
        nelbo = torch.mean(phi.detach() + prior_nlp.detach()) - torch.mean(logdet.detach())
        if group is not None:
            nelbo, *grads = mean_all(group, [nelbo, *grads])
        opt = adam_update(leaves, grads, opt, lr * (1.0 - (1.0 - lr_decay) * g / max(n_steps, 1)))
        trace.append(-nelbo)

    res = FlowVIResult(flow=flow, ref_mean=ref_mean, ref_chol=ref_chol, elbo_trace=torch.stack(trace),
                       theta_mean=torch.zeros((d,), dtype=dtype, device=dev),
                       theta_cov=torch.eye(d, dtype=dtype, device=dev), n_forward=n_mc * n_steps)
    return _summarised(res, gen, n_summary, summary_Z)


def fit_flow_mle(
    particles: torch.Tensor,
    prior: GaussianPrior,
    gen: Optional[torch.Generator] = None,
    *,
    weights: Optional[torch.Tensor] = None,
    n_couplings: int = 6,
    hidden: int = 32,
    n_steps: int = 2000,
    n_batch: int = 256,
    lr: float = 0.01,
    lr_decay: float = 0.05,
    jitter: Optional[float] = None,
    ref=None,
    params: Optional[CouplingFlow] = None,
    n_summary: int = 4096,
    idx: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
    summary_Z: Optional[torch.Tensor] = None,
) -> FlowVIResult:
    """Fit the flow by (weighted) maximum likelihood on posterior particles:
    the forward-KL, mass-covering direction, so a basin the particles touch
    cannot be dropped (it would cost unbounded NLL on its particles).

    particles (N, d) in working coordinates, whitened by ref (default the
    prior's frame); weights (N,) optional importance weights, normalised
    here. Each step draws n_batch rows with replacement by weight and
    replaces each by the Liu-West kernel draw mu + sqrt(1 - h^2)(y - mu) +
    h sd eps with fresh normals (mu, sd the weighted per-dimension mean and
    sd, the sd floored at the dtype's tiny), so the target is a
    covariance-preserving kernel density, not atoms: a resampled SMC
    population at tight noise can hold only dozens of unique rows. jitter is
    h; None takes Silverman's (4 / (d + 2))^(1 / (d + 4)) n_unique^(-1 / (d
    + 4)) from the count of unique whitened rows (on the host), capped at
    0.8; 0 turns the kernel off. The trace is minus the NLL.

    Draws from gen, in order: the identity flow's couplings (without
    params), then each step's rows (n_batch uniforms through the weights'
    inverse CDF, the reference's formula) and normals, then the summary
    draws. idx (n_steps, n_batch), eps (n_steps, n_batch, d) and summary_Z
    (n_summary, d) pass them in."""
    d = prior.dim
    ref_mean, ref_chol = ref if ref is not None else (prior.mean, prior.chol)
    dtype, dev = ref_mean.dtype, ref_mean.device
    flow = _flow_to_train(params, d, n_couplings, hidden, gen, dtype, dev)
    leaves = flow.params()
    opt = adam_init(leaves)

    with fp32_matmul():
        Yp = (torch.as_tensor(particles, dtype=dtype, device=dev) - ref_mean) @ inv_chol(ref_chol).T
    n = Yp.shape[0]
    if weights is None:
        w = torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
    else:
        w = torch.as_tensor(weights, dtype=dtype, device=dev)
        w = w / torch.sum(w)
    mu_w = torch.sum(w[:, None] * Yp, dim=0)
    var_w = torch.sum(w[:, None] * (Yp - mu_w) ** 2, dim=0)
    sd_w = torch.sqrt(torch.clamp(var_w, min=torch.finfo(dtype).tiny))
    if jitter is None:
        n_unique = np.unique(Yp.cpu().numpy(), axis=0).shape[0]
        h = min(0.8, (4.0 / (d + 2)) ** (1.0 / (d + 4)) * n_unique ** (-1.0 / (d + 4)))
    else:
        h = float(jitter)
    h = torch.tensor(h, dtype=dtype, device=dev)
    a = torch.sqrt(torch.clamp(1.0 - h * h, min=0.0))

    cdf = torch.cumsum(w, 0)
    trace = []
    for t in range(n_steps):
        if idx is None:  # by the inverse CDF, as jax.random.choice(p=w) draws them
            u = torch.rand((n_batch,), generator=gen, dtype=dtype, device=dev)
            rows = torch.clamp(torch.searchsorted(cdf, cdf[-1] * (1.0 - u)), max=n - 1)
        else:
            rows = torch.as_tensor(idx[t], device=dev)
        e = (torch.randn((n_batch, d), generator=gen, dtype=dtype, device=dev) if eps is None
             else torch.as_tensor(eps[t], dtype=dtype, device=dev))
        yb = mu_w + a * (Yp[rows] - mu_w) + h * sd_w * e
        with torch.enable_grad(), fp32_matmul():
            Z, logdet = flow.inverse(yb)
            nll = torch.mean(0.5 * torch.sum(Z * Z, dim=-1) + logdet)
            grads = torch.autograd.grad(nll, leaves)
        frac = torch.tensor(t, dtype=dtype, device=dev) / max(n_steps, 1)
        opt = adam_update(leaves, grads, opt, lr * (1.0 - (1.0 - lr_decay) * frac))
        trace.append(-nll.detach())

    res = FlowVIResult(flow=flow, ref_mean=ref_mean, ref_chol=ref_chol,
                       elbo_trace=torch.stack(trace) if trace else Yp.new_zeros((0,)),
                       theta_mean=torch.zeros((d,), dtype=dtype, device=dev),
                       theta_cov=torch.eye(d, dtype=dtype, device=dev), n_forward=0)
    return _summarised(res, gen, n_summary, summary_Z)


def flow_fit_pipeline(
    misfit_b: Callable,
    misfit_bd: Callable,
    prior: GaussianPrior,
    gen: Optional[torch.Generator] = None,
    *,
    n_couplings: int = 6,
    hidden: int = 32,
    pretrain: str = "smc",
    pretrain_particles: int = 2048,
    pretrain_steps: int = 2000,
    n_mutations: int = 5,
    max_stages: int = 64,
    n_steps: Optional[int] = None,
    n_mc: int = 64,
    lr: float = 0.003,
    anneal_steps: Optional[int] = None,
    mesh=None,
) -> tuple[FlowVIResult, Optional[int]]:
    """The production flow fit: tempered SMC (one population of
    pretrain_particles, n_mutations pCN sweeps a stage) -> MLE distillation
    of its particles over pretrain_steps -> an optional reverse-KL
    refinement of n_steps (default 0 after pretrain="smc": a refinement
    re-collapses a covering fit; 3,000 after pretrain="none", plain annealed
    flow-VI). misfit_b: the batched misfit (SMC); misfit_bd: the batched
    differentiable misfit (the ELBO). Returns (FlowVIResult, SMC stages or
    None).

    An SMC population stopped at max_stages with lambda < 1 is a hot,
    too-wide pseudo-posterior that the MLE fit would inherit: that raises
    RuntimeError. Tight noise needs a long schedule (the lambda range grows
    like 1 / noise^2). Every draw comes from gen: SMC's, then the MLE's, then
    the refinement's. mesh: SMC runs as islands, one population per rank
    (``parallel.sharding.sharded_smc``), and the refinement's Monte Carlo
    axis is sharded (``sharded_flow_vi``); the three draw from children of
    gen taken first, so the MLE fit between them is the same on every rank."""
    if pretrain not in ("smc", "none"):
        raise ValueError(f"pretrain must be 'smc' or 'none', got {pretrain!r}")
    params, n_stages, res = None, None, None
    if n_steps is None:
        n_steps = 0 if pretrain == "smc" else 3000
    g_smc = g_mle = g_run = gen
    if mesh is not None:
        g_smc, g_mle, g_run = (child_generator(gen) for _ in range(3))
    if pretrain == "smc":
        from bayesianinferencedl_tpu_torch.infer.smc import run_smc

        if mesh is None:
            smc = run_smc(misfit_b, prior, gen, n_particles=pretrain_particles,
                          n_mutations=n_mutations, max_stages=max_stages)
        else:
            from bayesianinferencedl_tpu_torch.parallel.sharding import sharded_smc

            smc, _ = sharded_smc(mesh, misfit_b, prior, g_smc, n_particles=pretrain_particles,
                                 n_mutations=n_mutations, max_stages=max_stages)
        n_stages = int(smc.n_stages.max())
        lam_final = float(smc.lambdas[-1].min())
        if n_stages >= max_stages and lam_final < 1.0:
            raise RuntimeError(
                f"SMC pretraining hit max_stages={max_stages} at lambda={lam_final:.3e} < 1: the "
                "population is a hot (too-wide) pseudo-posterior and the MLE fit would inherit it. "
                "Raise max_stages (tight-noise posteriors need a long adaptive schedule) and/or "
                "n_mutations."
            )
        res = fit_flow_mle(smc.particles.reshape(pretrain_particles, prior.dim), prior, g_mle,
                           n_couplings=n_couplings, hidden=hidden, n_steps=pretrain_steps)
        params = res.flow
        anneal_steps = 0  # a warm-started refinement never re-anneals
    if n_steps > 0 or res is None:
        if mesh is None:
            res = run_flow_vi(misfit_bd, prior, gen, n_couplings=n_couplings, hidden=hidden,
                              n_steps=n_steps, n_mc=n_mc, lr=lr, anneal_steps=anneal_steps,
                              params=params)
        else:
            from bayesianinferencedl_tpu_torch.parallel.sharding import sharded_flow_vi

            res = sharded_flow_vi(mesh, misfit_bd, prior, g_run, n_couplings=n_couplings,
                                  hidden=hidden, n_steps=n_steps, n_mc=n_mc, lr=lr,
                                  anneal_steps=anneal_steps, params=params)
    return res, n_stages


def flow_psis_certify(
    misfit_fn: Callable,
    prior: GaussianPrior,
    res: FlowVIResult,
    gen: Optional[torch.Generator] = None,
    *,
    n_draws: int = 4096,
    base_scale: float = 1.0,
    Z: Optional[torch.Tensor] = None,
    mesh=None,
) -> PSISResult:
    """PSIS with the flow as the proposal (infer/psis.py): n_draws flow draws
    with their exact log q, one batched misfit, the k-hat gate, the weighted
    moments and the evidence. base_scale > 1 certifies through a
    base-widened proposal (flow_sample). Z (n_draws, d): the base points,
    else drawn from gen. Like any PSIS gate it cannot see a basin the
    proposal never visits. mesh: the misfit's draw axis is sharded over its
    ranks (``psis_correct_draws``)."""
    theta, log_q = flow_sample(res, gen, (n_draws,), with_logq=True, base_scale=base_scale, Z=Z)
    return psis_correct_draws(misfit_fn, prior, theta, log_q, mesh=mesh)


def neutra_misfit(res: FlowVIResult, misfit_fn: Callable, prior: GaussianPrior):
    """The exact posterior pulled back to the flow's latent coordinates.

    Returns (misfit_Z, base_prior, to_theta): any kernel run with
    (misfit_Z, base_prior) over Z targets p(Z) ~ exp(-Phi(theta(Z)) -
    prior_nlp(theta(Z)) + logdet f(Z)), so to_theta(Z) of its samples are
    exact posterior draws. base_prior is N(0, I): pCN proposals in Z are
    preconditioned by the flow, and with the identity flow everything
    reduces to the plain whitened kernel. misfit_fn is batched, on working
    coordinates; misfit_Z takes (B, d) and is differentiable when grad is
    on."""
    Li = inv_chol(prior.chol)

    def theta_of(Z):
        Y, logdet = res.flow(Z)
        with fp32_matmul():
            return res.ref_mean + Y @ res.ref_chol.T, logdet

    def to_theta(Z):
        return theta_of(Z)[0]

    def misfit_Z(Z):
        theta, logdet = theta_of(Z)
        phi = misfit_fn(theta)
        with fp32_matmul():
            w = (theta - prior.mean) @ Li.T
        return phi + 0.5 * torch.sum(w * w, dim=-1) - logdet - 0.5 * torch.sum(Z * Z, dim=-1)

    base_prior = GaussianPrior.iid(prior.dim, mean=0.0, sigma=1.0, dtype=prior.mean.dtype,
                                   device=prior.mean.device)
    return misfit_Z, base_prior, to_theta


def run_neutra_pcn(
    res: FlowVIResult,
    misfit_fn: Callable,
    prior: GaussianPrior,
    gen: Optional[torch.Generator] = None,
    *,
    n_chains: int = 256,
    n_steps: int = 2000,
    n_burn: int = 1000,
    beta: float = 0.3,
    thin: int = 1,
    Z0: Optional[torch.Tensor] = None,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> PCNResult:
    """Flow-preconditioned pCN (NeuTra with pCN as the kernel): the exact
    posterior sampled in the flow's latent space, one misfit and one flow
    push a step. The chains start from the flow's own base draws. Returns
    run_pcn's PCNResult with .samples pushed to working coordinates (the
    state, phi_trace and betas stay latent).

    Draws from gen: Z0 (n_chains, d), then run_pcn's in step order; Z0,
    normals (n_steps, n_chains, d) and uniforms (n_steps, n_chains) pass
    them in. The kept samples are pushed about 1M rows at a time, which
    bounds the couplings' activations."""
    misfit_Z, base_prior, to_theta = neutra_misfit(res, misfit_fn, prior)
    dtype, dev = res.ref_mean.dtype, res.ref_mean.device
    if Z0 is None:
        Z0 = torch.randn((n_chains, prior.dim), generator=gen, dtype=dtype, device=dev)
    Z0 = torch.as_tensor(Z0, dtype=dtype, device=dev)
    with torch.no_grad():
        out = run_pcn(misfit_Z, base_prior, Z0, gen, n_steps=n_steps, n_burn=n_burn, beta=beta,
                      thin=thin, normals=normals, uniforms=uniforms)
        kept, C, d = out.samples.shape
        chunk = max(1, min(kept, _PUSH_ROWS // max(C, 1)))
        parts = [to_theta(out.samples[i:i + chunk].reshape(-1, d)).reshape(-1, C, d)
                 for i in range(0, kept, chunk)]
    return out._replace(samples=torch.cat(parts) if parts else out.samples)
