"""Stein variational gradient descent (SVGD; Liu and Wang 2016, annealing
after D'Angelo and Fortuin 2021): particle-transport posterior
approximation.

J interacting particles follow the kernelised Wasserstein gradient of
KL(q||p), so the terminal ensemble can be skewed or (annealed) multi-basin
without a density family. One step is
  1. one forward and one reverse pass over all J particles through the
     differentiable misfit (the rows of the gradient are the particles'
     scores, since they are independent through the forward);
  2. the RBF kernel K = exp(-|Y_i - Y_j|^2 / h) from one Gram product, the
     bandwidth h re-derived every step by the median heuristic;
  3. the Stein direction (K g + (2/h)(Y rowsum(K) - K Y)) / J,
and Adam moves the particles along it, with ADVI's linearly decaying step
size. Annealing (anneal_steps > 0) ramps the likelihood weight linearly
from 0 to 1 over the first anneal_steps steps while the whitened prior term
stays on, the standard fix for SVGD's collapse onto one basin.

SVGD is biased at finite J (the repulsion under-fills tails as d/J grows),
and it fits no density, so a PSIS certificate applies to its moment-matched
Gaussian only. There is no per-step randomness: the initial ensemble
(``theta0``, else prior-frame normals from the generator) fixes the run.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.infer.samplers import inv_chol
from bayesianinferencedl_tpu_torch.infer.vi import LR_DECAY
from bayesianinferencedl_tpu_torch.models.surrogate import adam_init, adam_update
from bayesianinferencedl_tpu_torch.parallel.mesh import gather_rows, mean_all, rank_of, size_of
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul


class SVGDResult(NamedTuple):
    particles: torch.Tensor  # (J, d) terminal ensemble, working coordinates
    mean: torch.Tensor  # (d,) ensemble mean
    std: torch.Tensor  # (d,) ensemble marginal std (biased low at small J / large d)
    misfit_trace: torch.Tensor  # (n_steps,) ensemble-mean data misfit
    n_forward: int  # differentiable forward evaluations, J x n_steps


def _median(x: torch.Tensor) -> torch.Tensor:
    """The median of all entries, the mean of the two middle order
    statistics for an even count (``jnp.median``'s midpoint rule;
    ``torch.median`` returns the lower one). One selection finds the lower
    middle value; the upper one is that value again if enough entries tie
    with it, else the least entry above it."""
    flat = x.reshape(-1)
    n = flat.numel()
    lo = torch.kthvalue(flat, (n - 1) // 2 + 1).values
    if n % 2:
        return lo
    gt = flat > lo
    above = torch.where(gt, flat, math.inf).amin()
    hi = torch.where(n - torch.sum(gt) >= n // 2 + 1, lo, above)
    return (lo + hi) * 0.5


def _stein_direction(Y: torch.Tensor, g: torch.Tensor, J_total: int) -> torch.Tensor:
    """The kernelised Stein direction for particles Y (J, d) with scores g
    (J, d) = d/dY log p(Y). RBF kernel with the per-step median bandwidth
    h = median(|dY|^2) / log(J + 1); the J zeros on the diagonal stay in
    the median, as in the reference."""
    with fp32_matmul():
        sq = torch.sum(Y * Y, dim=-1)
        D = sq[:, None] + sq[None, :] - 2.0 * (Y @ Y.T)
        D = D.clamp_(min=0.0)
        h = torch.clamp(_median(D) / math.log(J_total + 1.0), min=1e-8)
        K = D.div_(-h).exp_()
        drift = K @ g
        repulse = (2.0 / h) * (Y * torch.sum(K, dim=1)[:, None] - K @ Y)
    return (drift + repulse) / J_total


def run_svgd(
    misfit_fn: Callable,
    prior: GaussianPrior,
    gen: Optional[torch.Generator] = None,
    *,
    n_particles: int = 512,
    n_steps: int = 800,
    lr: float = 0.05,
    lr_decay: float = LR_DECAY,
    anneal_steps: Optional[int] = None,
    theta0: Optional[torch.Tensor] = None,
    ref=None,
    segment: Optional[int] = None,
    group=None,
) -> SVGDResult:
    """Transport J = n_particles draws to the posterior by SVGD. misfit_fn
    is batched and differentiable, on working coordinates.

    anneal_steps: the likelihood ramp's length (default n_steps // 2; 0
    disables it). theta0: the initial ensemble (J, d) in working
    coordinates, which overrides n_particles; else J standard normals from
    gen in the whitened frame. The step size decays linearly from lr to
    lr * lr_decay. ref=(mean, chol): the whitened frame the particles move
    in (default the prior's), as in ADVI and the samplers; the target stays
    the posterior (the JAX package scores 0.5 |Y|^2 in the ref frame, which
    is the prior term only when ref is the prior's frame). One eager loop
    runs every step: ``segment``, the reference's scan chunk size, is
    accepted and changes nothing. group: the mesh the particle axis is
    sharded over (``parallel.sharding.sharded_svgd``): theta0 holds this
    rank's rows; each step gathers the ensemble and its scores in rank
    order (one all-gather), forms the full-ensemble Stein direction and keeps the rank's
    rows, and the misfit trace is the mean over the ranks. The result's
    particles are the rank's."""
    dtype, dev = prior.mean.dtype, prior.mean.device
    d = prior.dim
    ref_mean, ref_chol = ref if ref is not None else (prior.mean, prior.chol)
    Li = None if ref is None else inv_chol(prior.chol)
    if anneal_steps is None:
        anneal_steps = n_steps // 2
    if theta0 is None:
        Y = torch.randn((n_particles, d), generator=gen, dtype=dtype, device=dev)
    else:
        with fp32_matmul():
            Y = (torch.as_tensor(theta0, dtype=dtype, device=dev) - ref_mean) @ inv_chol(ref_chol).T
    J_local = int(Y.shape[0])
    # a given theta0 sets J, and n_forward counts what ran
    J = J_local * (1 if group is None else size_of(group))
    opt = adam_init([Y])

    trace = []
    for t in range(n_steps):
        frac = torch.tensor(t, dtype=dtype, device=dev)
        beta = (torch.clamp((frac + 1.0) / max(anneal_steps, 1), max=1.0) if anneal_steps > 0
                else torch.ones((), dtype=dtype, device=dev))
        with torch.enable_grad(), fp32_matmul():
            Yg = Y.detach().requires_grad_()
            theta = ref_mean + Yg @ ref_chol.T
            phi = misfit_fn(theta)
            w = Yg if Li is None else (theta - prior.mean) @ Li.T
            nlp = beta * phi + 0.5 * torch.sum(w * w, dim=-1)
            (grad,) = torch.autograd.grad(torch.sum(nlp), Yg)
        if group is None:
            direction = _stein_direction(Y, -grad, J)
        else:
            Yg_all = gather_rows(group, torch.cat([Y, -grad], 1))  # one gather of both
            direction = _stein_direction(Yg_all[:, :d], Yg_all[:, d:], J)
            direction = direction[rank_of(group) * J_local:(rank_of(group) + 1) * J_local]
        lr_t = lr * (1.0 - (1.0 - lr_decay) * frac / max(n_steps, 1))
        # Adam minimises: the negative Stein direction is the gradient
        opt = adam_update([Y], [-direction], opt, lr_t)
        phi_mean = torch.mean(phi.detach())
        trace.append(phi_mean if group is None else mean_all(group, phi_mean))

    with fp32_matmul():
        particles = ref_mean + Y @ ref_chol.T
    return SVGDResult(
        particles=particles, mean=torch.mean(particles, dim=0),
        std=torch.std(particles, dim=0, correction=0),
        misfit_trace=torch.stack(trace) if trace else prior.mean.new_zeros((0,)),
        n_forward=J * n_steps,
    )
