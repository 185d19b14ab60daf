"""Laplace-informed MCMC samplers.

Two samplers use the Laplace approximation N(m_L, C_L) at the MAP:

* :func:`run_laplace_mh`, independence Metropolis-Hastings with the Laplace
  approximation as the proposal: near-iid chains on a near-Gaussian
  posterior.
* :func:`run_gpcn`, generalised pCN: the pCN autoregressive proposal with
  the Laplace approximation (not the prior) as the Gaussian reference
  measure; the acceptance ratio gains the prior/reference density
  correction.

Both take the batched, non-differentiable misfit (one batched forward a
step; on the fom likelihood, one stencil-kernel solve) and optional
pre-drawn standard normals and uniforms for every step, so a test can
replay another implementation's stream; without them the draws come from
a ``torch.Generator`` in step order, the normals before the uniforms.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from bayesianinferencedl_tpu_torch.infer.map import LaplaceApproximation
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul


class MHResult(NamedTuple):
    samples: torch.Tensor  # (n_kept, C, d)
    log_post: torch.Tensor  # (n_kept, C) unnormalised log posterior
    accept_rate: torch.Tensor  # (C,) over all n_steps, burn-in included


def inv_chol(chol: torch.Tensor) -> torch.Tensor:
    """L^-1, once, so that whitening in a step is a matmul."""
    eye = torch.eye(chol.shape[0], dtype=chol.dtype, device=chol.device)
    return torch.linalg.solve_triangular(chol, eye, upper=False)


def _log_gaussian(mean: torch.Tensor, chol: torch.Tensor) -> Callable:
    """theta (C, d) -> log N(theta; mean, chol chol^T) up to a constant."""
    Li = inv_chol(chol)

    def ld(theta):
        with fp32_matmul():
            w = (theta - mean) @ Li.T
        return -0.5 * torch.sum(w * w, -1)

    return ld


def _log_posterior(misfit_fn: Callable, prior: GaussianPrior) -> Callable:
    lq = _log_gaussian(prior.mean, prior.chol)
    return lambda theta: lq(theta) - misfit_fn(theta)


def draws(gen, shape, dtype, device, normals, uniforms):
    """A step's standard normals of ``shape`` and uniforms of shape[:-1]:
    the given ones, or drawn from gen in that order."""
    if normals is None:
        normals = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    if uniforms is None:
        uniforms = torch.rand(shape[:-1], generator=gen, dtype=dtype, device=device)
    return normals, uniforms


def _run(step, lp0, w0, theta0, gen, n_steps, n_burn, normals, uniforms) -> MHResult:
    """The shared step loop of both samplers: step(theta, normals) ->
    (prop, lp_prop, w_prop); accept where log u < w_prop - w."""
    theta, lp, w = theta0, lp0, w0
    n_acc = torch.zeros_like(lp0, dtype=torch.int32)
    pick = lambda a, t: None if a is None else a[t]
    samples, lps = [], []
    for t in range(n_steps):
        z, u = draws(gen, theta.shape, theta.dtype, theta.device, pick(normals, t), pick(uniforms, t))
        prop, lp_prop, w_prop = step(theta, z)
        accept = torch.log(u) < (w_prop - w)
        theta = torch.where(accept[..., None], prop, theta)
        lp = torch.where(accept, lp_prop, lp)
        w = torch.where(accept, w_prop, w)
        n_acc = n_acc + accept.to(torch.int32)
        if t >= n_burn:
            samples.append(theta)
            lps.append(lp)
    C, d = theta0.shape
    return MHResult(
        samples=torch.stack(samples) if samples else theta0.new_zeros((0, C, d)),
        log_post=torch.stack(lps) if lps else theta0.new_zeros((0, C)),
        accept_rate=n_acc.to(torch.float32) / max(n_steps, 1),
    )


def run_laplace_mh(
    misfit_fn: Callable,
    prior: GaussianPrior,
    laplace: LaplaceApproximation,
    theta0: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int,
    n_burn: int = 0,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> MHResult:
    """Independence MH with the proposal q = N(m_L, C_L):
    log alpha = [lp(theta') - log q(theta')] - [lp(theta) - log q(theta)].
    theta0 (C, d); normals (n_steps, C, d) / uniforms (n_steps, C): the
    proposal's standard normals and the acceptance uniforms, burn-in
    first."""
    lp_fn = _log_posterior(misfit_fn, prior)
    lq_fn = _log_gaussian(laplace.mean, laplace.chol)

    def lp_and_weight(theta):  # one misfit evaluation yields both
        lp = lp_fn(theta)
        return lp, lp - lq_fn(theta)

    def step(theta, z):
        prop = laplace.sample(normals=z)
        return (prop, *lp_and_weight(prop))

    return _run(step, *lp_and_weight(theta0), theta0, gen, n_steps, n_burn, normals, uniforms)


def run_gpcn(
    misfit_fn: Callable,
    prior: GaussianPrior,
    laplace: LaplaceApproximation,
    theta0: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_steps: int,
    n_burn: int = 0,
    beta: float = 0.5,
    normals: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> MHResult:
    """Generalised pCN with respect to the Laplace reference:
    theta' = m_L + sqrt(1 - b^2)(theta - m_L) + b L_L xi, accepted with
    log alpha = J(theta') - J(theta), J = -Phi + log p_prior - log N(.; m_L,
    C_L) (the reference density cancels the proposal's asymmetry, so the
    chain is reversible with respect to the posterior). Draws as for
    ``run_laplace_mh``."""
    lp_fn = _log_posterior(misfit_fn, prior)
    lref_fn = _log_gaussian(laplace.mean, laplace.chol)

    def lp_and_J(theta):  # one misfit evaluation yields both
        lp = lp_fn(theta)
        return lp, lp - lref_fn(theta)

    m = laplace.mean
    b = torch.as_tensor(beta, dtype=theta0.dtype, device=theta0.device)
    shrink = torch.sqrt(1.0 - b**2)

    def step(theta, z):
        with fp32_matmul():
            xi = z @ laplace.chol.T
        prop = m + shrink * (theta - m) + b * xi
        return (prop, *lp_and_J(prop))

    return _run(step, *lp_and_J(theta0), theta0, gen, n_steps, n_burn, normals, uniforms)

