"""MAP estimation and the Laplace approximation.

The MAP minimises the negative log posterior with the in-repo BFGS
(``infer.optimize``), from a batch of starts at once, on gradients that
autograd takes through the differentiable forward
(``Pipeline.batched_forward_fn(..., differentiable=True)``: adjoint solves,
never a backward through solver iterations). The Laplace approximation is
N(theta_map, H^-1) with the Gauss-Newton H = J^T J / sigma^2 + C^-1 or the
full Hessian; J = dG/dtheta (m x d) comes from reverse-mode rows, the
reference's ``jacfwd`` by the other mode, equal to rounding. The d x d
inverse and Cholesky factor run in host float64 numpy, as in the reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.infer.optimize import minimize_bfgs
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul


class LaplaceApproximation(NamedTuple):
    """Gaussian posterior approximation N(mean, cov)."""

    mean: torch.Tensor  # (d,)
    cov: torch.Tensor  # (d, d)
    chol: torch.Tensor  # (d, d) lower Cholesky factor of cov

    def sample(self, gen: Optional[torch.Generator] = None, shape: tuple = (), *,
               normals: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + z chol^T for z ~ N(0, I) of shape (*shape, d), drawn from
        gen, or the given standard normals."""
        if normals is None:
            normals = torch.randn((*shape, self.mean.shape[0]), generator=gen,
                                  dtype=self.mean.dtype, device=self.mean.device)
        with fp32_matmul():
            return self.mean + normals @ self.chol.T

    def log_density(self, theta: torch.Tensor) -> torch.Tensor:
        """log N(theta; mean, cov) up to the -d/2 log(2 pi) constant, over
        the last axis."""
        v = (theta - self.mean)[..., None]
        w = torch.linalg.solve_triangular(self.chol, v, upper=False)[..., 0]
        return -0.5 * torch.sum(w * w, -1) - torch.sum(torch.log(torch.diagonal(self.chol)))


def negative_log_posterior(misfit_fn: Callable, prior: GaussianPrior) -> Callable:
    """theta (B, d) -> misfit + 0.5 ||L^-1 (theta - m)||^2, (B,); the misfit
    is batched."""

    def nlp(theta):
        w = prior.whiten(theta)
        return misfit_fn(theta) + 0.5 * torch.sum(w * w, -1)

    return nlp


def find_map(misfit_fn: Callable, prior: GaussianPrior, theta0: torch.Tensor, *,
             maxiter: int = 200) -> tuple[torch.Tensor, torch.Tensor]:
    """Minimise misfit + prior with the in-repo BFGS from theta0 (d,), or
    from a batch of starts (S, d), each on its own. Returns (theta_map,
    nlp), with the start axis where theta0 has one."""
    res = minimize_bfgs(negative_log_posterior(misfit_fn, prior), theta0, maxiter=maxiter, gtol=1e-8)
    return res.x, res.fun


def find_map_multistart(
    misfit_fn: Callable,
    prior: GaussianPrior,
    gen: Optional[torch.Generator] = None,
    *,
    n_starts: int = 8,
    maxiter: int = 200,
    starts: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The MAP search from n_starts prior draws (or the given starts
    (S, d)), all minimised as one batch; returns the best (theta, nlp) over
    the starts whose objective is finite."""
    theta0s = prior.sample(gen, (n_starts,)) if starts is None else starts
    xs, fs = find_map(misfit_fn, prior, theta0s, maxiter=maxiter)
    best = int(torch.argmin(torch.where(torch.isfinite(fs), fs, torch.inf)))
    return xs[best], fs[best]


def _jacobian(forward: Callable, theta: torch.Tensor, m: int) -> torch.Tensor:
    """J = dG/dtheta (m, d) at theta (d,) by reverse mode: the forward runs
    on m copies of theta, and one backward of sum_i G_i(copy i) gives row i
    in copy i's gradient."""
    with torch.enable_grad(), fp32_matmul():
        th = theta.detach().expand(m, theta.shape[0]).clone().requires_grad_()
        y = forward(th)
        (J,) = torch.autograd.grad(torch.sum(torch.diagonal(y)), th)
    return J


def _hessian(fn: Callable, theta: torch.Tensor) -> torch.Tensor:
    """The Hessian (d, d) of a batched scalar fn at theta (d,) by reverse
    over reverse: fn on d copies, the gradient with its graph, then one
    backward of the gradient's diagonal gives row i in copy i."""
    d = theta.shape[0]
    with torch.enable_grad(), fp32_matmul():
        th = theta.detach().expand(d, d).clone().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum(fn(th)), th, create_graph=True)
        (H,) = torch.autograd.grad(torch.sum(torch.diagonal(g)), th)
    return H


def laplace_approximation(
    forward: Callable,
    data: torch.Tensor,
    noise_sigma: float,
    prior: GaussianPrior,
    theta_map: torch.Tensor,
    *,
    use_gauss_newton: bool = True,
) -> LaplaceApproximation:
    """N(theta_map, H^-1). forward: the batched differentiable forward,
    (B, d) -> (B, m). use_gauss_newton=True: H = J^T J / sigma^2 + C^-1
    with J = dG/dtheta at the MAP; otherwise the full Hessian of the
    negative log posterior, which differentiates the forward twice."""
    d = theta_map.shape[0]
    eye = torch.eye(d, dtype=theta_map.dtype, device=theta_map.device)
    Cinv = torch.cholesky_solve(eye, prior.chol, upper=False)
    if use_gauss_newton:
        J = _jacobian(forward, theta_map, data.shape[-1])
        with fp32_matmul():
            H = J.T @ J / noise_sigma**2 + Cinv
    else:
        def nlp(t):
            r = forward(t) - data
            w = prior.whiten(t)
            return 0.5 * torch.sum(r * r, -1) / noise_sigma**2 + 0.5 * torch.sum(w * w, -1)

        H = _hessian(nlp, theta_map)
    H = 0.5 * (H + H.T)
    # offline d x d algebra in host float64 (the conditioning of H squares
    # the misfit scaling), cast back to the working dtype
    H64 = H.detach().cpu().numpy().astype(np.float64)
    cov64 = np.linalg.inv(H64)
    cov64 = 0.5 * (cov64 + cov64.T)
    chol64 = np.linalg.cholesky(cov64)
    t = lambda a: torch.as_tensor(a, dtype=theta_map.dtype, device=theta_map.device)
    return LaplaceApproximation(mean=theta_map.detach(), cov=t(cov64), chol=t(chol64))
