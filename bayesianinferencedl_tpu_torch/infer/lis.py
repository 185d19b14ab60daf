"""Likelihood-informed subspace (LIS) pCN: operator-weighted proposals for
high-dimensional inversion (the full-field coefficient space).

With m = n_obs observations the Gauss-Newton Hessian of the misfit has rank
<= m however large d is: the data inform an (at most) m-dimensional
subspace, and the posterior is the prior on its complement up to nonlinear
leakage. pCN with one scalar step size must step small enough for the
stiffest informed direction, so the complement crawls.

- Offline (``build_lis``): average the whitened Gauss-Newton Hessian
  H = mean_i J(z_i)^T J(z_i) / sigma^2 over a few linearisation points
  (the MAP and Laplace draws), eigendecompose it on the host in float64 and
  keep the eigenpairs with lam >= lam_tol. The Jacobians are reverse mode,
  one vector-Jacobian product per observation (the rows ``jacrev`` gives),
  all points in one batch: the differentiable forwards are
  ``torch.autograd.Function`` adjoint solves, which ``torch.func``
  transforms do not take.
- Online (``run_lis_pcn``): pCN with direction-dependent steps
  beta_i = beta0 / sqrt(1 + lam_i) (lam = 0 on the complement). The
  proposal y' = B y + G xi with B = V diag(c_r) V^T + c0 (I - V V^T) and
  B^2 + G^2 = I commutes with the whitened prior covariance I, so it is
  prior-reversible and the acceptance is the plain pCN misfit difference:
  exact for any posterior and any subspace estimate. Burn-in adapts the
  per-chain log beta0 toward 23.4% acceptance, then freezes it.

Each step takes optional pre-drawn normals and uniforms, like every sampler
of the port.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.infer.pcn import TARGET_ACCEPT, PCNResult, PCNState
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.infer.samplers import inv_chol
from bayesianinferencedl_tpu_torch.infer.segmented import accept_rate_spec, drive_segments
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul


class LIS(NamedTuple):
    """The likelihood-informed subspace in whitened prior coordinates.

    V:   (d, r) orthonormal eigenvectors of the averaged whitened GN Hessian
    lam: (r,)   their eigenvalues (the Laplace posterior variance along
         V[:, i] is 1 / (1 + lam[i]))"""

    V: torch.Tensor
    lam: torch.Tensor

    @property
    def rank(self) -> int:
        return self.V.shape[1]


def build_lis(forward_fn: Callable, prior: GaussianPrior, z_points: torch.Tensor,
              noise_sigma: float, *, lam_tol: float = 0.1, rank_max: Optional[int] = None) -> LIS:
    """The global LIS from linearisation points z_points (P, d) in working
    coordinates. forward_fn: the batched differentiable forward (B, d) ->
    (B, m). Keeps the eigenpairs with lam >= lam_tol, at least one and at
    most rank_max."""
    P, d = z_points.shape
    Li = inv_chol(prior.chol)
    with fp32_matmul():
        y_points = (z_points - prior.mean) @ Li.T
    with torch.enable_grad():
        m = forward_fn(prior.mean[None]).shape[-1]
        # m copies of every point: one backward of sum_i y_i(copy i) gives
        # row i of each point's Jacobian in copy i's gradient
        yy = y_points.detach()[:, None, :].expand(P, m, d).reshape(P * m, d).clone().requires_grad_()
        with fp32_matmul():
            out = forward_fn(prior.mean + yy @ prior.chol.T).reshape(P, m, m)
        (J,) = torch.autograd.grad(torch.sum(torch.diagonal(out, dim1=1, dim2=2)), yy)
    J = J.reshape(P, m, d).detach().cpu().numpy().astype(np.float64)
    H = np.mean(np.einsum("pmi,pmj->pij", J, J), axis=0) / float(noise_sigma) ** 2
    lam, V = np.linalg.eigh((H + H.T) / 2.0)
    lam, V = lam[::-1], V[:, ::-1]  # descending
    r = max(1, int(np.sum(lam >= lam_tol)))
    if rank_max is not None:
        r = min(r, int(rank_max))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=z_points.dtype, device=z_points.device)
    return LIS(V=t(V[:, :r]), lam=t(np.maximum(lam[:r], 0.0)))


def _dir_steps(lis: LIS, beta0: torch.Tensor):
    """Per-direction (b, c) from the per-chain scalar beta0 (C,): the
    complement's (C, 1) and the informed directions' (C, r); b^2 + c^2 = 1
    in every direction."""
    b0 = beta0[..., None]
    c0 = torch.sqrt(1.0 - b0 * b0)
    br = b0 / torch.sqrt(1.0 + lis.lam)[None, :]
    cr = torch.sqrt(1.0 - br * br)
    return b0, c0, br, cr


def lis_pcn_step(misfit_fn: Callable, lis: LIS, to_theta: Callable, beta0: torch.Tensor,
                 state: PCNState, gen: Optional[torch.Generator] = None, *,
                 normals: Optional[torch.Tensor] = None,
                 uniforms: Optional[torch.Tensor] = None) -> tuple[PCNState, torch.Tensor]:
    """One operator-weighted pCN step in whitened coordinates: state.theta
    holds whitened y, misfit_fn takes working coordinates through to_theta
    and is batched. beta0: per-chain (C,). normals (C, d) / uniforms (C,):
    the step's draws, else drawn from gen. Returns (state, accept mask)."""
    y = state.theta
    dtype, dev = y.dtype, y.device
    xi = normals if normals is not None else torch.randn(y.shape, generator=gen, dtype=dtype,
                                                         device=dev)
    u = uniforms if uniforms is not None else torch.rand(state.phi.shape, generator=gen,
                                                         dtype=dtype, device=dev)
    b0, c0, br, cr = _dir_steps(lis, torch.as_tensor(beta0, dtype=dtype, device=dev))
    with fp32_matmul():
        a = y @ lis.V  # (C, r) informed components
        xa = xi @ lis.V
        prop = c0 * y + b0 * xi + ((cr - c0) * a + (br - b0) * xa) @ lis.V.T
    phi_prop = misfit_fn(to_theta(prop))
    accept = torch.log(u) < (state.phi - phi_prop)
    new = PCNState(
        theta=torch.where(accept[..., None], prop, y),
        phi=torch.where(accept, phi_prop, state.phi),
        n_accept=state.n_accept + accept.to(torch.int32),
    )
    return new, accept


def run_lis_pcn(misfit_fn: Callable, prior: GaussianPrior, lis: LIS, theta0: torch.Tensor,
                gen: Optional[torch.Generator] = None, *, n_steps: int, n_burn: int = 0,
                beta=0.5, thin: int = 1, adapt: bool = True, adapt_t0: float = 0.0,
                normals: Optional[torch.Tensor] = None,
                uniforms: Optional[torch.Tensor] = None) -> PCNResult:
    """LIS-pCN chains from theta0 (C, d) in working coordinates, with
    ``run_pcn``'s contract: per-chain beta0 adapted toward 23.4% in burn-in
    (unless ``adapt`` is False), then frozen; every ``thin``-th state kept,
    in working coordinates. beta is the complement's step beta0 (informed
    directions move at beta0 / sqrt(1 + lam_i)), so it can sit far above a
    plain pCN beta. normals (n_steps, C, d) / uniforms (n_steps, C):
    optional pre-drawn draws, burn-in first."""
    dtype, dev = theta0.dtype, theta0.device
    Li = inv_chol(prior.chol)

    def to_theta(Y):
        with fp32_matmul():
            return prior.mean + Y @ prior.chol.T

    with fp32_matmul():
        y0 = (theta0 - prior.mean) @ Li.T
    phi0 = misfit_fn(to_theta(y0))
    state = PCNState(theta=y0, phi=phi0, n_accept=torch.zeros_like(phi0, dtype=torch.int32))
    draws = lambda t: dict(normals=None if normals is None else normals[t],
                           uniforms=None if uniforms is None else uniforms[t])
    log_beta = torch.log(torch.as_tensor(beta, dtype=dtype, device=dev).expand(phi0.shape))
    lo, hi = math.log(1e-4), math.log(0.9999)
    for t in range(n_burn):
        state, acc = lis_pcn_step(misfit_fn, lis, to_theta, torch.exp(log_beta), state, gen,
                                  **draws(t))
        if adapt:
            eta = 0.5 / (1.0 + t + adapt_t0) ** 0.6
            log_beta = torch.clamp(log_beta + eta * (acc.to(dtype) - TARGET_ACCEPT), lo, hi)
    if n_burn > 0:
        state = state._replace(n_accept=torch.zeros_like(state.n_accept))

    beta_final = torch.exp(log_beta)
    n_out = (n_steps - n_burn) // thin
    samples, phis = [], []
    t = n_burn
    for _ in range(n_out):
        for _ in range(thin):
            state, _ = lis_pcn_step(misfit_fn, lis, to_theta, beta_final, state, gen, **draws(t))
            t += 1
        samples.append(to_theta(state.theta))
        phis.append(state.phi)
    C, d = theta0.shape
    # the state back in working coordinates, so segments and resumes compose
    return PCNResult(
        state=state._replace(theta=to_theta(state.theta)),
        samples=torch.stack(samples) if samples else theta0.new_zeros((0, C, d)),
        phi_trace=torch.stack(phis) if phis else theta0.new_zeros((0, C)),
        accept_rate=state.n_accept.to(torch.float32) / max(n_out * thin, 1),
        beta=beta_final,
    )


def run_lis_pcn_segmented(misfit_fn: Callable, prior: GaussianPrior, lis: LIS,
                          theta0: torch.Tensor, gen: Optional[torch.Generator] = None, *,
                          n_steps: int, n_burn: int = 0, beta=0.5, segment: int = 64,
                          normals: Optional[torch.Tensor] = None,
                          uniforms: Optional[torch.Tensor] = None) -> PCNResult:
    """LIS-pCN in segments of at most ``segment`` steps (``infer.segmented``),
    for likelihoods with a full-order solve in every step: chain states and
    adapted beta0 carry across segments and the adaptation clock runs on.
    Draws as for ``run_lis_pcn``, for the whole run."""
    betas0 = torch.as_tensor(beta, dtype=theta0.dtype, device=theta0.device).expand(
        theta0.shape[:-1])
    part = lambda a, start, this: None if a is None else a[start:start + this]

    def seg(carry, this, burn, start):
        thetas, betas = carry
        res = run_lis_pcn(misfit_fn, prior, lis, thetas, gen, n_steps=this, n_burn=burn,
                          beta=betas, adapt_t0=float(start), normals=part(normals, start, this),
                          uniforms=part(uniforms, start, this))
        return res, (res.state.theta, res.beta)

    res, (_, betas), samples, phis, rates, _ = drive_segments(
        seg, (theta0, betas0), n_steps=n_steps, n_burn=n_burn, segment=segment,
        rates={"accept": accept_rate_spec()},
    )
    return PCNResult(state=res.state, samples=samples, phi_trace=phis,
                     accept_rate=rates["accept"], beta=betas)
