"""Pareto-smoothed importance sampling (PSIS): certify and correct a fast
posterior approximation (Vehtari, Simpson, Gelman, Yao, Gabry 2024).

Draw K samples from a proposal q, weight them by w = p/q (unnormalised),
smooth the largest weights by a fitted generalised Pareto distribution and
estimate posterior expectations by the self-normalised weighted average.
The fitted Pareto shape k-hat is the diagnostic: below 0.5 reliable,
0.5-0.7 usable, from 0.7 on the proposal does not cover the posterior.

The K draws are one batched misfit on the device (on the fom likelihood,
one batched stencil-kernel solve); everything after it (order statistics,
the Pareto fit, the weighted moments, the evidence) is host float64 NumPy.
The Pareto fit is the Zhang & Stephens (2009) profile-posterior estimator
with the small-sample regularisation k <- (M k + 5) / (M + 10).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul


class PSISResult(NamedTuple):
    mean: np.ndarray  # (d,) importance-weighted posterior mean (working coordinates)
    cov: np.ndarray  # (d, d) importance-weighted posterior covariance
    k_hat: float  # Pareto tail shape: < 0.5 good, 0.5-0.7 ok, >= 0.7 fail
    ess: float  # importance-sampling effective sample size (Kong)
    log_weights: np.ndarray  # (K,) smoothed, max-subtracted log weights
    samples: torch.Tensor  # (K, d) the proposal draws the weights refer to
    reliable: bool  # k_hat < 0.7 and every weight finite
    # log E_mu0[exp(-Phi)] from the RAW weights (unbiased in Z; the
    # convention of infer/evidence.py and infer/smc.py), under the same gate
    log_evidence: float


def _gpd_fit(x: np.ndarray) -> tuple[float, float, float]:
    """Zhang-Stephens profile-posterior fit of the generalised Pareto to
    ascending exceedances x > 0. Returns (xi, sigma, k_hat): xi the standard
    shape (heavy tail positive), sigma > 0, and k_hat = (n xi + 5) / (n + 10)."""
    n = x.size
    if n < 5:
        return np.inf, np.nan, np.inf  # no tail can be certified from < 5 points
    m = 30 + int(np.sqrt(n))
    bs = 1.0 - np.sqrt(m / (np.arange(1, m + 1) - 0.5))
    bs = bs / (3.0 * x[n // 4]) + 1.0 / x[-1]
    # the profile log-likelihood of b, with k(b) in the ZS parameterisation
    ks = -np.mean(np.log1p(-bs[:, None] * x[None, :]), axis=1)
    ls = n * (np.log(bs / ks) + ks - 1.0)
    ws = 1.0 / np.sum(np.exp(ls[None, :] - ls[:, None]), axis=1)
    b = float(np.sum(bs * ws))
    xi = float(np.mean(np.log1p(-b * x)))  # = -k_ZS, the standard shape
    sigma = -xi / b if b != 0.0 else np.nan
    k_hat = (n * xi + 5.0) / (n + 10.0)
    return xi, sigma, k_hat


def psis_smooth(log_w: np.ndarray) -> tuple[np.ndarray, float]:
    """Fit a generalised Pareto to the M = min(0.2 K, 3 sqrt(K)) largest raw
    log weights, replace them by the fitted quantiles at (j - 0.5) / M
    (capped at the observed max) and return (smoothed max-subtracted log
    weights, k_hat). Host float64."""
    lw = np.asarray(log_w, np.float64)
    K = lw.size
    lw = lw - lw.max()
    M = int(min(np.ceil(0.2 * K), 3.0 * np.sqrt(K)))
    if M < 5:
        return lw, np.inf
    order = np.argsort(lw)
    tail_idx = order[-M:]
    cut = lw[order[-M - 1]]  # the weight just below the tail
    x = np.exp(lw[tail_idx]) - np.exp(cut)  # exceedances, ascending
    # (near-)constant weights leave only rounding above the cut: no tail to
    # fit, the ideal case; report a maximally light tail and smooth nothing
    if x[-1] <= 0 or x[x.size // 4] <= 0 or x[-1] < 1e-10 * np.exp(cut):
        return lw, -np.inf
    xi, sigma, k_hat = _gpd_fit(x)
    if np.isfinite(k_hat) and np.isfinite(sigma) and sigma > 0:
        n = x.size
        q = (np.arange(1, n + 1) - 0.5) / n
        if abs(xi) < 1e-12:
            quant = -sigma * np.log1p(-q)
        else:
            quant = sigma / xi * (np.power(1.0 - q, -xi) - 1.0)
        smoothed = np.log(np.maximum(quant + np.exp(cut), 1e-300))
        smoothed = np.minimum(smoothed, 0.0)  # capped at the observed max (0)
        out = lw.copy()
        out[tail_idx] = smoothed  # tail_idx ascends in lw, as q does
        out -= out.max()
        return out, k_hat
    return lw, k_hat


def psis_correct_draws(
    misfit_fn: Callable,
    prior: GaussianPrior,
    theta: torch.Tensor,
    log_q: torch.Tensor,
    *,
    mesh=None,
) -> PSISResult:
    """PSIS from explicit proposal draws theta (K, d) over working
    coordinates, with their log density log_q (K,): the (2 pi)^(d/2)
    constant dropped, every determinant included (a Gaussian N(m, L L^T)
    gives -0.5 |z|^2 - log|det L|). misfit_fn is batched: one call on the
    whole (K, d) batch.

    Non-finite weights (a forward that fails at an extreme draw) are zeroed
    and void the certificate: a proposal with mass where the model cannot
    be evaluated does not cover the posterior. mesh: the misfit's draw axis
    is sharded over its ranks (K divisible by the world size) and gathered
    back; the smoothing runs on every rank alike."""
    from bayesianinferencedl_tpu_torch.parallel.sharding import sharded_rows_fn

    with torch.no_grad():
        phi = sharded_rows_fn(mesh, misfit_fn)(theta)
    th = theta.detach().double().cpu().numpy()
    phi64 = phi.double().cpu().numpy()
    pm = prior.mean.double().cpu().numpy()
    pc = prior.chol.double().cpu().numpy()
    w_prior = np.linalg.solve(pc, (th - pm).T).T
    log_p = -phi64 - 0.5 * np.sum(w_prior * w_prior, axis=1)
    log_w_raw = log_p - log_q.detach().double().cpu().numpy()

    bad = ~np.isfinite(log_w_raw)
    n_bad = int(bad.sum())
    if n_bad == log_w_raw.size:
        d = th.shape[1]
        return PSISResult(
            mean=np.full(d, np.nan), cov=np.full((d, d), np.nan), k_hat=np.inf, ess=0.0,
            log_weights=log_w_raw, samples=theta, reliable=False, log_evidence=-np.inf,
        )
    log_w_raw = np.where(bad, -np.inf, log_w_raw)

    # the evidence from the raw weights: the target is exp(-Phi) times the
    # unnormalised prior density; dividing by |det prior.chol| (the
    # (2 pi)^(d/2) cancels q's) gives Z = E_mu0[exp(-Phi)]
    log_det_p = float(np.sum(np.log(np.abs(np.diag(pc)))))
    mx = log_w_raw.max()
    log_evidence = float(mx + np.log(np.mean(np.exp(log_w_raw - mx))) - log_det_p)

    log_w, k_hat = psis_smooth(log_w_raw)
    w = np.exp(log_w - log_w.max())
    w /= w.sum()
    mean = w @ th
    c = th - mean
    cov = (c * w[:, None]).T @ c / max(1.0 - float(w @ w), 1e-12)
    ess = float(1.0 / np.sum(w * w))
    return PSISResult(
        mean=mean, cov=cov, k_hat=float(k_hat), ess=ess, log_weights=log_w, samples=theta,
        reliable=bool(k_hat < 0.7) and n_bad == 0, log_evidence=log_evidence,
    )


def psis_correct(
    misfit_fn: Callable,
    prior: GaussianPrior,
    q_mean: torch.Tensor,
    q_chol: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_draws: int = 4096,
    eps: Optional[torch.Tensor] = None,
    mesh=None,
) -> PSISResult:
    """Importance-correct a Gaussian approximation q = N(q_mean, q_chol
    q_chol^T) over working coordinates toward p ~ exp(-misfit - prior): one
    batched misfit over n_draws draws, then the host tail smoothing. Any
    (mean, chol) pair works: a VIResult's (theta_mean, theta_chol), a
    Laplace fit, a moment-matched ensemble. eps (n_draws, d): the draws'
    standard normals, else drawn from gen. mesh: the misfit sweep's draw
    axis is sharded over its ranks (n_draws divisible by the world size)
    and gathered back, as in ``psis_correct_draws``."""
    dtype, dev = prior.mean.dtype, prior.mean.device
    d = prior.dim
    q_mean = torch.as_tensor(q_mean, dtype=dtype, device=dev)
    q_chol = torch.as_tensor(q_chol, dtype=dtype, device=dev)
    if eps is None:
        eps = torch.randn((n_draws, d), generator=gen, dtype=dtype, device=dev)
    eps = torch.as_tensor(eps, dtype=dtype, device=dev)
    with fp32_matmul():
        theta = q_mean + eps @ q_chol.T
    # eps are exactly the draws' whitened coordinates under q
    log_det_q = torch.sum(torch.log(torch.abs(torch.diagonal(q_chol))))
    log_q = -0.5 * torch.sum(eps * eps, dim=1) - log_det_q
    return psis_correct_draws(misfit_fn, prior, theta, log_q, mesh=mesh)
