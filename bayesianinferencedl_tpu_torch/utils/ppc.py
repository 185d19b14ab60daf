"""Posterior predictive checks: does the fitted model explain the data?
p = P[T(y_rep, theta) >= T(y_obs, theta)], averaged over posterior draws,
with T the chi-square discrepancy ||y - G(theta)||^2 / sigma^2 for a known
noise, and a scale-free residual-shape statistic for an unknown one, whose
marginal posterior ``noise_posterior`` recovers."""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def thin_samples(samples: torch.Tensor, n_draws: int) -> torch.Tensor:
    """(T, C, d) kept chains -> (n_draws, d) evenly thinned flat subsample."""
    T, C, d = samples.shape
    flat = samples.reshape(T * C, d)
    idx = torch.linspace(0, T * C - 1, min(n_draws, T * C), dtype=torch.float64).to(torch.int64)
    return flat[idx.to(flat.device)]


def posterior_predictive(
    forward_b: Callable,
    samples: torch.Tensor,
    noise_sigma: float,
    gen: Optional[torch.Generator] = None,
    *,
    n_draws: int = 1024,
    noise: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Replicated observations from the posterior: (y_model, y_rep), with
    y_model = G(theta_i) (n_draws, m) over the evenly thinned samples and
    y_rep = y_model + noise_sigma * noise. forward_b: batched forward (n, d)
    -> (n, m) in the coordinates of ``samples``. noise: the standard normals
    (n_draws, m), else drawn from gen."""
    theta = thin_samples(samples, n_draws)
    y_model = forward_b(theta)
    if noise is None:
        noise = torch.randn(y_model.shape, generator=gen, dtype=y_model.dtype, device=y_model.device)
    return y_model, y_model + noise_sigma * noise


def ppc_chi2_pvalue(
    forward_b: Callable,
    samples: torch.Tensor,
    data: torch.Tensor,
    noise_sigma: float,
    gen: torch.Generator,
    *,
    n_draws: int = 1024,
) -> dict:
    """Returns {"p_value", "t_obs_mean", "t_rep_mean", "n_draws", "n_obs"};
    forward_b: batched forward (n, d) -> (n, m) in the coordinates of
    ``samples``."""
    y_model, y_rep = posterior_predictive(forward_b, samples, noise_sigma, gen, n_draws=n_draws)
    inv = 1.0 / noise_sigma**2
    t_obs = torch.sum((data[None, :] - y_model) ** 2, -1) * inv
    t_rep = torch.sum((y_rep - y_model) ** 2, -1) * inv
    return {
        "p_value": float(torch.mean((t_rep >= t_obs).to(torch.float32))),
        "t_obs_mean": float(torch.mean(t_obs)),
        "t_rep_mean": float(torch.mean(t_rep)),
        "n_draws": int(y_model.shape[0]),
        "n_obs": int(y_model.shape[1]),
    }


def noise_posterior(
    forward_b: Callable,
    samples: torch.Tensor,
    data: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    a0: float,
    b0: float,
    n_draws: int = 1024,
    gammas: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, dict]:
    """The marginal posterior of the observation noise in an infer_noise run
    (infer/pcn.py marginal_misfit, the same InvGamma(a0, b0) noise prior).
    Given theta the noise is conjugate, sigma^2 | theta, d ~ InvGamma(a0 +
    m/2, b0 + S(theta)/2) with S = ||d - G(theta)||^2, so one draw per
    thinned kept theta is an exact draw from the sigma marginal. gammas
    (n_draws,): the Gamma(a0 + m/2, 1) draws, else drawn from gen. Returns
    (sigma draws, {"sigma_mean", "sigma_sd", "sigma_q05", "sigma_q50",
    "sigma_q95", "n_draws", "n_obs"})."""
    theta = thin_samples(samples, n_draws)
    y = forward_b(theta)
    s = torch.sum((data[None, :] - y) ** 2, -1)
    m = y.shape[-1]
    if gammas is None:
        shape = torch.full(s.shape, a0 + 0.5 * m, dtype=s.dtype, device=s.device)
        gammas = torch._standard_gamma(shape, generator=gen)
    sigma = torch.sqrt((b0 + 0.5 * s) / gammas.to(s.dtype))  # InvGamma(a, b) = b / Gamma(a, 1)
    q = torch.quantile(sigma, torch.tensor([0.05, 0.5, 0.95], dtype=sigma.dtype, device=sigma.device))
    stats = {
        "sigma_mean": float(torch.mean(sigma)),
        "sigma_sd": float(torch.std(sigma, correction=0)),
        "sigma_q05": float(q[0]),
        "sigma_q50": float(q[1]),
        "sigma_q95": float(q[2]),
        "n_draws": int(y.shape[0]),
        "n_obs": m,
    }
    return sigma, stats


def ppc_shape_pvalue(
    forward_b: Callable,
    samples: torch.Tensor,
    data: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    n_draws: int = 1024,
    normals: Optional[torch.Tensor] = None,
) -> dict:
    """Scale-free posterior predictive check for an unknown noise. The
    chi-square discrepancy is powerless there: the inferred sigma absorbs any
    misfit magnitude. So test the residual's shape,

        T(r) = sqrt(m) max_j |r_j| / ||r||,

    the largest studentised residual component, invariant to scale:
    structured model error (one observable systematically off) drives it
    toward sqrt(m) whatever sigma is inferred. Replicated residuals are
    sigma times iid normals and T ignores sigma, so unit normals simulate its
    reference distribution; normals (n_draws, m) injects them."""
    theta = thin_samples(samples, n_draws)
    y = forward_b(theta)
    r_obs = data[None, :] - y
    m = y.shape[-1]

    def t_stat(r):
        nrm = torch.sqrt(torch.sum(r * r, -1))
        return math.sqrt(m) * torch.amax(torch.abs(r), -1) / nrm

    if normals is None:
        normals = torch.randn(r_obs.shape, generator=gen, dtype=r_obs.dtype, device=r_obs.device)
    t_obs, t_rep = t_stat(r_obs), t_stat(normals.to(r_obs.dtype))
    return {
        "p_value": float(torch.mean((t_rep >= t_obs).to(torch.float32))),
        "t_obs_mean": float(torch.mean(t_obs)),
        "t_rep_mean": float(torch.mean(t_rep)),
        "n_draws": int(y.shape[0]),
        "n_obs": m,
        "statistic": "max-studentized-residual (scale-free)",
    }
