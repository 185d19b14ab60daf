"""Chi-square posterior predictive check: does the fitted model explain the
data? p = P[T(y_rep, theta) >= T(y_obs, theta)] with
T(y, theta) = ||y - G(theta)||^2 / sigma^2, averaged over posterior draws."""

from __future__ import annotations

from typing import Callable

import torch


def thin_samples(samples: torch.Tensor, n_draws: int) -> torch.Tensor:
    """(T, C, d) kept chains -> (n_draws, d) evenly thinned flat subsample."""
    T, C, d = samples.shape
    flat = samples.reshape(T * C, d)
    idx = torch.linspace(0, T * C - 1, min(n_draws, T * C), dtype=torch.float64).to(torch.int64)
    return flat[idx.to(flat.device)]


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
    theta = thin_samples(samples, n_draws)
    y_model = forward_b(theta)
    y_rep = y_model + noise_sigma * torch.randn(
        y_model.shape, generator=gen, dtype=y_model.dtype, device=y_model.device
    )
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
