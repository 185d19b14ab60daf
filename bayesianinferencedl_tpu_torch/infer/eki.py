"""Ensemble Kalman inversion (EKI) with adaptive tempering (Iglesias, Law
and Stuart 2013; adaptive steps after Iglesias and Yang).

The ensemble is the batch: an iteration is one batched forward over all J
members (on the fom likelihood, one batched stencil-kernel solve) followed
by the Kalman update with the ensemble cross-covariances. EKI transports
the prior ensemble along pi_t ~ exp(-t Phi) mu0 from t = 0 to 1; each
increment dt applies the update with the inflated noise Sigma / dt. That is
exact for a linear forward map and a Gaussian prior as J grows; for a
nonlinear one it is the Gaussian-ansatz approximation, a fast
derivative-free posterior approximation, not an exact sampler.

Each dt is the largest one whose tempering weights exp(-dt Phi) keep an
effective-sample-size fraction ``ess_target`` (bisection, capped at the
remaining 1 - t). The forward runs on the device; the m x m Kalman algebra
(m = n_obs) and the perturbed observations are host float64 NumPy.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior


class EKIResult(NamedTuple):
    ensemble: torch.Tensor  # (J, d) final ensemble, working coordinates
    mean: torch.Tensor  # (d,) ensemble mean
    std: torch.Tensor  # (d,) ensemble marginal std (exact only in the linear-Gaussian limit)
    ts: list  # the tempering knots 0 = t_0 < ... < t_N = 1 taken
    misfit_trace: list  # the ensemble-mean data misfit at each knot
    n_forward: int  # forward evaluations, J x (iterations + 1)


def _ess_fraction(dphi: np.ndarray, dt: float) -> float:
    """ESS / J of the tempering increment weights w ~ exp(-dt dphi)."""
    lw = -dt * (dphi - dphi.min())
    w = np.exp(lw - lw.max())
    return float(w.sum() ** 2 / (w * w).sum() / w.size)


def _adaptive_dt(dphi: np.ndarray, remaining: float, ess_target: float) -> float:
    """The largest dt <= remaining whose ESS fraction is >= ess_target, by
    bisection (the fraction falls monotonically in dt)."""
    if _ess_fraction(dphi, remaining) >= ess_target:
        return remaining
    lo, hi = 0.0, remaining
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if _ess_fraction(dphi, mid) >= ess_target:
            lo = mid
        else:
            hi = mid
    return max(lo, 1e-6 * remaining)


def run_eki(
    forward_batch: Callable,
    prior: GaussianPrior,
    data: torch.Tensor,
    noise_sigma: float,
    gen: Optional[torch.Generator] = None,
    *,
    n_ensemble: int = 1024,
    ess_target: float = 0.5,
    max_iters: int = 50,
    theta0: Optional[torch.Tensor] = None,
    rng: Optional[np.random.Generator] = None,
    mesh=None,
) -> EKIResult:
    """Adaptive-tempering EKI to t = 1. forward_batch: (J, d) -> (J, m) in
    working coordinates. The initial ensemble is theta0 (J, d), else J
    prior draws from gen; the perturbed observations come from rng, else
    from a NumPy generator seeded by one draw of gen (the reference seeds
    it from its key the same way). mesh: the forward sweeps' ensemble axis
    is sharded over its ranks (J divisible by the world size) and gathered
    back; the ensemble algebra is the same on every rank."""
    from bayesianinferencedl_tpu_torch.parallel.sharding import sharded_rows_fn

    forward_batch = sharded_rows_fn(mesh, forward_batch)
    if theta0 is None:
        theta = prior.sample(gen, (n_ensemble,))
    else:
        theta = torch.as_tensor(theta0, dtype=prior.mean.dtype, device=prior.mean.device)
    J = theta.shape[0]
    if rng is None:
        seed = int(torch.randint(0, np.iinfo(np.int32).max, (1,), generator=gen,
                                 device="cpu" if gen is None else gen.device).item())
        rng = np.random.default_rng(seed)
    data64 = torch.as_tensor(data).double().cpu().numpy()
    m = data64.shape[0]
    sig2 = float(noise_sigma) ** 2

    def misfit_of(G):
        r = G - data64[None, :]
        return 0.5 * np.einsum("jm,jm->j", r, r) / sig2

    t = 0.0
    ts = [0.0]
    misfit_trace = []
    n_forward = 0
    it = 0
    while t < 1.0 and it < max_iters:
        it += 1
        # the device: one batched forward for the whole ensemble
        with torch.no_grad():
            G = forward_batch(theta).double().cpu().numpy()  # (J, m)
        n_forward += J
        th = theta.double().cpu().numpy()  # (J, d)
        phi = misfit_of(G)
        misfit_trace.append(float(phi.mean()))

        # the host, float64: the step and the m x m Kalman algebra
        dt = _adaptive_dt(phi, 1.0 - t, ess_target)
        Gc = G - G.mean(axis=0, keepdims=True)
        thc = th - th.mean(axis=0, keepdims=True)
        C_yy = Gc.T @ Gc / (J - 1)  # (m, m)
        C_ty = thc.T @ Gc / (J - 1)  # (d, m)
        # perturbed observations with the 1/dt-inflated noise
        eps = rng.standard_normal((J, m)) * (noise_sigma / np.sqrt(dt))
        K = C_ty @ np.linalg.inv(C_yy + np.eye(m) * (sig2 / dt))  # (d, m)
        th = th + (data64[None, :] + eps - G) @ K.T
        t += dt
        ts.append(round(t, 8))
        theta = torch.as_tensor(th, dtype=prior.mean.dtype, device=prior.mean.device)

    # the misfit at t = 1: one more batched forward, reported, not used
    with torch.no_grad():
        G = forward_batch(theta).double().cpu().numpy()
    n_forward += J
    misfit_trace.append(float(misfit_of(G).mean()))
    return EKIResult(
        ensemble=theta, mean=torch.mean(theta, dim=0), std=torch.std(theta, dim=0, correction=0),
        ts=ts, misfit_trace=misfit_trace, n_forward=n_forward,
    )
