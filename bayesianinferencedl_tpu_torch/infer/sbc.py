"""Simulation-based calibration (SBC): the posterior-correctness oracle.

Talts et al. 2018: draw (theta*, y) from prior x likelihood, sample the
posterior given y with the sampler under test, and rank theta* among L
posterior draws. If the sampler targets the exact posterior the rank is
uniform on {0..L} for every parameter; a warped posterior (mis-scaled
noise, a wrong accept ratio, a prior mismatch, a biased surrogate) shows as
a non-uniform rank histogram. R-hat certifies that chains agree; SBC that
they agree on the right posterior.

All J synthetic datasets run as one batch: the chain axis is J x C, each
chain slot carrying its dataset in the batched misfit, so the calibration is
one sampler run. The L draws of a rank are the C chains' final states:
independent chains give independent draws, so no thinning is needed.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.infer.hmc import run_hmc
from bayesianinferencedl_tpu_torch.infer.mala import run_mala
from bayesianinferencedl_tpu_torch.infer.pcn import run_pcn
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.infer.tempering import run_pt_pcn

SAMPLERS = ("pcn", "mala", "hmc", "pt_pcn")


class SBCResult(NamedTuple):
    ranks: torch.Tensor  # (J, d) int32, the rank of theta*_j among C draws, in [0, C]
    n_draws: int  # C (the rank takes C + 1 values)
    p_values: torch.Tensor  # (d,) chi-square uniformity p-value per parameter
    counts: torch.Tensor  # (d, n_bins) rank-histogram counts
    accept_rate: torch.Tensor  # (J*C,) per-chain acceptance (the cold level's under pt_pcn)


def rank_uniformity_pvalue(ranks, n_draws: int, n_bins: int):
    """Chi-square goodness of fit of ranks (J, d) against the uniform law on
    {0..n_draws}, per parameter; n_bins must divide n_draws + 1 so that every
    bin has equal probability. Returns (p_values (d,), counts (d, n_bins)),
    numpy arrays."""
    from scipy import stats

    ranks = np.asarray(ranks)
    J, d = ranks.shape
    if (n_draws + 1) % n_bins:
        raise ValueError(f"n_bins={n_bins} must divide n_draws+1={n_draws + 1}")
    width = (n_draws + 1) // n_bins
    bins = np.clip(ranks // width, 0, n_bins - 1)
    counts = np.stack([np.bincount(bins[:, i], minlength=n_bins) for i in range(d)])
    expected = J / n_bins
    chi2 = ((counts - expected) ** 2 / expected).sum(axis=1)
    return stats.chi2.sf(chi2, df=n_bins - 1), counts


def run_sbc(
    forward_batch: Callable,
    prior: GaussianPrior,
    noise_sigma: float,
    gen: Optional[torch.Generator] = None,
    *,
    n_datasets: int,
    n_chains: int = 32,
    n_steps: int = 800,
    n_burn: int = 400,
    beta: float = 0.25,
    n_bins: int = 8,
    sampler: str = "pcn",
    step: float = 0.1,
    n_leap: int = 8,
    n_temps: int = 5,
    lambda_min: float = 0.02,
    theta_star: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    theta0: Optional[torch.Tensor] = None,
    draws: Optional[dict] = None,
) -> SBCResult:
    """Calibrate a sampler and the Gaussian likelihood of ``forward_batch``
    ((B, d) -> (B, m), batched; differentiable for mala and hmc): J =
    n_datasets synthetic inversions with C = n_chains chains each, theta*
    ranked against each dataset's C final draws. n_chains + 1 must be
    divisible by n_bins.

    sampler: "pcn", "mala", "hmc" (step: the initial h, adapted in burn-in;
    n_leap: leapfrog steps) or "pt_pcn" (n_temps levels, the ladder adapted
    from lambda_min; the K replicas of a chain group share its data, the
    states flattened (K, G, d) -> (K*G, d) with K leading). SBC certifies
    data-averaged correctness: chains stranded in their prior basin on a
    multimodal posterior still pass, as their occupancy is the prior's.

    From gen, in order: theta* (J, d), the noise's standard normals (J, m),
    the chains' starts (J*C, d), then the sampler's draws; or pass
    theta_star, noise, theta0 and ``draws`` (the sampler's normals,
    uniforms, ... keyword arguments) to replay another stream."""
    J, C = n_datasets, n_chains
    if (C + 1) % n_bins:
        raise ValueError(f"n_chains+1={C + 1} must be divisible by n_bins={n_bins}")
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler must be pcn|mala|hmc|pt_pcn, got {sampler!r}")
    if theta_star is None:
        theta_star = prior.sample(gen, (J,))
    y_clean = forward_batch(theta_star)  # (J, m)
    if noise is None:
        noise = torch.randn(y_clean.shape, generator=gen, dtype=y_clean.dtype, device=y_clean.device)
    data = torch.repeat_interleave(y_clean + noise_sigma * noise, C, dim=0)  # (J*C, m): a dataset a slot
    inv_two_sig2 = 0.5 / (noise_sigma * noise_sigma)
    if sampler == "pt_pcn":
        data = data.repeat(n_temps, 1)  # (K*J*C, m), K leading

    def misfit(theta):
        r = forward_batch(theta) - data
        return inv_two_sig2 * torch.sum(r * r, -1)

    if theta0 is None:
        theta0 = prior.sample(gen, (J * C,))
    kw = dict(n_steps=n_steps, n_burn=n_burn, **(draws or {}))
    if sampler == "pt_pcn":
        res = run_pt_pcn(misfit, prior, theta0, gen, beta=beta, n_temps=n_temps,
                         lambda_min=lambda_min, adapt_ladder=True, **kw)
        accept = res.accept_rate[-1]  # the cold level
    elif sampler == "mala":
        res = run_mala(misfit, prior, theta0, gen, step=step, **kw)
    elif sampler == "hmc":
        res = run_hmc(misfit, prior, theta0, gen, step=step, n_leap=n_leap, **kw)
    else:
        res = run_pcn(misfit, prior, theta0, gen, beta=beta, **kw)
    if sampler != "pt_pcn":
        accept = res.accept_rate
    finals = res.samples[-1].reshape(J, C, -1)  # the C independent chains' final states
    ranks = torch.sum(finals < theta_star[:, None, :], 1).to(torch.int32)
    p_values, counts = rank_uniformity_pvalue(ranks.cpu().numpy(), C, n_bins)
    return SBCResult(ranks=ranks, n_draws=C, p_values=torch.as_tensor(p_values),
                     counts=torch.as_tensor(counts), accept_rate=accept)
