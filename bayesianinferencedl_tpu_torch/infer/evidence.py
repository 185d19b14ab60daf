"""Model evidence from the tempered samplers' ladder.

The tempered samplers simulate the path pi_lambda ~ exp(-lambda Phi) mu0,
lambda in (0, 1], and the thermodynamic identity

    d/d lambda log Z(lambda) = -E_{pi_lambda}[Phi],  Z(0) = 1,

turns the per-level post-burn means they accumulate into the log evidence
log Z = log E_mu0[exp(-Phi)], the prior-predictive mass of the data, whose
differences across forward models on the same data and prior are log Bayes
factors. Two estimators: stepping-stone (the default; no quadrature error
on any ladder) and thermodynamic integration (a cross-check). Both use one
batch of iid prior draws for the lambda -> 0 end. The estimate is made per
chain group, so the spread across groups is a Monte-Carlo error bar.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul


class EvidenceEstimate(NamedTuple):
    log_z: float  # mean over chain groups
    log_z_std: float  # std of the per-group estimates (Monte-Carlo error bar)
    log_z_groups: torch.Tensor  # (G,) per-group estimates
    phi_prior_mean: float  # the lambda -> 0 end, E_mu0[Phi]


def _estimate(log_z_groups: torch.Tensor, phi_prior_mean) -> EvidenceEstimate:
    return EvidenceEstimate(
        log_z=float(torch.mean(log_z_groups)),
        log_z_std=float(torch.std(log_z_groups, correction=0)),
        log_z_groups=log_z_groups,
        phi_prior_mean=float(phi_prior_mean),
    )


def _per_group(lambdas: torch.Tensor, K: int, G: int, dtype) -> torch.Tensor:
    return (lambdas[:, None] if lambdas.dim() == 1 else lambdas).expand(K, G).to(dtype)


def _prior_phi(misfit_fn: Callable, prior: GaussianPrior, gen, n: int,
               normals: Optional[torch.Tensor]) -> torch.Tensor:
    """The misfits of n iid prior draws; normals (n, d) injects the draws'
    standard normals."""
    if normals is None:
        return misfit_fn(prior.sample(gen, (n,)))
    with fp32_matmul():
        theta = prior.mean + normals @ prior.chol.T
    return misfit_fn(theta)


def prior_phi_moments(
    misfit_fn: Callable,
    prior: GaussianPrior,
    gen: Optional[torch.Generator] = None,
    n: int = 4096,
    *,
    normals: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(E_mu0[Phi], E_mu0[Phi^2]) by iid prior Monte Carlo: the lambda = 0
    end of the thermodynamic integral, the one point no tempered chain
    visits. misfit_fn is batched, in working coordinates."""
    phi = _prior_phi(misfit_fn, prior, gen, n, normals)
    return torch.mean(phi), torch.mean(phi * phi)


def log_evidence_ti(
    lambdas: torch.Tensor,  # (K,) or (K, G), ascending, lambdas[-1] = 1
    phi_level_mean: torch.Tensor,  # (K, G) post-burn E_lambda[Phi]
    phi_prior_mean,  # scalar E_mu0[Phi]
    phi2_level_mean: Optional[torch.Tensor] = None,  # (K, G) E_lambda[Phi^2]
    phi2_prior_mean=None,  # scalar E_mu0[Phi^2]
) -> EvidenceEstimate:
    """Thermodynamic integration per chain group over the nodes (0,
    E_mu0[Phi]) and the ladder. Without second moments the plain trapezoid;
    with them the corrected trapezoid, which uses dE/d lambda =
    -Var_lambda[Phi]:

        int_a^b E ~ (h/2)(E_a + E_b) + (h^2/12)(Var_b - Var_a),  h = b - a,

    cancelling the trapezoid's O(h^2) bias. Exact to Monte-Carlo error on
    geometric ladders; on swap-rate-adapted ladders a bias survives, and
    ``log_evidence_ss`` is the estimator to use."""
    K, G = phi_level_mean.shape
    dtype = phi_level_mean.dtype
    lam = _per_group(lambdas, K, G, dtype)
    nodes = torch.cat([lam.new_zeros((1, G)), lam], 0)  # (K+1, G)
    e0 = torch.as_tensor(phi_prior_mean, dtype=dtype, device=lam.device).expand(1, G)
    vals = torch.cat([e0, phi_level_mean], 0)
    dl = torch.diff(nodes, dim=0)  # (K, G)
    integral = torch.sum(0.5 * (vals[1:] + vals[:-1]) * dl, 0)
    if phi2_level_mean is not None:
        # without the prior's second moment: the zero-variance fallback
        e2_0 = phi2_prior_mean if phi2_prior_mean is not None else phi_prior_mean * phi_prior_mean
        e2_0 = torch.as_tensor(e2_0, dtype=dtype, device=lam.device).expand(1, G)
        var = torch.clamp(torch.cat([e2_0, phi2_level_mean], 0) - vals * vals, min=0.0)
        integral = integral + torch.sum((dl * dl / 12.0) * (var[1:] - var[:-1]), 0)
    return _estimate(-integral, phi_prior_mean)


def hot_panel_refinement(
    phi_prior: torch.Tensor,  # (n,) misfits of iid prior draws
    lam1: torch.Tensor,  # (G,) hottest level per group
    n_sub: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """int_0^{lam1} E_lambda[Phi] d lambda by self-normalised importance
    reweighting of one prior batch,

        E_lambda[Phi] = E_mu0[Phi e^{-lambda Phi}] / E_mu0[e^{-lambda Phi}],

    on n_sub log-spaced sub-nodes over three decades below lam1,
    trapezoid-integrated: the panel no tempered chain covers, where the
    weights are flattest. Returns (integral (G,), the weights' ESS fraction
    at lam1 (G,); below ~0.1 the refinement itself is under-sampled)."""
    n = phi_prior.shape[0]
    expo = torch.linspace(-3.0, 0.0, n_sub, dtype=phi_prior.dtype, device=phi_prior.device)
    nodes = lam1[None, :] * (10.0 ** expo)[:, None]  # (S, G)
    lw = -nodes[..., None] * phi_prior[None, None, :]  # (S, G, n)
    lw = lw - torch.amax(lw, -1, keepdim=True)
    w = torch.exp(lw)
    wsum = torch.sum(w, -1)
    e_nodes = torch.sum(w * phi_prior[None, None, :], -1) / wsum  # (S, G)
    ess_frac = (wsum**2 / torch.sum(w * w, -1)) / n
    # trapezoid over [0, node_0], then over the sub-nodes up to lam1
    e0 = torch.mean(phi_prior)
    first = 0.5 * (e0 + e_nodes[0]) * nodes[0]
    dl = torch.diff(nodes, dim=0)
    rest = torch.sum(0.5 * (e_nodes[1:] + e_nodes[:-1]) * dl, 0)
    return first + rest, ess_frac[-1]


def log_evidence_ss(
    lambdas: torch.Tensor,  # (K,) or (K, G), ascending, lambdas[-1] = 1
    ss_level_mean: torch.Tensor,  # (K-1, G) E_{lambda_j}[e^{-(lambda_{j+1}-lambda_j) Phi}]
    phi_prior: torch.Tensor,  # (n,) misfits of iid prior draws
) -> EvidenceEstimate:
    """Stepping-stone evidence (Xie et al. 2011): the telescoping product of
    the level ratios Z(l_{j+1}) / Z(l_j) = E_{pi_{l_j}}[exp(-(l_{j+1} - l_j)
    Phi)], which the tempered samplers accumulate, times the prior-to-hottest
    ratio Z(l_1) = E_mu0[exp(-l_1 Phi)] from the prior batch. Consistent for
    any ladder spacing; the 0.234 swap target of the adaptive ladder is the
    moderate-overlap regime where each ratio has low variance."""
    K, G = ss_level_mean.shape[0] + 1, ss_level_mean.shape[1]
    lam = _per_group(lambdas, K, G, phi_prior.dtype)
    n = phi_prior.shape[0]
    log_r0 = torch.logsumexp(-lam[0][:, None] * phi_prior[None, :], -1) - math.log(float(n))
    log_z_groups = log_r0 + torch.sum(torch.log(ss_level_mean), 0)
    return _estimate(log_z_groups, torch.mean(phi_prior))


def log_evidence_from_pt(
    result,
    misfit_fn: Callable,
    prior: GaussianPrior,
    gen: Optional[torch.Generator] = None,
    *,
    n_prior: int = 4096,
    method: str = "ss",
    refine_hot_panel: bool = True,
    normals: Optional[torch.Tensor] = None,
) -> EvidenceEstimate:
    """The evidence from a ``PTResult`` or ``PTDAResult`` and one batch of
    n_prior iid prior draws (normals (n_prior, d) injects their standard
    normals). method "ss" (default): stepping-stone on ``ss_level_mean``.
    method "ti": corrected thermodynamic integration on the level moments,
    with the [0, lambda_1] panel replaced by ``hot_panel_refinement`` unless
    refine_hot_panel is False; the two estimators share no failure mode but
    the chains. For a ``PTDAResult``, misfit_fn is the fine misfit, which is
    what its accumulators hold."""
    phi_prior = _prior_phi(misfit_fn, prior, gen, n_prior, normals)
    if method == "ss":
        return log_evidence_ss(result.lambdas, result.ss_level_mean, phi_prior)
    if method != "ti":
        raise ValueError(f"unknown evidence method {method!r} (use 'ss' or 'ti')")
    e0, e2_0 = torch.mean(phi_prior), torch.mean(phi_prior * phi_prior)
    est = log_evidence_ti(result.lambdas, result.phi_level_mean, e0,
                          phi2_level_mean=result.phi2_level_mean, phi2_prior_mean=e2_0)
    if not refine_hot_panel:
        return est
    # swap the [0, lam1] trapezoid panel, its Hermite term included, for the
    # importance-refined integral
    K, G = result.phi_level_mean.shape
    lam1 = _per_group(result.lambdas, K, G, phi_prior.dtype)[0]
    e1 = result.phi_level_mean[0]
    var0 = torch.clamp(e2_0 - e0 * e0, min=0.0)
    var1 = torch.clamp(result.phi2_level_mean[0] - e1 * e1, min=0.0)
    coarse = 0.5 * (e0 + e1) * lam1 + (lam1 * lam1 / 12.0) * (var1 - var0)
    refined, _ = hot_panel_refinement(phi_prior, lam1)
    return _estimate(est.log_z_groups + coarse - refined, e0)
