"""Model evidence in the port (infer/evidence.py) against the JAX reference.

1. Each estimator (prior_phi_moments, log_evidence_ti with and without the
   second moments, hot_panel_refinement, log_evidence_ss and
   log_evidence_from_pt by both methods) on the arrays of one JAX PT
   result, with the prior batch's normals shared, equal to rounding in
   float64.
2. The analytic evidence of the linear-Gaussian model (the case of
   tests/test_evidence.py's test_ss_evidence_matches_analytic_any_ladder,
   with its parametrisation and tolerances) from the port's run_pt_pcn on
   its own torch.Generator, and the corrected TI beside stepping-stone on a
   geometric ladder (test_ti_evidence_matches_on_geometric_ladder)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.infer import evidence as je
from bayesianinferencedl_tpu.infer.pcn import gaussian_misfit as j_misfit
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu.infer.tempering import run_pt_pcn as j_run_pt_pcn
from bayesianinferencedl_tpu_torch.infer import evidence as te
from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit as t_misfit
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior
from bayesianinferencedl_tpu_torch.infer.tempering import run_pt_pcn

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D, M, SIGMA, SP = 3, 4, 0.5, 1.0


def _linear_gaussian():
    """Both sides' batched misfits, priors and the analytic log Z:
    log Z = m log sigma - log|S| / 2 - d^T S^-1 d / 2, S = sp^2 H H^T +
    sigma^2 I."""
    rng = np.random.default_rng(0)
    H = rng.standard_normal((M, D))
    data = rng.standard_normal(M)
    S = SP**2 * H @ H.T + SIGMA**2 * np.eye(M)
    log_z = M * np.log(SIGMA) - 0.5 * np.linalg.slogdet(S)[1] - 0.5 * data @ np.linalg.solve(S, data)
    Hj, Ht = jnp.asarray(H), torch.from_numpy(H)
    j = (j_misfit(lambda t: t @ Hj.T, jnp.asarray(data), SIGMA),
         JPrior.iid(D, mean=0.0, sigma=SP, dtype=jnp.float64))
    t = (t_misfit(lambda x: x @ Ht.T, torch.from_numpy(data), SIGMA),
         TPrior.iid(D, mean=0.0, sigma=SP, dtype=torch.float64, device="cpu"))
    return j, t, float(log_z)


def _close(t, j, tol=1e-12):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def jax_result():
    """A short adaptive-ladder JAX PT run (its arrays feed both sides)."""
    (mj, pj), _, _ = _linear_gaussian()
    theta0 = pj.sample(jax.random.PRNGKey(0), (16,))
    return j_run_pt_pcn(mj, pj, theta0, jax.random.PRNGKey(1), n_steps=300, n_burn=100, beta=0.4,
                        n_temps=5, lambda_min=0.02, adapt_ladder=True, batched=True)


def test_prior_moments_match_reference():
    (mj, pj), (mt, pt), _ = _linear_gaussian()
    key, n = jax.random.PRNGKey(7), 512
    z = torch.from_numpy(np.array(jax.random.normal(key, (n, D), jnp.float64)))
    for a, b in zip(te.prior_phi_moments(mt, pt, n=n, normals=z), je.prior_phi_moments(mj, pj, key, n)):
        _close(a, b)


@pytest.mark.parametrize("moments", ["plain", "corrected", "fallback"])
def test_ti_matches_reference(jax_result, moments):
    r = jax_result
    e0, e2 = 35.0, 2100.0
    kw_j, kw_t = {}, {}
    if moments != "plain":
        kw_j["phi2_level_mean"] = r.phi2_level_mean
        kw_t["phi2_level_mean"] = torch.from_numpy(np.asarray(r.phi2_level_mean))
        if moments == "corrected":
            kw_j["phi2_prior_mean"] = kw_t["phi2_prior_mean"] = e2
    ej = je.log_evidence_ti(r.lambdas, r.phi_level_mean, e0, **kw_j)
    et = te.log_evidence_ti(torch.from_numpy(np.asarray(r.lambdas)),
                            torch.from_numpy(np.asarray(r.phi_level_mean)), e0, **kw_t)
    _close(et.log_z_groups, ej.log_z_groups)
    _close([et.log_z, et.log_z_std, et.phi_prior_mean], [ej.log_z, ej.log_z_std, ej.phi_prior_mean])
    # a shared (K,) ladder gives the same per-group nodes
    lam1 = np.asarray(r.lambdas)[:, 0]
    _close(te.log_evidence_ti(torch.from_numpy(lam1), torch.from_numpy(np.asarray(r.phi_level_mean)),
                              e0).log_z_groups,
           je.log_evidence_ti(jnp.asarray(lam1), r.phi_level_mean, e0).log_z_groups)


def test_ss_and_hot_panel_match_reference(jax_result):
    r = jax_result
    phi_prior = np.random.default_rng(3).exponential(30.0, 777)
    ej = je.log_evidence_ss(r.lambdas, r.ss_level_mean, jnp.asarray(phi_prior))
    et = te.log_evidence_ss(torch.from_numpy(np.asarray(r.lambdas)),
                            torch.from_numpy(np.asarray(r.ss_level_mean)), torch.from_numpy(phi_prior))
    _close(et.log_z_groups, ej.log_z_groups)
    _close([et.log_z, et.log_z_std, et.phi_prior_mean], [ej.log_z, ej.log_z_std, ej.phi_prior_mean])
    lam1 = np.asarray(r.lambdas)[0]
    for a, b in zip(te.hot_panel_refinement(torch.from_numpy(phi_prior), torch.from_numpy(lam1)),
                    je.hot_panel_refinement(jnp.asarray(phi_prior), jnp.asarray(lam1))):
        _close(a, b)


@pytest.mark.parametrize("method,refine", [("ss", True), ("ti", True), ("ti", False)])
def test_log_evidence_from_pt_matches_reference(jax_result, method, refine):
    (mj, pj), (mt, pt), _ = _linear_gaussian()
    r = jax_result
    key, n = jax.random.PRNGKey(9), 1024
    ej = je.log_evidence_from_pt(r, mj, pj, key, n_prior=n, method=method, refine_hot_panel=refine)
    rt = type("R", (), {f: torch.from_numpy(np.asarray(getattr(r, f)))
                        for f in ("lambdas", "phi_level_mean", "phi2_level_mean", "ss_level_mean")})
    z = torch.from_numpy(np.array(jax.random.normal(key, (n, D), jnp.float64)))
    et = te.log_evidence_from_pt(rt, mt, pt, n_prior=n, method=method, refine_hot_panel=refine,
                                 normals=z)
    _close(et.log_z_groups, ej.log_z_groups)
    _close([et.log_z, et.log_z_std, et.phi_prior_mean], [ej.log_z, ej.log_z_std, ej.phi_prior_mean])
    with pytest.raises(ValueError, match="unknown evidence method"):
        te.log_evidence_from_pt(rt, mt, pt, n_prior=n, method="smc", normals=z)


@pytest.mark.parametrize(
    "n_temps,lambda_min,adapt_ladder",
    [(6, 0.01, False), (8, 0.05, True), (5, 0.2, True)],
)
def test_ss_evidence_matches_analytic_any_ladder(n_temps, lambda_min, adapt_ladder):
    _, (misfit, prior), log_z = _linear_gaussian()
    gen = torch.Generator().manual_seed(0)
    res = run_pt_pcn(misfit, prior, prior.sample(gen, (64,)), gen, n_steps=8000, n_burn=2000,
                     beta=0.4, n_temps=n_temps, lambda_min=lambda_min, adapt_ladder=adapt_ladder)
    est = te.log_evidence_from_pt(res, misfit, prior, gen)
    assert abs(est.log_z - log_z) < max(3 * est.log_z_std / 8, 0.06), (est.log_z, log_z)
    assert est.log_z_std < 0.2  # the per-group spread is an honest error bar


def test_ti_evidence_matches_on_geometric_ladder():
    _, (misfit, prior), log_z = _linear_gaussian()
    gen = torch.Generator().manual_seed(1)
    res = run_pt_pcn(misfit, prior, prior.sample(gen, (64,)), gen, n_steps=8000, n_burn=2000,
                     beta=0.4, n_temps=6, lambda_min=0.01)
    g_prior = torch.Generator().manual_seed(7)
    est_ti = te.log_evidence_from_pt(res, misfit, prior, g_prior, method="ti")
    est_ss = te.log_evidence_from_pt(res, misfit, prior, g_prior.manual_seed(7))
    assert abs(est_ti.log_z - log_z) < 0.06, (est_ti.log_z, log_z)
    assert abs(est_ti.log_z - est_ss.log_z) < 0.06
