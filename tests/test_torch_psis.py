"""PSIS in the port (infer/psis.py) against the JAX reference, in float64.

1. The host NumPy core on the inputs of tests/test_psis.py: _gpd_fit and
   psis_smooth on the generalised-Pareto weights (and on a degenerate and a
   too-short tail), psis_correct_draws on the linear-Gaussian problem with
   a widened proposal, with and without non-finite misfits, all to 1e-10.
2. psis_correct on JAX's standard normals, injected: every field to 1e-10.
3. The analytic cases of tests/test_psis.py on the port's own
   torch.Generator, at that file's tolerances: the exact proposal, a
   covering one and a non-covering one, and the evidence against the
   closed form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.infer import psis as jps
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu_torch.infer import psis as tps
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

TOL = 1e-10


def _linear_gaussian(d=5, sigma=0.5, seed=0):
    """tests/test_psis.py's problem: both sides' misfits, both priors, the
    posterior and the analytic log evidence."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((d, d))
    data = rng.standard_normal(d)
    Cpost = np.linalg.inv(A.T @ A / sigma**2 + np.eye(d))
    mu = Cpost @ (A.T @ data) / sigma**2
    S = A @ A.T + sigma**2 * np.eye(d)
    log_z = float(0.5 * d * np.log(2.0 * np.pi * sigma**2)
                  - 0.5 * (data @ np.linalg.solve(S, data) + np.linalg.slogdet(S)[1]
                           + d * np.log(2.0 * np.pi)))
    Aj, dj, At, dt = jnp.asarray(A), jnp.asarray(data), torch.tensor(A), torch.tensor(data)
    j_misfit = lambda th: 0.5 / sigma**2 * jnp.sum((th @ Aj.T - dj) ** 2, axis=-1)
    t_misfit = lambda th: 0.5 / sigma**2 * torch.sum((th @ At.T - dt) ** 2, dim=-1)
    jprior = JPrior.iid(d, sigma=1.0, dtype=jnp.float64)
    tprior = TPrior.iid(d, sigma=1.0, dtype=torch.float64, device="cpu")
    return j_misfit, t_misfit, jprior, tprior, mu, Cpost, log_z


def _gpd_weights(K=8192, k_true=0.4, seed=6):
    u = np.random.default_rng(seed).uniform(size=K)
    return np.log((np.power(1.0 - u, -k_true) - 1.0) / k_true + 1e-9)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t, np.float64), np.asarray(j, np.float64), rtol=tol, atol=tol)


def _same_result(t, j):
    for f in ("mean", "cov", "k_hat", "ess", "log_weights", "log_evidence"):
        _close(getattr(t, f), getattr(j, f))
    _close(t.samples.numpy(), j.samples)
    assert t.reliable == j.reliable


@pytest.mark.parametrize("K", [100, 2048, 8192])
def test_gpd_fit_and_smooth_match_reference(K):
    lw = _gpd_weights(K)
    sm_t, k_t = tps.psis_smooth(lw)
    sm_j, k_j = jps.psis_smooth(lw)
    _close(sm_t, sm_j)
    _close(k_t, k_j)
    n = min(200, K // 4)  # the exceedances above the n + 1-th largest weight
    s = np.sort(lw - lw.max())
    x = np.exp(s[-n:]) - np.exp(s[-n - 1])
    _close(tps._gpd_fit(x), jps._gpd_fit(x))


def test_smooth_degenerate_and_short_tails_match_reference():
    const = np.zeros(4096)  # constant weights: no tail, k = -inf
    assert tps.psis_smooth(const)[1] == jps.psis_smooth(const)[1] == -np.inf
    short = np.random.default_rng(1).standard_normal(16)  # M < 5: k = inf
    assert tps.psis_smooth(short)[1] == jps.psis_smooth(short)[1] == np.inf
    assert tps._gpd_fit(np.arange(1.0, 4.0))[2] == np.inf


@pytest.mark.parametrize("nonfinite", [False, True])
def test_correct_draws_match_reference(nonfinite):
    """tests/test_psis.py's widened exact-posterior proposal; with
    nonfinite, the misfit is NaN past |theta| > 4 on both sides (the
    certificate voided, the moments finite)."""
    j_misfit, t_misfit, jprior, tprior, mu, Cpost, _ = _linear_gaussian()
    if nonfinite:
        jm, tm = j_misfit, t_misfit
        j_misfit = lambda th: jnp.where(jnp.max(jnp.abs(th), axis=-1) > 4.0, jnp.nan, jm(th))
        t_misfit = lambda th: torch.where(torch.amax(torch.abs(th), dim=-1) > 4.0, torch.nan, tm(th))
    L = np.linalg.cholesky(Cpost)
    z = jax.random.normal(jax.random.PRNGKey(3), (4096, 5), jnp.float64)
    theta = jnp.asarray(mu) + 3.0 * (z @ jnp.asarray(L).T)
    log_q = -0.5 * jnp.sum(z * z, axis=-1) - jnp.log(jnp.prod(jnp.abs(jnp.diag(jnp.asarray(L)))) * 3.0**5)
    rj = jps.psis_correct_draws(j_misfit, jprior, theta, log_q, batched=True)
    rt = tps.psis_correct_draws(t_misfit, tprior, torch.tensor(np.asarray(theta)),
                                torch.tensor(np.asarray(log_q)))
    _same_result(rt, rj)
    if nonfinite:
        assert not rt.reliable and np.isfinite(rt.mean).all()
        nan = lambda th: torch.full(th.shape[:-1], torch.nan, dtype=th.dtype)
        rt_all = tps.psis_correct_draws(nan, tprior, torch.tensor(np.asarray(theta)),
                                        torch.tensor(np.asarray(log_q)))
        rj_all = jps.psis_correct_draws(lambda th: jnp.full(th.shape[:-1], jnp.nan), jprior, theta,
                                        log_q, batched=True)
        assert rt_all.ess == rj_all.ess == 0.0 and rt_all.log_evidence == rj_all.log_evidence == -np.inf
        assert not rt_all.reliable and np.isnan(rt_all.mean).all()


@pytest.mark.parametrize("seed, shift, widen", [(0, 0.0, 1.0), (2, 0.25, 2.0), (4, 3.0, 0.15)])
def test_psis_correct_replays_reference(seed, shift, widen):
    """psis_correct with JAX's normals injected: the exact, a covering and a
    non-covering proposal of tests/test_psis.py."""
    j_misfit, t_misfit, jprior, tprior, mu, Cpost, _ = _linear_gaussian(seed=seed)
    q_mean = mu + shift * np.sqrt(np.diag(Cpost)) if shift == 3.0 else mu + shift
    q_chol = widen * np.linalg.cholesky(Cpost)
    key = jax.random.PRNGKey(seed + 1)
    rj = jps.psis_correct(j_misfit, jprior, jnp.asarray(q_mean), jnp.asarray(q_chol), key,
                          n_draws=2048, batched=True)
    eps = jax.random.normal(key, (2048, 5), jnp.float64)
    rt = tps.psis_correct(t_misfit, tprior, torch.tensor(q_mean), torch.tensor(q_chol),
                          eps=torch.tensor(np.asarray(eps)))
    _same_result(rt, rj)


def test_exact_proposal_on_the_port_generator():
    _, t_misfit, _, tprior, mu, Cpost, log_z = _linear_gaussian()
    res = tps.psis_correct(t_misfit, tprior, torch.tensor(mu), torch.tensor(np.linalg.cholesky(Cpost)),
                           torch.Generator().manual_seed(1), n_draws=4096)
    assert res.k_hat < 0.3 and res.reliable and res.ess > 0.98 * 4096
    np.testing.assert_allclose(res.mean, mu, atol=0.03)
    np.testing.assert_allclose(res.cov, Cpost, atol=0.03)
    assert abs(res.log_evidence - log_z) < 0.05


def test_covering_proposal_is_corrected_on_the_port_generator():
    _, t_misfit, _, tprior, mu, Cpost, log_z = _linear_gaussian(seed=2)
    q_mean = mu + 0.25
    res = tps.psis_correct(t_misfit, tprior, torch.tensor(q_mean),
                           torch.tensor(2.0 * np.linalg.cholesky(Cpost)),
                           torch.Generator().manual_seed(3), n_draws=16384)
    assert res.reliable, res.k_hat
    assert float(np.abs(res.mean - mu).mean()) < 0.25 * float(np.abs(q_mean - mu).mean())
    np.testing.assert_allclose(res.mean, mu, atol=0.05)
    np.testing.assert_allclose(res.cov, Cpost, atol=0.08)
    assert res.ess < 16384
    assert abs(res.log_evidence - log_z) < 0.1


def test_non_covering_proposal_is_flagged_on_the_port_generator():
    _, t_misfit, _, tprior, mu, Cpost, _ = _linear_gaussian(seed=4)
    res = tps.psis_correct(t_misfit, tprior, torch.tensor(mu + 3.0 * np.sqrt(np.diag(Cpost))),
                           torch.tensor(0.15 * np.linalg.cholesky(Cpost)),
                           torch.Generator().manual_seed(5), n_draws=4096)
    assert res.k_hat >= 0.7 and not res.reliable


def test_smooth_recovers_a_known_tail():
    """tests/test_psis.py's GPD(0.4) oracle: the tail index within 0.15, the
    max not raised, the body only shifted."""
    lw = _gpd_weights()
    sm, k_hat = tps.psis_smooth(lw)
    assert abs(k_hat - 0.4) < 0.15 and sm.max() <= 1e-12
    M = int(min(np.ceil(0.2 * lw.size), 3.0 * np.sqrt(lw.size)))
    body = np.argsort(lw)[:-M]
    d = sm[body] - (lw[body] - lw.max())
    assert np.allclose(d, d[0], atol=1e-12)
