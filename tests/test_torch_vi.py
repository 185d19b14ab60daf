"""ADVI in the port (infer/vi.py) against the JAX reference, in float64.

1. Replay: run_advi on JAX's per-step normals (fold_in(key, step)),
   injected, over 40 steps: full rank, mean-field, a ref frame with theta0,
   and JAX's segmented run (segments of 15) against the port's one loop;
   mu, L, theta_mean, theta_chol and the ELBO trace to 1e-10. vi_sample on
   injected normals.
2. The analytic cases of tests/test_vi.py on the port's own
   torch.Generator, at that file's tolerances: full rank recovers the
   linear-Gaussian posterior, mean-field shrinks correlated marginals, the
   ref frame with theta0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.infer import vi as jv
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu_torch.infer import vi as tv
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

STEPS, N_MC = 40, 16


def _linear_gaussian(d=6, sigma=0.5, seed=0, cond=20.0):
    """tests/test_vi.py's anisotropic correlated problem: both misfits and
    priors, the exact posterior."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((d, d)) * np.geomspace(1.0, cond, d)[None, :]
    data = rng.standard_normal(d)
    Cpost = np.linalg.inv(A.T @ A / sigma**2 + np.eye(d))
    mu = Cpost @ (A.T @ data) / sigma**2
    Aj, dj, At, dt = jnp.asarray(A), jnp.asarray(data), torch.tensor(A), torch.tensor(data)
    jm = lambda th: 0.5 / sigma**2 * jnp.sum((th @ Aj.T - dj) ** 2, axis=-1)
    tm = lambda th: 0.5 / sigma**2 * torch.sum((th @ At.T - dt) ** 2, dim=-1)
    return (jm, tm, JPrior.iid(d, sigma=1.0, dtype=jnp.float64),
            TPrior.iid(d, sigma=1.0, dtype=torch.float64, device="cpu"), mu, Cpost)


def _eps(key, n_steps, n_mc, d):
    """JAX's per-step normals: normal(fold_in(key, step), (n_mc, d))."""
    return torch.tensor(np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, t), (n_mc, d),
                                                               jnp.float64)) for t in range(n_steps)]))


@pytest.mark.parametrize("case", ["full", "meanfield", "ref_theta0", "segmented"])
def test_run_advi_replays_reference(case):
    jm, tm, jprior, tprior, mu, Cpost = _linear_gaussian(seed=5)
    rank = "meanfield" if case == "meanfield" else "full"
    kw = dict(n_steps=STEPS, n_mc=N_MC, rank=rank, lr=0.05)
    jkw, tkw = {}, {}
    if case == "ref_theta0":
        # a frame off the posterior and a start off its mean, so the fit moves
        ref = (mu + 0.3, 1.5 * np.linalg.cholesky(Cpost))
        th0 = mu - 0.2
        jkw = dict(ref=tuple(jnp.asarray(r) for r in ref), theta0=jnp.asarray(th0))
        tkw = dict(ref=tuple(torch.tensor(r) for r in ref), theta0=torch.tensor(th0))
    if case == "segmented":
        jkw = dict(segment=15)
    key = jax.random.PRNGKey(6)
    rj = jv.run_advi(jm, jprior, key, batched=True, **kw, **jkw)
    rt = tv.run_advi(tm, tprior, eps=_eps(key, STEPS, N_MC, 6), **kw, **tkw)
    for f in ("mu", "L", "theta_mean", "theta_chol", "elbo_trace"):
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)), rtol=1e-10,
                                   atol=1e-10, err_msg=f)
    assert rt.n_forward == rj.n_forward
    e = jax.random.normal(jax.random.PRNGKey(2), (64, 6), jnp.float64)
    np.testing.assert_allclose(tv.vi_sample(rt, eps=torch.tensor(np.asarray(e))).numpy(),
                               np.asarray(jv.vi_sample(rj, jax.random.PRNGKey(2), (64,))), rtol=1e-10,
                               atol=1e-10)


def test_full_rank_recovers_the_linear_gaussian_posterior():
    _, tm, _, tprior, mu, Cpost = _linear_gaussian()
    gen = torch.Generator().manual_seed(1)
    res = tv.run_advi(tm, tprior, gen, n_steps=4000, n_mc=64, rank="full", lr=0.02)
    np.testing.assert_allclose(res.theta_mean.numpy(), mu, atol=0.03)
    np.testing.assert_allclose((res.theta_chol @ res.theta_chol.T).numpy(), Cpost, atol=0.02)
    e = res.elbo_trace.numpy()
    assert e[-200:].mean() > e[:200].mean()
    s = tv.vi_sample(res, torch.Generator().manual_seed(2), (200_000,)).numpy()
    np.testing.assert_allclose(s.mean(0), mu, atol=0.02)
    np.testing.assert_allclose(np.cov(s.T), Cpost, atol=0.02)


def test_meanfield_shrinks_correlated_marginals():
    _, tm, _, tprior, mu, Cpost = _linear_gaussian(seed=3)
    res = tv.run_advi(tm, tprior, torch.Generator().manual_seed(4), n_steps=4000, n_mc=64,
                      rank="meanfield", lr=0.02)
    np.testing.assert_allclose(res.theta_mean.numpy(), mu, atol=0.04)
    sd_fit = np.sqrt(np.diag((res.theta_chol @ res.theta_chol.T).numpy()))
    sd_true = np.sqrt(np.diag(Cpost))
    assert np.all(sd_fit <= sd_true * 1.05) and np.any(sd_fit < sd_true * 0.95)


def test_ref_frame_and_theta0():
    _, tm, _, tprior, mu, Cpost = _linear_gaussian(seed=5)
    ref = (torch.tensor(mu), torch.tensor(np.linalg.cholesky(Cpost)))
    res = tv.run_advi(tm, tprior, torch.Generator().manual_seed(6), n_steps=1500, n_mc=64,
                      rank="full", lr=0.02, ref=ref, theta0=torch.tensor(mu))
    np.testing.assert_allclose(res.theta_mean.numpy(), mu, atol=0.03)
    np.testing.assert_allclose((res.theta_chol @ res.theta_chol.T).numpy(), Cpost, atol=0.02)


def test_rank_is_checked():
    _, tm, _, tprior, _, _ = _linear_gaussian()
    with pytest.raises(ValueError, match="rank must be"):
        tv.run_advi(tm, tprior, torch.Generator(), n_steps=1, rank="diag")
