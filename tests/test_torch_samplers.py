"""The Laplace-informed samplers of the port (infer/samplers.py) against the
JAX reference.

1. Replay: run_laplace_mh and run_gpcn, in float64 on a mildly nonlinear
   forward with a correlated prior, fed the draws of JAX's key schedule
   (regenerated here from the reference's splits), must give JAX's samples,
   log posteriors and accept rates to 1e-10.
2. The analytic cases of tests/test_samplers.py on the port's own
   torch.Generator, at that file's tolerances: on a linear-Gaussian target
   the Laplace approximation is exact, so the independence sampler is
   near-iid and gpCN accepts every proposal; both agree with pCN in moments
   and in KS distance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.infer import map as jm
from bayesianinferencedl_tpu.infer import samplers as js
from bayesianinferencedl_tpu.infer.pcn import gaussian_misfit as j_misfit
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu_torch.infer import map as tm
from bayesianinferencedl_tpu_torch.infer import samplers as ts
from bayesianinferencedl_tpu_torch.infer.diagnostics import effective_sample_size, ks_distance
from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit as t_misfit
from bayesianinferencedl_tpu_torch.infer.pcn import run_pcn
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs


def _close(t, j, tol=1e-10):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol, atol=tol)


def _problem():
    rng = np.random.default_rng(1)
    H = rng.standard_normal((4, 3))
    data = rng.standard_normal(4) * 0.5
    mean = np.array([0.1, -0.2, 0.05])
    L = np.tril(0.15 * np.ones((3, 3))) + 0.6 * np.eye(3)
    Hj, Ht = jnp.asarray(H), torch.from_numpy(H)
    fj = lambda t: jnp.tanh(t @ Hj.T)
    ft = lambda x: torch.tanh(x @ Ht.T)
    sigma = 0.3
    j = dict(fwd=fj, misfit=j_misfit(fj, jnp.asarray(data), sigma),
             prior=JPrior(jnp.asarray(mean), jnp.asarray(L)))
    t = dict(misfit=t_misfit(ft, torch.from_numpy(data), sigma),
             prior=TPrior(torch.from_numpy(mean), torch.from_numpy(L)))
    xj, _ = jm.find_map(j["misfit"], j["prior"], jnp.zeros(3))
    lj = jm.laplace_approximation(fj, jnp.asarray(data), sigma, j["prior"], xj)
    lt = tm.LaplaceApproximation(*(torch.from_numpy(np.asarray(a)) for a in lj))
    return j, t, lj, lt


def _mh_draws(key, n_steps, C, d):
    """The draws of JAX's run_laplace_mh / run_gpcn(key): per step the
    proposal normals (k_prop) and the acceptance uniforms (k_acc)."""
    nrm, uni = [], []
    for k in jax.random.split(key, n_steps):
        k_prop, k_acc = jax.random.split(k)
        nrm.append(np.asarray(jax.random.normal(k_prop, (C, d), jnp.float64)))
        uni.append(np.asarray(jax.random.uniform(k_acc, (C,), jnp.float64)))
    return torch.from_numpy(np.stack(nrm)), torch.from_numpy(np.stack(uni))


@pytest.mark.parametrize("sampler", ["laplace_mh", "gpcn"])
def test_replays_reference(sampler):
    j, t, lj, lt = _problem()
    C, n_steps, n_burn = 16, 60, 20
    theta0 = np.random.default_rng(2).normal(0.0, 0.6, (C, 3))
    key = jax.random.PRNGKey(8)
    kw = {} if sampler == "laplace_mh" else dict(beta=0.6)
    if sampler == "laplace_mh":
        rj = js.run_laplace_mh(j["misfit"], j["prior"], lj, jnp.asarray(theta0), key, n_steps=n_steps,
                               n_burn=n_burn)
    else:
        rj = js.run_gpcn(j["misfit"], j["prior"], lj, jnp.asarray(theta0), key, n_steps=n_steps,
                         n_burn=n_burn, **kw)
    nrm, uni = _mh_draws(key, n_steps, C, 3)
    run = ts.run_laplace_mh if sampler == "laplace_mh" else ts.run_gpcn
    rt = run(t["misfit"], t["prior"], lt, torch.from_numpy(theta0), n_steps=n_steps, n_burn=n_burn,
             normals=nrm, uniforms=uni, **kw)
    assert rt.samples.shape == (n_steps - n_burn, C, 3)
    _close(rt.samples, rj.samples)
    _close(rt.log_post, rj.log_post)
    # accept counts over all n_steps, burn-in included, as the reference's
    np.testing.assert_array_equal(rt.accept_rate.numpy() * n_steps,
                                  np.round(np.asarray(rj.accept_rate) * n_steps))
    assert 0.2 < float(rt.accept_rate.mean()) < 1.0


# --- the analytic cases of tests/test_samplers.py -----------------------------


def _setup(d=3, m=5, sigma=0.4, seed=0):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((m, d))
    data = rng.standard_normal(m)
    prior = TPrior.iid(d, sigma=1.0, dtype=torch.float64, device="cpu")
    Ht = torch.from_numpy(H)
    fwd = lambda x: x @ Ht.T
    misfit = t_misfit(fwd, torch.from_numpy(data), sigma)
    theta_map, _ = tm.find_map(misfit, prior, torch.zeros(d, dtype=torch.float64))
    lap = tm.laplace_approximation(fwd, torch.from_numpy(data), sigma, prior, theta_map)
    Cpost = np.linalg.inv(H.T @ H / sigma**2 + np.eye(d))
    mu = Cpost @ H.T @ data / sigma**2
    return misfit, prior, lap, mu, Cpost


def test_laplace_mh_near_iid_on_gaussian():
    misfit, prior, lap, mu, Cpost = _setup()
    gen = torch.Generator().manual_seed(0)
    res = ts.run_laplace_mh(misfit, prior, lap, lap.sample(gen, (16,)), gen, n_steps=2000, n_burn=100)
    assert float(res.accept_rate.mean()) > 0.98  # proposal == posterior -> alpha == 1
    s = res.samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(s.mean(0), mu, atol=0.03)
    np.testing.assert_allclose(np.cov(s.T), Cpost, atol=0.03)
    ess = float(torch.min(effective_sample_size(res.samples)))
    assert ess > 0.5 * res.samples.shape[0] * res.samples.shape[1]


def test_gpcn_accepts_everything_on_gaussian():
    misfit, prior, lap, mu, Cpost = _setup(seed=1)
    gen = torch.Generator().manual_seed(0)
    res = ts.run_gpcn(misfit, prior, lap, lap.sample(gen, (16,)), gen, n_steps=1500, n_burn=100, beta=0.7)
    np.testing.assert_allclose(res.accept_rate.numpy(), 1.0, atol=1e-12)
    np.testing.assert_allclose(res.samples.reshape(-1, 3).numpy().mean(0), mu, atol=0.05)


def test_laplace_samplers_beat_pcn_on_concentrated_posterior():
    misfit, prior, lap, mu, Cpost = _setup(sigma=0.05, seed=2)
    gen = torch.Generator().manual_seed(0)
    theta0 = lap.sample(gen, (8,))
    res_mh = ts.run_laplace_mh(misfit, prior, lap, theta0, gen, n_steps=1500, n_burn=100)
    res_pcn = run_pcn(misfit, prior, theta0, gen, n_steps=1500, n_burn=100)
    ess_mh = float(torch.min(effective_sample_size(res_mh.samples)))
    ess_pcn = float(torch.min(effective_sample_size(res_pcn.samples)))
    assert ess_mh > 3 * ess_pcn, (ess_mh, ess_pcn)


def test_laplace_mh_matches_pcn_in_ks():
    misfit, prior, lap, mu, Cpost = _setup(seed=3)
    gen = torch.Generator().manual_seed(0)
    theta0 = lap.sample(gen, (16,))
    res_mh = ts.run_laplace_mh(misfit, prior, lap, theta0, gen, n_steps=4000, n_burn=500)
    res_pcn = run_pcn(misfit, prior, theta0, gen, n_steps=8000, n_burn=2000, beta=0.5)
    d = ks_distance(res_mh.samples.reshape(-1, 3), res_pcn.samples.reshape(-1, 3)).numpy()
    assert (d < 0.06).all(), d


def test_gpcn_nonlinear_consistency():
    """On a mildly non-Gaussian target gpCN, Laplace-MH and pCN agree in
    their means (all target the same posterior)."""
    prior = TPrior.iid(2, sigma=0.8, dtype=torch.float64, device="cpu")
    data = torch.tensor([0.7, 0.1], dtype=torch.float64)
    fwd = lambda x: torch.stack([x[:, 0] + 0.3 * x[:, 1] ** 2, x[:, 1]], -1)
    misfit = t_misfit(fwd, data, 0.3)
    theta_map, _ = tm.find_map(misfit, prior, torch.zeros(2, dtype=torch.float64))
    lap = tm.laplace_approximation(fwd, data, 0.3, prior, theta_map)
    gen = torch.Generator().manual_seed(0)
    theta0 = lap.sample(gen, (32,))
    res_g = ts.run_gpcn(misfit, prior, lap, theta0, gen, n_steps=4000, n_burn=1000, beta=0.6)
    res_m = ts.run_laplace_mh(misfit, prior, lap, theta0, gen, n_steps=4000, n_burn=1000)
    res_p = run_pcn(misfit, prior, theta0, gen, n_steps=6000, n_burn=2000, beta=0.4)
    m = {k: r.samples.reshape(-1, 2).numpy().mean(0) for k, r in
         (("gpcn", res_g), ("mh", res_m), ("pcn", res_p))}
    np.testing.assert_allclose(m["gpcn"], m["mh"], atol=0.05)
    np.testing.assert_allclose(m["gpcn"], m["pcn"], atol=0.08)
    assert 0.2 < float(res_g.accept_rate.mean()) <= 1.0
