"""HMC in the port (infer/hmc.py) against the JAX reference.

1. Replay, in float64 on a mildly nonlinear forward with a correlated prior
   and a reference frame: hmc_step, run_hmc (burn-in adaptation),
   run_hmc_segmented (three segments), _chees_probe and run_hmc_chees (the
   n_leap it picks, its probe table and its kept run) are fed the draws of
   JAX's key schedule, regenerated here from the reference's splits (the
   momenta, the jitter draws in [-1, 1) and the acceptance uniforms), and
   must give JAX's results to 1e-10 (the carried gradients relative to
   their scale). The runs are short for the reason test_torch_mala.py
   gives: rounding differences of ~1e-15 grow along a chain.
2. tests/test_hmc.py's ChEES case on the port's own torch.Generator, at
   its tolerances: the interior pick on an anisotropic posterior and the
   kept run's moments (2,048 chains, 500 trajectories, 250 burn-in: 512k
   kept draws, where 700 / 300 kept 819k). Its other analytic cases are in
   test_torch_hmc_analytic.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.infer import hmc as jhmc
from bayesianinferencedl_tpu.infer import mala as jmala
from bayesianinferencedl_tpu.infer.pcn import gaussian_misfit as j_misfit
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu_torch.infer import hmc as thmc
from bayesianinferencedl_tpu_torch.infer import mala as tmala
from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit as t_misfit
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D = 3
STATE = ("y", "nlp", "phi", "grad", "n_accept")


def _close(t, j, tol=1e-10):
    b = np.asarray(j)
    np.testing.assert_allclose(np.asarray(t), b, rtol=tol, atol=tol * max(np.abs(b).max(), 1.0))


def _same_rate(t, j):
    """Float32 rates to the one ulp by which XLA's product with a reciprocal
    and torch's division may differ."""
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2.0**-23, atol=0)


def _problem():
    rng = np.random.default_rng(0)
    H = rng.standard_normal((4, D))
    data = rng.standard_normal(4) * 0.5
    mean = np.array([0.1, -0.2, 0.05])
    L = np.tril(0.15 * np.ones((D, D))) + 0.6 * np.eye(D)
    A = rng.standard_normal((D, D)) * 0.3 + np.eye(D)
    ref = (rng.standard_normal(D) * 0.3, np.linalg.cholesky(A @ A.T) * 0.5)
    Hj, Ht = jnp.asarray(H), torch.from_numpy(H)
    j = dict(misfit=j_misfit(lambda t: jnp.tanh(t @ Hj.T), jnp.asarray(data), 0.3),
             prior=JPrior(jnp.asarray(mean), jnp.asarray(L)), ref=tuple(jnp.asarray(a) for a in ref))
    t = dict(misfit=t_misfit(lambda x: torch.tanh(x @ Ht.T), torch.from_numpy(data), 0.3),
             prior=TPrior(torch.from_numpy(mean), torch.from_numpy(L)),
             ref=tuple(torch.from_numpy(a) for a in ref))
    return j, t


def _step_draws(key, C):
    """One hmc_step(key)'s draws: the momenta (k_mom), the jitter in [-1, 1)
    (k_jit) and the acceptance uniforms (k_acc)."""
    k_mom, k_jit, k_acc = jax.random.split(key, 3)
    return (np.array(jax.random.normal(k_mom, (C, D), jnp.float64)),
            np.array(jax.random.uniform(k_jit, (C,), jnp.float64, minval=-1.0, maxval=1.0)),
            np.array(jax.random.uniform(k_acc, (C,), jnp.float64)))


def _stack(keys, C):
    cols = zip(*(_step_draws(k, C) for k in keys))
    return {n: torch.from_numpy(np.stack(a)) for n, a in zip(("normals", "jitters", "uniforms"), cols)}


def _run_keys(key, n_steps, n_burn):
    k_burn, k_main = jax.random.split(key)
    keys = list(jax.random.split(k_burn, n_burn)) if n_burn > 0 else []
    return keys + (list(jax.random.split(k_main, n_steps - n_burn)) if n_steps > n_burn else [])


def _probe_keys(key, n_adapt, n_meas):
    k_adapt, k_meas = jax.random.split(key)
    return list(jax.random.split(k_adapt, n_adapt)) + list(jax.random.split(k_meas, n_meas))


def _states(j, t, theta0, ref=True):
    rm, rc = j["ref"] if ref else (j["prior"].mean, j["prior"].chol)
    _, eval_j = jmala._make_nlp(j["misfit"], j["prior"], rm, rc, batched=True)
    y0 = jnp.dot(jnp.asarray(theta0) - rm, jmala._inv_chol(rc).T)
    nlp, phi, grad = eval_j(y0)
    sj = jmala.MALAState(y=y0, nlp=nlp, phi=phi, grad=grad, n_accept=jnp.zeros(len(theta0), jnp.int32))
    tm_, tc = t["ref"] if ref else (t["prior"].mean, t["prior"].chol)
    _, eval_t = tmala._make_nlp(t["misfit"], t["prior"], tm_, tc)
    st = tmala.init_state(eval_t, tmala.frame(tm_, tc)[1], torch.from_numpy(theta0))
    return (sj, eval_j), (st, eval_t)


def test_hmc_step_replays_reference():
    j, t = _problem()
    C = 32
    rng = np.random.default_rng(1)
    theta0 = rng.normal(0.0, 0.6, (C, D))
    h = rng.uniform(0.05, 0.6, C)
    (sj, eval_j), (st, eval_t) = _states(j, t, theta0)
    # the reference's step as one compiled program, not a dispatch of each primitive
    step_j = jax.jit(lambda s, k: jhmc.hmc_step(eval_j, jnp.asarray(h), 5, 0.2, s, k))
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        sj, acc_j = step_j(sj, key)
        nrm, jit, uni = _step_draws(key, C)
        st, acc_t = thmc.hmc_step(eval_t, torch.from_numpy(h), 5, 0.2, st, normals=torch.from_numpy(nrm),
                                  jitters=torch.from_numpy(jit), uniforms=torch.from_numpy(uni))
        np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
        for f in STATE:
            _close(getattr(st, f), getattr(sj, f))
    assert 0 < int(st.n_accept.sum()) < 3 * C


@pytest.mark.parametrize("segmented", [False, True])
def test_run_hmc_replays_reference(segmented):
    j, t = _problem()
    C, n_steps, n_burn, L = 16, 14, 6, 4
    theta0 = np.random.default_rng(2).normal(0.0, 0.6, (C, D))
    key = jax.random.PRNGKey(4)
    kw = dict(n_steps=n_steps, n_burn=n_burn, step=0.2, n_leap=L, jitter=0.2)
    if segmented:  # segments of 6 (burn-in), 6 and 2
        rj = jhmc.run_hmc_segmented(j["misfit"], j["prior"], jnp.asarray(theta0), key, batched=True,
                                    segment=6, ref=j["ref"], **kw)
        keys, done, k = [], 0, key
        while done < n_steps:
            this = min(6, n_steps - done)
            k, sub = jax.random.split(k)
            keys += _run_keys(sub, this, min(max(n_burn - done, 0), this))
            done += this
        rt = thmc.run_hmc_segmented(t["misfit"], t["prior"], torch.from_numpy(theta0), segment=6,
                                    ref=t["ref"], **kw, **_stack(keys, C))
    else:
        rj = jhmc.run_hmc(j["misfit"], j["prior"], jnp.asarray(theta0), key, batched=True, ref=j["ref"],
                          **kw)
        rt = thmc.run_hmc(t["misfit"], t["prior"], torch.from_numpy(theta0), ref=t["ref"], **kw,
                          **_stack(_run_keys(key, n_steps, n_burn), C))
    assert rt.samples.shape == (n_steps - n_burn, C, D)
    for f in ("samples", "phi_trace", "step"):
        _close(getattr(rt, f), getattr(rj, f))
    for f in STATE:
        _close(getattr(rt.state, f), getattr(rj.state, f))
    _same_rate(rt.accept_rate, rj.accept_rate)


def test_chees_probe_and_pick_replay_reference():
    j, t = _problem()
    C, n_adapt, n_meas = 24, 3, 3
    cands = (1, 2, 4)
    theta0 = np.random.default_rng(3).normal(0.0, 0.6, (C, D))
    # one probe on its own, from a prepared state
    (sj, _), (st, _) = _states(j, t, theta0, ref=False)
    log_h = np.log(np.random.default_rng(4).uniform(0.1, 0.5, C))
    key = jax.random.PRNGKey(6)
    pj = jhmc._chees_probe(j["misfit"], j["prior"], j["prior"].mean, j["prior"].chol, sj,
                           jnp.asarray(log_h), jnp.asarray(9.0), key, n_leap=2, jitter=0.2,
                           n_adapt=n_adapt, n_meas=n_meas, batched=True)
    pt = thmc._chees_probe(t["misfit"], t["prior"], t["prior"].mean, t["prior"].chol, st,
                           torch.from_numpy(log_h), 9.0, n_leap=2, jitter=0.2, n_adapt=n_adapt,
                           n_meas=n_meas, **_stack(_probe_keys(key, n_adapt, n_meas), C))
    for f in STATE:
        _close(getattr(pt[0], f), getattr(pj[0], f))
    _close(pt[1], pj[1])
    _close(pt[2], pj[2])
    _close(pt[3], pj[3])
    # the whole auto run: the pick, the probe table and the kept run
    n_steps, n_burn = 24, 16  # pre = 8 at the median candidate, tail burn-in 8, 8 kept
    key = jax.random.PRNGKey(7)
    kw = dict(n_steps=n_steps, n_burn=n_burn, step=0.2, leap_candidates=cands, jitter=0.2,
              n_adapt=n_adapt, n_meas=n_meas)
    rj, info_j = jhmc.run_hmc_chees(j["misfit"], j["prior"], jnp.asarray(theta0), key, batched=True, **kw)
    k_pre, k_probe, k_main = jax.random.split(key, 3)
    draws = {"pre": _stack(_run_keys(k_pre, 8, 8), C),
             "probes": [_stack(_probe_keys(jax.random.fold_in(k_probe, i), n_adapt, n_meas), C)
                        for i in range(len(cands))],
             "main": _stack(_run_keys(k_main, 16, 8), C)}
    rt, info_t = thmc.run_hmc_chees(t["misfit"], t["prior"], torch.from_numpy(theta0), draws=draws, **kw)
    assert info_t["n_leap"] == info_j["n_leap"] and info_t["candidates"] == list(cands)
    _close(info_t["chees_per_grad"], info_j["chees_per_grad"])
    _close(info_t["accept"], info_j["accept"])
    _close(rt.samples, rj.samples)
    _close(rt.step, rj.step)


def test_run_hmc_refuses_zero_leapfrog_steps():
    _, t = _problem()
    with pytest.raises(ValueError, match="n_leap=0"):
        thmc.run_hmc(t["misfit"], t["prior"], torch.zeros(4, D, dtype=torch.float64), n_steps=2, n_leap=0)


# --- the analytic ChEES case of tests/test_hmc.py (the others: test_torch_hmc_analytic.py)


def test_hmc_chees_auto_trajectory():
    """On an anisotropic linear-Gaussian posterior (condition ~30) the
    probe table has an interior maximum and the production run at the
    winner matches the analytic posterior."""
    d = 8
    rng = np.random.default_rng(0)
    A = rng.standard_normal((d, d)) * np.geomspace(1.0, 30.0, d)[None, :]
    sigma = 0.5
    prior = TPrior.iid(d, sigma=1.0, dtype=torch.float64, device="cpu")
    data = rng.standard_normal(d)
    Cpost = np.linalg.inv(A.T @ A / sigma**2 + np.eye(d))
    mu = Cpost @ A.T @ data / sigma**2
    At, dt = torch.from_numpy(A), torch.from_numpy(data)

    def misfit(th):
        r = th @ At.T - dt
        return 0.5 / sigma**2 * torch.sum(r * r, -1)

    gen = torch.Generator().manual_seed(1)
    res, info = thmc.run_hmc_chees(misfit, prior, prior.sample(gen, (2048,)), gen, n_steps=500,
                                   n_burn=250, step=0.1)
    assert 1 < info["n_leap"] < info["candidates"][-1], info
    cpg = info["chees_per_grad"]
    assert cpg[info["candidates"].index(info["n_leap"])] >= max(cpg[0], cpg[-1])
    s = res.samples.reshape(-1, d).numpy()
    np.testing.assert_allclose(s.mean(0), mu, atol=0.05)
    np.testing.assert_allclose(s.std(0), np.sqrt(np.diag(Cpost)), atol=0.05)
    assert float(res.accept_rate.mean()) > 0.4
