"""Delayed-acceptance pCN in the port (infer/delayed_acceptance.py with
infer/segmented.py) against the JAX reference, in float64 on a
linear-Gaussian problem (d = 3) like the reference's own tests.

1. Replay: the port's da_step, run_da_pcn (burn-in adaptation included) and
   run_da_pcn_segmented (3 segments) are fed the draws JAX's key schedule
   gives, regenerated here from the reference's splits, and must reproduce
   JAX's states, samples, rates and betas to 1e-12.
2. Exactness: with a biased coarse model, the port's DA under a
   torch.Generator lands on the analytic fine posterior, to the tolerances
   of the reference's test_da_corrects_biased_coarse_to_fine_posterior.
3. MALA subchains (make_inner_kernel("mala")): da_step and
   run_da_pcn_segmented on JAX's draws, to 1e-10.
4. An unknown inner kernel and a degenerate likelihood == da_coarse
   raise."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.infer import GaussianPrior as JPrior
from bayesianinferencedl_tpu.infer import delayed_acceptance as jda
from bayesianinferencedl_tpu.infer.pcn import gaussian_misfit as j_misfit
from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch import config as tcfg
from bayesianinferencedl_tpu_torch.infer import delayed_acceptance as tda
from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit as t_misfit
from bayesianinferencedl_tpu_torch.infer.pcn import run_pcn
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D, M, SIGMA = 3, 4, 0.5
BIAS = np.array([0.4, -0.3, 0.2, 0.1])


def _problem(seed=0):
    """H, data, the analytic fine posterior (mu, Cpost), and the fine and
    biased coarse misfits on both sides (batched over chains)."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((M, D))
    data = rng.standard_normal(M)
    Cpost = np.linalg.inv(H.T @ H / SIGMA**2 + np.eye(D))
    mu = Cpost @ H.T @ data / SIGMA**2
    Hj, dj, bj = jnp.asarray(H), jnp.asarray(data), jnp.asarray(BIAS)
    Ht, dt, bt = torch.tensor(H), torch.tensor(data), torch.tensor(BIAS)
    j = dict(fine=j_misfit(lambda t: t @ Hj.T, dj, SIGMA),
             coarse=j_misfit(lambda t: t @ Hj.T + bj, dj, SIGMA),
             prior=JPrior.iid(D, mean=0.0, sigma=1.0, dtype=jnp.float64))
    t = dict(fine=t_misfit(lambda x: x @ Ht.T, dt, SIGMA),
             coarse=t_misfit(lambda x: x @ Ht.T + bt, dt, SIGMA),
             prior=TPrior.iid(D, mean=0.0, sigma=1.0, dtype=torch.float64, device="cpu"))
    return j, t, mu, Cpost


def _step_draws(key, subchain, C):
    """The draws of JAX's da_step(key): per inner step pcn_step's normals and
    uniform (its k_prop, k_acc split), then the outer uniform."""
    k_sub, k_acc = jax.random.split(key)
    nrm, uni = [], []
    for k in jax.random.split(k_sub, subchain):
        k_prop, k_u = jax.random.split(k)
        nrm.append(np.asarray(jax.random.normal(k_prop, (C, D), jnp.float64)))
        uni.append(np.asarray(jax.random.uniform(k_u, (C,), jnp.float64)))
    return np.stack(nrm), np.stack(uni), np.asarray(jax.random.uniform(k_acc, (C,), jnp.float64))


def _run_draws(key, n_steps, n_burn, subchain, C):
    """The draws of JAX's run_da_pcn(key), outer steps in order (burn-in
    first): (normals, uniforms, outer uniforms)."""
    k_burn, k_main = jax.random.split(key)
    keys = list(jax.random.split(k_burn, n_burn)) if n_burn > 0 else []
    keys += list(jax.random.split(k_main, n_steps - n_burn))
    steps = [_step_draws(k, subchain, C) for k in keys]
    return tuple(torch.tensor(np.stack([s[i] for s in steps])) for i in range(3))


def _segmented_draws(key, n_steps, n_burn, segment, subchain, C):
    """The draws of JAX's run_da_pcn_segmented(key): drive_segments splits
    one key per segment."""
    parts, done = [], 0
    while done < n_steps:
        this = min(segment, n_steps - done)
        key, sub = jax.random.split(key)
        parts.append(_run_draws(sub, this, min(max(n_burn - done, 0), this), subchain, C))
        done += this
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def _close(t, j, tol=1e-12):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol, atol=tol)


def _same_rate(t, j):
    """Float32 rates: the same counts over the same denominators. XLA divides
    by a constant as a product with its reciprocal, one float32 ulp from
    torch's division, so they agree to that ulp."""
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2.0**-23, atol=0)


def test_da_step_replays_reference():
    j, t, _, _ = _problem()
    C, S = 8, 5
    theta0 = np.random.default_rng(1).normal(0.0, 1.0, (C, D))
    beta = np.linspace(0.2, 0.6, C)
    key = jax.random.PRNGKey(3)
    js = jda.da_init(j["fine"], j["coarse"], jnp.asarray(theta0), batched_fine=True, batched_coarse=True)
    jk = jda.pcn_inner_kernel(j["coarse"], j["prior"], batched=True)
    jnew, jacc, jinner = jda.da_step(j["fine"], jk, jnp.asarray(beta), S, js, key, batched_fine=True)
    ts = tda.da_init(t["fine"], t["coarse"], torch.tensor(theta0))
    tk = tda.make_inner_kernel("pcn", t["coarse"], t["prior"])
    nrm, uni, out = _step_draws(key, S, C)
    tnew, tacc, tinner = tda.da_step(t["fine"], tk, torch.tensor(beta), S, ts, normals=torch.tensor(nrm),
                                     uniforms=torch.tensor(uni), outer_uniform=torch.tensor(out))
    for f in ("theta", "phi_f", "phi_c"):
        _close(getattr(tnew, f), getattr(jnew, f))
    np.testing.assert_array_equal(tnew.n_accept.numpy(), np.asarray(jnew.n_accept))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(tinner.numpy(), np.asarray(jinner))
    assert 0 < int(tacc.sum()) < C  # the biased coarse model makes the correction bite


def test_run_da_pcn_replays_reference_through_burn_in():
    j, t, _, _ = _problem()
    C, S, n_steps, n_burn = 16, 3, 14, 6
    theta0 = np.random.default_rng(2).normal(0.0, 1.0, (C, D))
    key = jax.random.PRNGKey(7)
    rj = jda.run_da_pcn(j["fine"], j["coarse"], j["prior"], jnp.asarray(theta0), key, n_steps=n_steps,
                        n_burn=n_burn, beta=0.4, subchain=S, batched_fine=True, batched_coarse=True)
    nrm, uni, out = _run_draws(key, n_steps, n_burn, S, C)
    rt = tda.run_da_pcn(t["fine"], t["coarse"], t["prior"], torch.tensor(theta0), n_steps=n_steps,
                        n_burn=n_burn, beta=0.4, subchain=S, normals=nrm, uniforms=uni,
                        outer_uniforms=out)
    assert rt.samples.shape == (n_steps - n_burn, C, D)
    for f in ("samples", "phi_trace", "beta"):
        _close(getattr(rt, f), getattr(rj, f))
    for f in ("accept_rate", "inner_accept_rate"):
        _same_rate(getattr(rt, f), getattr(rj, f))
    assert rt.n_fine_evals == rj.n_fine_evals == n_steps + 1
    assert not np.allclose(rt.beta.numpy(), 0.4)  # burn-in adapted the step sizes


def test_run_da_pcn_segmented_replays_reference_over_three_segments():
    j, t, _, _ = _problem()
    C, S, n_steps, n_burn, segment = 16, 3, 10, 5, 4  # segments of 4 (all burn-in), 4 (1), 2 (0)
    theta0 = np.random.default_rng(4).normal(0.0, 1.0, (C, D))
    key = jax.random.PRNGKey(9)
    rj = jda.run_da_pcn_segmented(j["fine"], j["coarse"], j["prior"], jnp.asarray(theta0), key,
                                  n_steps=n_steps, n_burn=n_burn, beta=0.4, subchain=S,
                                  segment=segment, batched_fine=True, batched_coarse=True)
    nrm, uni, out = _segmented_draws(key, n_steps, n_burn, segment, S, C)
    rt = tda.run_da_pcn_segmented(t["fine"], t["coarse"], t["prior"], torch.tensor(theta0),
                                  n_steps=n_steps, n_burn=n_burn, beta=0.4, subchain=S,
                                  segment=segment, normals=nrm, uniforms=uni, outer_uniforms=out)
    assert rt.samples.shape == (n_steps - n_burn, C, D)
    for f in ("samples", "phi_trace", "beta"):
        _close(getattr(rt, f), getattr(rj, f))
    _same_rate(rt.accept_rate, rj.accept_rate)
    _same_rate(rt.inner_accept_rate, rj.inner_accept_rate)
    assert rt.n_fine_evals == rj.n_fine_evals == n_steps + 3


def test_da_corrects_biased_coarse_to_fine_posterior():
    """The reference test's tolerances and kept draws (8x its chains for an
    eighth of its kept steps), on the port's own draws."""
    _, t, mu, Cpost = _problem()
    gen = torch.Generator().manual_seed(0)
    theta0 = t["prior"].sample(gen, (512,))
    res = tda.run_da_pcn(t["fine"], t["coarse"], t["prior"], theta0, gen, n_steps=875, n_burn=250,
                         beta=0.4, subchain=4)
    samples = res.samples.reshape(-1, D).numpy()
    np.testing.assert_allclose(samples.mean(0), mu, atol=0.06)
    np.testing.assert_allclose(np.cov(samples.T), Cpost, atol=0.08)
    # the coarse posterior is elsewhere: pCN on it disagrees
    res_c = run_pcn(t["coarse"], t["prior"], theta0, gen, n_steps=625, n_burn=250, beta=0.4)
    assert np.linalg.norm(res_c.samples.reshape(-1, D).numpy().mean(0) - mu) > 0.15
    assert 0.2 < float(res.accept_rate.mean()) < 0.999


def test_mala_inner_da_step_replays_reference():
    """MALA subchains in da_step, single-level (the tempered kernel is
    replayed through run_pt_da in test_torch_tempering.py)."""
    j, t, _, _ = _problem()
    C, S = 8, 5
    theta0 = np.random.default_rng(1).normal(0.0, 1.0, (C, D))
    h = np.linspace(0.1, 0.5, C)
    key = jax.random.PRNGKey(3)
    js = jda.da_init(j["fine"], j["coarse"], jnp.asarray(theta0), batched_fine=True, batched_coarse=True)
    jk = jda.make_inner_kernel("mala", j["coarse"], j["prior"], batched=True)
    jnew, jacc, jinner = jda.da_step(j["fine"], jk, jnp.asarray(h), S, js, key, batched_fine=True)
    ts = tda.da_init(t["fine"], t["coarse"], torch.tensor(theta0))
    tk = tda.make_inner_kernel("mala", t["coarse"], t["prior"])
    assert tk.target == 0.574
    nrm, uni, out = _step_draws(key, S, C)
    tnew, tacc, tinner = tda.da_step(t["fine"], tk, torch.tensor(h), S, ts, normals=torch.tensor(nrm),
                                     uniforms=torch.tensor(uni), outer_uniform=torch.tensor(out))
    for f in ("theta", "phi_f", "phi_c"):
        _close(getattr(tnew, f), getattr(jnew, f), 1e-10)
    np.testing.assert_array_equal(tnew.n_accept.numpy(), np.asarray(jnew.n_accept))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(tinner.numpy(), np.asarray(jinner))
    assert 0 < int(tinner.sum()) < S * C


def test_run_da_pcn_mala_inner_replays_reference_over_three_segments():
    """run_da_pcn_segmented with MALA subchains: burn-in over two segments,
    each starting the outer-acceptance EMA afresh as the reference's does,
    the step sizes h adapted by the inner-rate rule with its collapse
    penalty and clipped to [1e-8, 10]."""
    j, t, _, _ = _problem()
    C, S, n_steps, n_burn, segment = 16, 3, 10, 6, 4  # segments of 4 (all burn-in), 4 (2), 2 (0)
    theta0 = np.random.default_rng(4).normal(0.0, 1.0, (C, D))
    key = jax.random.PRNGKey(9)
    kw = dict(n_steps=n_steps, n_burn=n_burn, beta=0.3, subchain=S, segment=segment, inner="mala")
    rj = jda.run_da_pcn_segmented(j["fine"], j["coarse"], j["prior"], jnp.asarray(theta0), key,
                                  batched_fine=True, batched_coarse=True, **kw)
    nrm, uni, out = _segmented_draws(key, n_steps, n_burn, segment, S, C)
    rt = tda.run_da_pcn_segmented(t["fine"], t["coarse"], t["prior"], torch.tensor(theta0), normals=nrm,
                                  uniforms=uni, outer_uniforms=out, **kw)
    assert rt.samples.shape == (n_steps - n_burn, C, D)
    for f in ("samples", "phi_trace", "beta"):
        _close(getattr(rt, f), getattr(rj, f), 1e-10)
    _same_rate(rt.accept_rate, rj.accept_rate)
    _same_rate(rt.inner_accept_rate, rj.inner_accept_rate)
    assert not np.allclose(rt.beta.numpy(), 0.3)  # burn-in adapted the step sizes


def test_unported_and_degenerate_options_raise():
    _, t, _, _ = _problem()
    with pytest.raises(ValueError, match="unknown"):
        tda.make_inner_kernel("hmc", t["coarse"], t["prior"])
    # likelihood == da_coarse: rejected before anything is built or solved
    stub = SimpleNamespace(config=tcfg.PipelineConfig(
        mcmc=tcfg.MCMCConfig(sampler="da_pcn", likelihood="rom_nn", da_coarse="rom_nn")))
    with pytest.raises(ValueError, match="degenerate"):
        api.run_inversion(stub)
