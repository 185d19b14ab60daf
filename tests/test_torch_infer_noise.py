"""The unknown-noise potential and pCN in segments in the port, against the
JAX reference in float64.

1. marginal_misfit, its exact constant included, equal to JAX's, and its
   refusal of an improper noise prior.
2. noise_posterior and ppc_shape_pvalue with JAX's gamma and normal draws
   injected: the same sigma draws and statistics.
3. run_pcn_segmented replayed against JAX's over three segments, and
   run_pcn's adapt_t0 replayed against JAX's run_pcn.
4. adapt_t0 advances the Robbins-Monro clock: the case of
   tests/test_pcn.py's test_adapt_t0_advances_robbins_monro_clock on the
   port's own generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.infer import pcn as jp
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu.utils import ppc as jppc
from bayesianinferencedl_tpu_torch.infer import pcn as tp
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior
from bayesianinferencedl_tpu_torch.utils import ppc as tppc

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D, M = 4, 6
H = np.random.default_rng(0).normal(size=(D, M))
DATA = np.random.default_rng(1).normal(0.5, 0.3, M)


def _fwd_j(theta):  # a smooth nonlinear batched forward map, (B, d) -> (B, m)
    return jnp.tanh(theta) @ jnp.asarray(H)


def _fwd_t(theta):
    return torch.tanh(theta) @ torch.from_numpy(H)


def _close(t, j, tol=1e-12):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol, atol=tol)


@pytest.mark.parametrize("a0,b0", [(2.0, 1e-4), (0.5, 3.0)])
def test_marginal_misfit_matches_reference(a0, b0):
    theta = np.random.default_rng(2).normal(0.0, 0.8, (16, D))
    pj = jp.marginal_misfit(_fwd_j, jnp.asarray(DATA), a0=a0, b0=b0)
    pt = tp.marginal_misfit(_fwd_t, torch.from_numpy(DATA), a0=a0, b0=b0)
    _close(pt(torch.from_numpy(theta)), pj(jnp.asarray(theta)))
    # the constant: an exact interpolant leaves (a0 + m/2) log b0 + const
    pj0 = jp.marginal_misfit(lambda t: jnp.broadcast_to(jnp.asarray(DATA), (t.shape[0], M)),
                             jnp.asarray(DATA), a0=a0, b0=b0)
    pt0 = tp.marginal_misfit(lambda t: torch.from_numpy(DATA).expand(t.shape[0], M),
                             torch.from_numpy(DATA), a0=a0, b0=b0)
    _close(pt0(torch.from_numpy(theta[:2])), pj0(jnp.asarray(theta[:2])))
    for bad in ((0.0, b0), (a0, 0.0)):
        with pytest.raises(ValueError, match="proper noise prior"):
            tp.marginal_misfit(_fwd_t, torch.from_numpy(DATA), a0=bad[0], b0=bad[1])


def _kept(seed=3, T=40, C=8):
    return np.random.default_rng(seed).normal(0.2, 0.5, (T, C, D))


@pytest.mark.parametrize("n_draws", [64, 1024])
def test_noise_posterior_matches_reference_with_injected_draws(n_draws):
    samples = _kept()
    key = jax.random.PRNGKey(4)
    sj, stats_j = jppc.noise_posterior(_fwd_j, jnp.asarray(samples), jnp.asarray(DATA), key,
                                       a0=2.0, b0=0.01, n_draws=n_draws)
    n = min(n_draws, samples.shape[0] * samples.shape[1])
    gam = np.asarray(jax.random.gamma(key, 2.0 + 0.5 * M, shape=(n,)))
    st, stats_t = tppc.noise_posterior(_fwd_t, torch.from_numpy(samples), torch.from_numpy(DATA),
                                       a0=2.0, b0=0.01, n_draws=n_draws, gammas=torch.from_numpy(gam))
    _close(st, sj)
    assert set(stats_t) == set(stats_j)
    for k in stats_j:
        _close(stats_t[k], stats_j[k])
    assert stats_t["sigma_q05"] < stats_t["sigma_q50"] < stats_t["sigma_q95"]
    # drawn from a generator: the same law's draws, finite and positive
    s_gen, _ = tppc.noise_posterior(_fwd_t, torch.from_numpy(samples), torch.from_numpy(DATA),
                                    torch.Generator().manual_seed(0), a0=2.0, b0=0.01, n_draws=n_draws)
    assert s_gen.shape == st.shape and bool(torch.all(s_gen > 0))


def test_ppc_shape_pvalue_matches_reference_with_injected_draws():
    samples = _kept(5)
    key = jax.random.PRNGKey(6)
    out_j = jppc.ppc_shape_pvalue(_fwd_j, jnp.asarray(samples), jnp.asarray(DATA), key, n_draws=200)
    z = np.asarray(jax.random.normal(key, (200, M), jnp.float64))
    out_t = tppc.ppc_shape_pvalue(_fwd_t, torch.from_numpy(samples), torch.from_numpy(DATA),
                                  n_draws=200, normals=torch.from_numpy(z))
    assert set(out_t) == set(out_j)
    for k in ("p_value", "t_obs_mean", "t_rep_mean"):
        _close(out_t[k], out_j[k])
    assert (out_t["n_draws"], out_t["n_obs"], out_t["statistic"]) == (
        out_j["n_draws"], out_j["n_obs"], out_j["statistic"])
    assert 0.0 < out_t["p_value"] < 1.0


def _priors():
    mean = np.linspace(-0.2, 0.2, D)
    L = np.tril(0.1 * np.ones((D, D))) + 0.5 * np.eye(D)
    return (JPrior(jnp.asarray(mean), jnp.asarray(L)),
            TPrior(torch.from_numpy(mean), torch.from_numpy(L)))


def _run_draws(key, n_steps, n_burn, C):
    """The draws of JAX's run_pcn(key), thin 1: pcn_step's normals and
    uniforms per step, burn-in first."""
    k_burn, k_main = jax.random.split(key)
    keys = (list(jax.random.split(k_burn, n_burn)) if n_burn > 0 else []) + list(
        jax.random.split(k_main, n_steps - n_burn))
    nrm, uni = [], []
    for k in keys:
        k_prop, k_acc = jax.random.split(k)
        nrm.append(np.asarray(jax.random.normal(k_prop, (C, D), jnp.float64)))
        uni.append(np.asarray(jax.random.uniform(k_acc, (C,), jnp.float64)))
    return torch.from_numpy(np.stack(nrm)), torch.from_numpy(np.stack(uni))


def test_run_pcn_segmented_replays_reference_over_three_segments():
    pj, pt = _priors()
    C, n_steps, n_burn, segment = 16, 20, 9, 8  # segments 8 (burn-in), 8 (1), 4 (0)
    theta0 = np.random.default_rng(7).normal(0.0, 0.6, (C, D))
    key = jax.random.PRNGKey(8)
    misfit_j = jp.marginal_misfit(_fwd_j, jnp.asarray(DATA), a0=2.0, b0=0.04)
    rj = jp.run_pcn_segmented(misfit_j, pj, jnp.asarray(theta0), key, n_steps=n_steps, n_burn=n_burn,
                              beta=0.3, segment=segment, batched=True)
    parts, done, k = [], 0, key
    while done < n_steps:
        this = min(segment, n_steps - done)
        k, sub = jax.random.split(k)
        parts.append(_run_draws(sub, this, min(max(n_burn - done, 0), this), C))
        done += this
    nrm, uni = (torch.cat([p[i] for p in parts]) for i in range(2))
    misfit_t = tp.marginal_misfit(_fwd_t, torch.from_numpy(DATA), a0=2.0, b0=0.04)
    rt = tp.run_pcn_segmented(misfit_t, pt, torch.from_numpy(theta0), n_steps=n_steps, n_burn=n_burn,
                              beta=0.3, segment=segment, normals=nrm, uniforms=uni)
    assert rt.samples.shape == (n_steps - n_burn, C, D)
    for f in ("samples", "phi_trace", "beta"):
        _close(getattr(rt, f), getattr(rj, f))
    _close(rt.state.theta, rj.state.theta)
    np.testing.assert_allclose(rt.accept_rate.numpy(), np.asarray(rj.accept_rate), rtol=2.0**-23)
    assert not np.allclose(rt.beta.numpy(), 0.3)  # burn-in adapted the step sizes


def test_run_pcn_adapt_t0_replays_reference():
    pj, pt = _priors()
    C, n_steps, n_burn = 16, 24, 12
    theta0 = np.random.default_rng(9).normal(0.0, 0.6, (C, D))
    key = jax.random.PRNGKey(10)
    misfit_j = jp.gaussian_misfit(_fwd_j, jnp.asarray(DATA), 0.2)
    rj = jp.run_pcn(misfit_j, pj, jnp.asarray(theta0), key, n_steps=n_steps, n_burn=n_burn,
                    beta=0.25, batched=True, adapt_t0=37.0)
    nrm, uni = _run_draws(key, n_steps, n_burn, C)
    rt = tp.run_pcn(tp.gaussian_misfit(_fwd_t, torch.from_numpy(DATA), 0.2), pt,
                    torch.from_numpy(theta0), n_steps=n_steps, n_burn=n_burn, beta=0.25,
                    adapt_t0=37.0, normals=nrm, uniforms=uni)
    for f in ("samples", "phi_trace", "beta"):
        _close(getattr(rt, f), getattr(rj, f))


def test_adapt_t0_advances_robbins_monro_clock():
    """A huge adapt_t0 makes eta ~ 0, so the betas stay at their start,
    while the default clock moves them substantially."""
    prior = TPrior.iid(2, dtype=torch.float64, device="cpu")
    misfit = lambda t: 50.0 * torch.sum(t * t, -1)  # concentrated: beta must shrink
    theta0 = prior.sample(torch.Generator().manual_seed(0), (16,))
    run = lambda t0: tp.run_pcn(misfit, prior, theta0, torch.Generator().manual_seed(1), n_steps=300,
                                n_burn=250, beta=0.5, adapt_t0=t0)
    moved = float(torch.mean(torch.abs(torch.log(run(0.0).beta) - np.log(0.5))))
    frozen = float(torch.mean(torch.abs(torch.log(run(1e12).beta) - np.log(0.5))))
    assert moved > 0.1  # the fresh clock adapts
    assert frozen < 0.1 * moved  # a late clock (eta ~ 0) barely does
