"""Gradient-informed parallel tempering in the port (infer/tempering.py
run_pt_mala) against the JAX reference; tempered DA with MALA subchains is
in test_torch_pt_da_mala.py.

1. Replay, in float64 on a mildly nonlinear forward with a correlated prior:
   run_pt_mala (burn-in, a fixed and an adaptive ladder) is fed the draws of
   JAX's key schedule, regenerated here from the reference's splits, and
   must give every field of JAX's result to 1e-10. The runs are short, as
   in test_torch_mala.py.
2. The analytic cases of tests/test_tempering.py for run_pt_mala on the
   port's own torch.Generator, at that file's tolerances: the unimodal
   linear-Gaussian posterior, the bimodal mode masses and the resume
   contract. The unimodal case runs 8x the reference's chains for an
   eighth of its kept steps, the bimodal one 4x for a quarter (the same
   kept draws; the chains are a batch and the loop eager)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.infer import tempering as jt
from bayesianinferencedl_tpu.infer.pcn import gaussian_misfit as j_misfit
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu_torch.infer import tempering as tt
from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit as t_misfit
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D = 3
PT_FIELDS = ("samples", "phi_trace", "swap_rate", "theta", "lambdas", "phi_level_mean",
             "phi2_level_mean", "ss_level_mean")


def _close(t, j, tol=1e-10):
    b = np.asarray(j)
    np.testing.assert_allclose(np.asarray(t), b, rtol=tol, atol=tol * max(np.abs(b).max(), 1.0))


def _same_rate(t, j):
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2.0**-23, atol=0)


def _problem():
    rng = np.random.default_rng(0)
    H = rng.standard_normal((4, D))
    data = rng.standard_normal(4) * 0.5
    mean = np.array([0.1, -0.2, 0.05])
    L = np.tril(0.15 * np.ones((D, D))) + 0.6 * np.eye(D)
    Hj, Ht = jnp.asarray(H), torch.from_numpy(H)
    j = dict(misfit=j_misfit(lambda t: jnp.tanh(t @ Hj.T), jnp.asarray(data), 0.3),
             coarse=j_misfit(lambda t: jnp.tanh(t @ Hj.T) + 0.1, jnp.asarray(data), 0.3),
             prior=JPrior(jnp.asarray(mean), jnp.asarray(L)))
    t = dict(misfit=t_misfit(lambda x: torch.tanh(x @ Ht.T), torch.from_numpy(data), 0.3),
             coarse=t_misfit(lambda x: torch.tanh(x @ Ht.T) + 0.1, torch.from_numpy(data), 0.3),
             prior=TPrior(torch.from_numpy(mean), torch.from_numpy(L)))
    return j, t


def _run_keys(key, n_steps, n_burn):
    k_burn, k_main = jax.random.split(key)
    keys = list(jax.random.split(k_burn, n_burn)) if n_burn > 0 else []
    return keys + list(jax.random.split(k_main, n_steps - n_burn))


def _pt_draws(key, n_steps, n_burn, K, G):
    """JAX's run_pt_mala(key) draws: per step the proposal normals, the
    acceptance uniforms and the swap uniforms (its k_prop, k_acc, k_swap)."""
    out = ([], [], [])
    for k in _run_keys(key, n_steps, n_burn):
        k_prop, k_acc, k_swap = jax.random.split(k, 3)
        out[0].append(np.array(jax.random.normal(k_prop, (K, G, D), jnp.float64)))
        out[1].append(np.array(jax.random.uniform(k_acc, (K, G), jnp.float64)))
        out[2].append(np.array(jax.random.uniform(k_swap, (K, G), jnp.float64)))
    return tuple(torch.from_numpy(np.stack(a)) for a in out)


@pytest.mark.parametrize("adapt_ladder", [False, True])
def test_run_pt_mala_replays_reference(adapt_ladder):
    j, t = _problem()
    K, G, n_steps, n_burn = 4, 8, 24, 10
    theta0 = np.random.default_rng(3).normal(0.0, 0.7, (G, D))
    kw = dict(n_steps=n_steps, n_burn=n_burn, step=0.2, n_temps=K, lambda_min=0.05,
              adapt_ladder=adapt_ladder)
    key = jax.random.PRNGKey(11)
    rj = jt.run_pt_mala(j["misfit"], j["prior"], jnp.asarray(theta0), key, batched=True, **kw)
    nrm, uni, sw = _pt_draws(key, n_steps, n_burn, K, G)
    rt = tt.run_pt_mala(t["misfit"], t["prior"], torch.from_numpy(theta0), normals=nrm, uniforms=uni,
                        swap_uniforms=sw, **kw)
    assert rt.samples.shape == (n_steps - n_burn, G, D)
    for f in PT_FIELDS + ("step",):
        _close(getattr(rt, f), getattr(rj, f))
    _same_rate(rt.accept_rate, rj.accept_rate)
    assert 0 < float(rt.swap_rate.min()) and float(rt.swap_rate.max()) < 1


# --- the analytic cases of tests/test_tempering.py ----------------------------


def _bimodal(depth):
    """Two wells at +-a (depth 0: equal wells) under N(0, 1); the fine
    model's mode mass and mean by quadrature."""
    a, s = 1.6, 0.12

    def phi(t):
        q1 = (t[..., 0] - a) ** 2 / (2 * s**2)
        q2 = (t[..., 0] + a) ** 2 / (2 * s**2) + depth
        return -torch.logsumexp(torch.stack([-q1, -q2], -1), -1)

    g = np.linspace(-4, 4, 20001)
    logp = np.logaddexp(-(g - a) ** 2 / (2 * s**2), -(g + a) ** 2 / (2 * s**2) - 0.5) - 0.5 * g**2
    w = np.exp(logp - logp.max())
    w /= w.sum()
    return phi, float(w[g > 0].sum()), float(w @ g)


def _hops(samples) -> float:
    s = samples.numpy()[..., 0]
    return float((np.sign(s[1:]) != np.sign(s[:-1])).mean())


def test_pt_mala_matches_analytic_posterior_unimodal():
    d, m, sigma = 3, 4, 0.5
    rng = np.random.default_rng(0)
    H = rng.standard_normal((m, d))
    data = rng.standard_normal(m)
    prior = TPrior.iid(d, mean=0.0, sigma=1.0, dtype=torch.float64, device="cpu")
    Cpost = np.linalg.inv(H.T @ H / sigma**2 + np.eye(d))
    mu = Cpost @ H.T @ data / sigma**2
    Ht = torch.from_numpy(H)
    misfit = t_misfit(lambda x: x @ Ht.T, torch.from_numpy(data), sigma)
    gen = torch.Generator().manual_seed(0)
    res = tt.run_pt_mala(misfit, prior, prior.sample(gen, (512,)), gen, n_steps=875, n_burn=250,
                         step=0.2, n_temps=4, lambda_min=0.1)
    s = res.samples.reshape(-1, d).numpy()
    np.testing.assert_allclose(s.mean(0), mu, atol=0.05)
    np.testing.assert_allclose(np.cov(s.T), Cpost, atol=0.06)
    acc = res.accept_rate.numpy()
    assert (np.abs(acc.mean(axis=1) - 0.574) < 0.08).all(), acc.mean(axis=1)
    assert float(res.swap_rate.min()) > 0.2


def test_pt_mala_recovers_bimodal_masses():
    misfit, mass_right, mean = _bimodal(0.5)
    prior = TPrior.iid(1, mean=0.0, sigma=1.0, dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(2)
    res = tt.run_pt_mala(misfit, prior, prior.sample(gen, (256,)), gen, n_steps=2000, n_burn=500,
                         step=0.05, n_temps=5, lambda_min=0.02)
    s = res.samples.reshape(-1).numpy()
    assert abs(float((s > 0).mean()) - mass_right) < 0.05
    assert abs(s.mean() - mean) < 0.1
    assert _hops(res.samples) > 1e-3


def test_pt_mala_resume_shape_contract():
    prior = TPrior.iid(2, dtype=torch.float64, device="cpu")
    misfit = lambda x: 0.5 * torch.sum(x * x, -1)
    gen = torch.Generator().manual_seed(0)
    res = tt.run_pt_mala(misfit, prior, prior.sample(gen, (8,)), gen, n_steps=50, n_burn=10, n_temps=3)
    assert res.theta.shape == (3, 8, 2) and res.step.shape == (3, 8)
    res2 = tt.run_pt_mala(misfit, prior, res.theta, gen, n_steps=20, n_burn=0, step=res.step, n_temps=3)
    assert res2.samples.shape == (20, 8, 2)
    with pytest.raises(ValueError, match="resumed with the ladder size"):
        tt.run_pt_mala(misfit, prior, res.theta, gen, n_steps=20, n_burn=0, n_temps=4)
