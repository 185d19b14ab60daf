"""The port's pCN sampler and diagnostics (bayesianinferencedl_tpu_torch.infer)
against the JAX reference. JAX's threefry streams and torch's generators
never agree, so the port is fed the exact normals and uniforms that the JAX
sampler draws (its key-split schedule reproduced here); given the same draws
the two chains must agree to float64 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.infer import diagnostics as jd
from bayesianinferencedl_tpu.infer import pcn as jp
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu_torch.infer import diagnostics as td
from bayesianinferencedl_tpu_torch.infer import pcn as tp
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

C, D = 32, 5
M = np.random.default_rng(0).normal(size=(D, 4))
DATA = np.array([0.3, -0.2, 0.5, 0.1])
SIGMA = 0.1


def _fwd_j(theta):  # a smooth nonlinear batched forward map, (C, d) -> (C, 4)
    return jnp.tanh(theta) @ jnp.asarray(M)


def _fwd_t(theta):
    return torch.tanh(theta) @ torch.from_numpy(M)


def _priors():
    mean = np.linspace(-0.2, 0.2, D)
    L = np.tril(0.1 * np.ones((D, D))) + 0.5 * np.eye(D)
    return (JPrior(jnp.asarray(mean), jnp.asarray(L)),
            GaussianPrior(torch.from_numpy(mean), torch.from_numpy(L)))


def _draws(key, shape_theta):
    """The normals/uniforms jax pcn_step draws from `key`."""
    k_prop, k_acc = jax.random.split(key)
    nrm = jax.random.normal(k_prop, shape_theta, jnp.float64)
    uni = jax.random.uniform(k_acc, shape_theta[:-1], jnp.float64)
    return np.asarray(nrm), np.asarray(uni)


def test_pcn_step_replays_reference():
    pj, pt = _priors()
    theta = np.random.default_rng(1).normal(0, 0.6, (C, D))
    misfit_j = jp.gaussian_misfit(_fwd_j, jnp.asarray(DATA), SIGMA)
    misfit_t = tp.gaussian_misfit(_fwd_t, torch.from_numpy(DATA), SIGMA)
    beta = np.linspace(0.05, 0.9, C)
    sj = jp.pcn_init(misfit_j, jnp.asarray(theta), batched=True)
    st = tp.pcn_init(misfit_t, torch.from_numpy(theta))
    key = jax.random.PRNGKey(4)
    for _ in range(5):
        key, sub = jax.random.split(key)
        sj, accj = jp.pcn_step(misfit_j, pj, jnp.asarray(beta), sj, sub, batched=True)
        nrm, uni = _draws(sub, (C, D))
        st, acct = tp.pcn_step(misfit_t, pt, torch.from_numpy(beta), st,
                               normals=torch.tensor(nrm), uniforms=torch.tensor(uni))
        np.testing.assert_array_equal(acct.numpy(), np.asarray(accj))
        np.testing.assert_allclose(st.theta.numpy(), np.asarray(sj.theta), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(st.phi.numpy(), np.asarray(sj.phi), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(st.n_accept.numpy(), np.asarray(sj.n_accept))


@pytest.mark.parametrize("thin", [1, 2])
def test_run_pcn_replays_reference(thin):
    n_steps, n_burn = 60, 20
    pj, pt = _priors()
    theta0 = np.random.default_rng(2).normal(0, 0.6, (C, D))
    key = jax.random.PRNGKey(9)
    misfit_j = jp.gaussian_misfit(_fwd_j, jnp.asarray(DATA), SIGMA)
    rj = jp.run_pcn(misfit_j, pj, jnp.asarray(theta0), key, n_steps=n_steps, n_burn=n_burn,
                    beta=0.25, thin=thin, batched=True)
    # jax.random schedule of run_pcn: burn keys from k_burn, kept-step keys from k_main
    k_burn, k_main = jax.random.split(key)
    keys = list(jax.random.split(k_burn, n_burn)) + list(
        jax.random.split(k_main, (n_steps - n_burn) // thin * thin))
    draws = [_draws(k, (C, D)) for k in keys]
    nrm = torch.from_numpy(np.stack([d[0] for d in draws]))
    uni = torch.from_numpy(np.stack([d[1] for d in draws]))
    misfit_t = tp.gaussian_misfit(_fwd_t, torch.from_numpy(DATA), SIGMA)
    rt = tp.run_pcn(misfit_t, pt, torch.from_numpy(theta0), n_steps=n_steps, n_burn=n_burn,
                    beta=0.25, thin=thin, normals=nrm, uniforms=uni)
    assert rt.samples.shape == ((n_steps - n_burn) // thin, C, D)
    np.testing.assert_allclose(rt.samples.numpy(), np.asarray(rj.samples), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(rt.phi_trace.numpy(), np.asarray(rj.phi_trace), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(rt.beta.numpy(), np.asarray(rj.beta), rtol=1e-9)
    np.testing.assert_allclose(rt.accept_rate.numpy(), np.asarray(rj.accept_rate), rtol=1e-6)


def test_run_pcn_draws_from_generator():
    _, pt = _priors()
    misfit_t = tp.gaussian_misfit(_fwd_t, torch.from_numpy(DATA), SIGMA)
    theta0 = torch.zeros((C, D), dtype=torch.float64)
    run = lambda seed: tp.run_pcn(misfit_t, pt, theta0, torch.Generator().manual_seed(seed),
                                  n_steps=30, n_burn=10)
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a.samples, b.samples) and not torch.equal(a.samples, c.samples)


def _chains(seed, n=200, c=8, d=3):
    """AR(1) chains with per-chain offsets: (n, c, d) float64."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, c, d))
    eps = rng.normal(size=(n, c, d))
    for t in range(1, n):
        x[t] = 0.8 * x[t - 1] + eps[t]
    return x + 0.3 * rng.normal(size=(1, c, d))


@pytest.mark.parametrize("name", ["split_rhat", "ess_bulk", "ess_tail"])
def test_diagnostics_match_reference(name):
    """Both sides rank-normalise and autocorrelate in float32 (diagnostics;
    the reference casts there), so they agree to float32 rounding, not to
    float64's: rtol 1e-5."""
    x = _chains(5)
    fj, ft = getattr(jd, name), getattr(td, name)
    a = ft(torch.from_numpy(x)).numpy()
    b = np.asarray(fj(jnp.asarray(x)))
    assert a.shape == b.shape == (3,)
    np.testing.assert_allclose(a, b, rtol=1e-5)
    # (n, c) input gives the scalar
    if name != "split_rhat":
        np.testing.assert_allclose(float(ft(torch.from_numpy(x[:, :, 0]))), b[0], rtol=1e-5)
