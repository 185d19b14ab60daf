"""MALA in the port (infer/mala.py) against the JAX reference.

1. Replay, in float64 on a mildly nonlinear forward with a correlated prior:
   mala_step, run_mala (burn-in adaptation, thinning, a Laplace-like
   reference frame) and run_mala_segmented (three segments) are fed the
   draws of JAX's key schedule, regenerated here from the reference's
   splits, and must give JAX's states, samples, rates and step sizes to
   1e-10. The runs are a few tens of steps: the two autodiff systems'
   gradients differ by ~1e-15 (their operation orders), and a chain's
   dynamics double such a difference every few steps on this target (from
   ~1e-15 to ~2e-10 in the gradient over 40 steps). The drift clip
   (_tamed) is held on its own, clipping and not.
2. The analytic cases of tests/test_mala.py on the port's own
   torch.Generator, at that file's tolerances: the linear-Gaussian
   posterior in the prior's frame and in a deliberately mismatched one, the
   prior with no data, MALA's ESS lead over pCN at d = 16, the segmented
   run, and the thinned shapes. The posterior and prior cases run 8x the
   reference's chains for an eighth of its kept steps (the same kept
   draws; the chains are a batch and the loop eager, so steps cost the
   time)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.infer import mala as jmala
from bayesianinferencedl_tpu.infer.pcn import gaussian_misfit as j_misfit
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu_torch.infer import mala as tmala
from bayesianinferencedl_tpu_torch.infer.diagnostics import ess_bulk
from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit as t_misfit
from bayesianinferencedl_tpu_torch.infer.pcn import run_pcn
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D = 3


def _close(t, j, tol=1e-10):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol, atol=tol)


def _close_scaled(t, j, tol=1e-10):
    """Equal to tol relative to the array's scale: the carried gradients are
    ~10 here, and an element near 0 cannot hold a relative tolerance."""
    b = np.asarray(j)
    np.testing.assert_allclose(np.asarray(t), b, rtol=tol, atol=tol * max(np.abs(b).max(), 1.0))


def _same_rate(t, j):
    """Float32 rates: the same counts over the same denominators, to the one
    float32 ulp by which XLA's product with a reciprocal and torch's
    division may differ."""
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2.0**-23, atol=0)


def _problem(sigma=0.2):
    """A mildly nonlinear batched forward, a correlated prior and a skewed,
    offset reference frame, on both sides."""
    rng = np.random.default_rng(0)
    H = rng.standard_normal((4, D))
    data = rng.standard_normal(4) * 0.5
    mean = np.array([0.1, -0.2, 0.05])
    L = np.tril(0.15 * np.ones((D, D))) + 0.6 * np.eye(D)
    A = rng.standard_normal((D, D)) * 0.3 + np.eye(D)
    ref = (rng.standard_normal(D) * 0.3, np.linalg.cholesky(A @ A.T) * 0.5)
    Hj, Ht = jnp.asarray(H), torch.from_numpy(H)
    j = dict(misfit=j_misfit(lambda t: jnp.tanh(t @ Hj.T), jnp.asarray(data), sigma),
             prior=JPrior(jnp.asarray(mean), jnp.asarray(L)),
             ref=tuple(jnp.asarray(a) for a in ref))
    t = dict(misfit=t_misfit(lambda x: torch.tanh(x @ Ht.T), torch.from_numpy(data), sigma),
             prior=TPrior(torch.from_numpy(mean), torch.from_numpy(L)),
             ref=tuple(torch.from_numpy(a) for a in ref))
    return j, t


def _step_draws(key, C):
    k_prop, k_acc = jax.random.split(key)
    return (np.array(jax.random.normal(k_prop, (C, D), jnp.float64)),
            np.array(jax.random.uniform(k_acc, (C,), jnp.float64)))


def _run_draws(key, n_steps, n_burn, C, thin=1):
    """The draws of JAX's run_mala(key): k_burn's split for burn-in, then
    k_main's for the n_out * thin kept-phase steps."""
    k_burn, k_main = jax.random.split(key)
    keys = list(jax.random.split(k_burn, n_burn)) if n_burn > 0 else []
    n_ran = (n_steps - n_burn) // thin * thin
    keys += list(jax.random.split(k_main, n_ran)) if n_ran > 0 else []
    nrm, uni = zip(*(_step_draws(k, C) for k in keys))
    return torch.from_numpy(np.stack(nrm)), torch.from_numpy(np.stack(uni))


def test_tamed_clips_only_past_the_noise_scale():
    rng = np.random.default_rng(4)
    g = rng.standard_normal((6, D)) * np.array([1.0, 10.0, 100.0, 1e3, 1e4, 0.0])[:, None]
    h = rng.uniform(0.05, 2.0, 6)
    out = tmala._tamed(torch.from_numpy(g), torch.from_numpy(h))
    _close(out, jmala._tamed(jnp.asarray(g), jnp.asarray(h)))
    norms = np.linalg.norm(out.numpy(), axis=1)
    r = 4.0 * np.sqrt(D / h)
    assert np.all(norms <= r * (1 + 1e-12)) and np.array_equal(out.numpy()[0], g[0])


def test_mala_step_replays_reference():
    j, t = _problem()
    C = 32
    rng = np.random.default_rng(1)
    theta0 = rng.normal(0.0, 0.6, (C, D))
    h = rng.uniform(0.05, 0.8, C)
    for ref_j, ref_t in ((None, None), (j["ref"], t["ref"])):
        rm, rc = ref_j if ref_j is not None else (j["prior"].mean, j["prior"].chol)
        to_theta_j, eval_j = jmala._make_nlp(j["misfit"], j["prior"], rm, rc, batched=True)
        y0 = jnp.dot(jnp.asarray(theta0) - rm, jmala._inv_chol(rc).T)
        nlp, phi, grad = eval_j(y0)
        sj = jmala.MALAState(y=y0, nlp=nlp, phi=phi, grad=grad, n_accept=jnp.zeros(C, jnp.int32))
        tm_, tc = ref_t if ref_t is not None else (t["prior"].mean, t["prior"].chol)
        _, eval_t = tmala._make_nlp(t["misfit"], t["prior"], tm_, tc)
        st = tmala.init_state(eval_t, tmala.frame(tm_, tc)[1], torch.from_numpy(theta0))
        for f in ("y", "nlp", "phi", "grad"):
            _close_scaled(getattr(st, f), getattr(sj, f))
        # the reference's step as one compiled program, not a dispatch of each primitive
        step_j = jax.jit(lambda s, k: jmala.mala_step(eval_j, jnp.asarray(h), s, k))
        for i in range(3):
            key = jax.random.PRNGKey(10 + i)
            sj, acc_j = step_j(sj, key)
            xi, u = _step_draws(key, C)
            st, acc_t = tmala.mala_step(eval_t, torch.from_numpy(h), st,
                                        normals=torch.from_numpy(xi), uniforms=torch.from_numpy(u))
            np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
            for f in ("y", "nlp", "phi", "grad", "n_accept"):
                _close_scaled(getattr(st, f), getattr(sj, f))
        assert 0 < int(st.n_accept.sum()) < 3 * C


@pytest.mark.parametrize("mode", ["prior", "laplace ref", "thin"])
def test_run_mala_replays_reference(mode):
    j, t = _problem()
    C, n_steps, n_burn = 16, 24 if mode == "thin" else 30, 12
    theta0 = np.random.default_rng(2).normal(0.0, 0.6, (C, D))
    kw = dict(n_steps=n_steps, n_burn=n_burn, step=0.3)
    jkw, tkw = dict(kw), dict(kw)
    if mode == "laplace ref":
        jkw["ref"], tkw["ref"] = j["ref"], t["ref"]
    if mode == "thin":
        jkw["thin"] = tkw["thin"] = 4
        jkw["adapt_t0"] = tkw["adapt_t0"] = 7.0
    key = jax.random.PRNGKey(3)
    rj = jmala.run_mala(j["misfit"], j["prior"], jnp.asarray(theta0), key, batched=True, **jkw)
    nrm, uni = _run_draws(key, n_steps, n_burn, C, jkw.get("thin", 1))
    rt = tmala.run_mala(t["misfit"], t["prior"], torch.from_numpy(theta0), normals=nrm, uniforms=uni,
                        **tkw)
    assert rt.samples.shape == rj.samples.shape
    for f in ("samples", "phi_trace", "step"):
        _close(getattr(rt, f), getattr(rj, f))
    for f in ("y", "nlp", "phi", "grad", "n_accept"):
        _close_scaled(getattr(rt.state, f), getattr(rj.state, f))
    _same_rate(rt.accept_rate, rj.accept_rate)
    assert not np.allclose(rt.step.numpy(), 0.3)  # burn-in adapted the step sizes


def test_run_mala_segmented_replays_reference_over_three_segments():
    j, t = _problem()
    C, n_steps, n_burn, segment = 16, 20, 6, 8  # segments 8 (6 burn-in), 8, 4
    theta0 = np.random.default_rng(5).normal(0.0, 0.6, (C, D))
    key = jax.random.PRNGKey(6)
    kw = dict(n_steps=n_steps, n_burn=n_burn, step=0.3, segment=segment, ref=None)
    rj = jmala.run_mala_segmented(j["misfit"], j["prior"], jnp.asarray(theta0), key, batched=True,
                                  **kw)
    parts, done, k = [], 0, key
    while done < n_steps:
        this = min(segment, n_steps - done)
        k, sub = jax.random.split(k)
        parts.append(_run_draws(sub, this, min(max(n_burn - done, 0), this), C))
        done += this
    nrm, uni = (torch.cat([p[i] for p in parts]) for i in range(2))
    rt = tmala.run_mala_segmented(t["misfit"], t["prior"], torch.from_numpy(theta0), normals=nrm,
                                  uniforms=uni, **kw)
    assert rt.samples.shape == (n_steps - n_burn, C, D)
    for f in ("samples", "phi_trace", "step"):
        _close(getattr(rt, f), getattr(rj, f))
    _close(rt.state.y, rj.state.y)
    _same_rate(rt.accept_rate, rj.accept_rate)


# --- the analytic cases of tests/test_mala.py --------------------------------


def _linear_gaussian(d=3, m=4, sigma=0.5, prior_sigma=1.0, seed=0):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((m, d))
    data = rng.standard_normal(m)
    prior = TPrior.iid(d, mean=0.0, sigma=prior_sigma, dtype=torch.float64, device="cpu")
    Cpost = np.linalg.inv(H.T @ H / sigma**2 + np.eye(d) / prior_sigma**2)
    mu = Cpost @ H.T @ data / sigma**2
    Ht = torch.from_numpy(H)
    return t_misfit(lambda x: x @ Ht.T, torch.from_numpy(data), sigma), prior, mu, Cpost


def test_mala_matches_analytic_posterior():
    misfit, prior, mu, Cpost = _linear_gaussian()
    gen = torch.Generator().manual_seed(0)
    res = tmala.run_mala(misfit, prior, prior.sample(gen, (512,)), gen, n_steps=875, n_burn=250)
    s = res.samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(s.mean(0), mu, atol=0.05)
    np.testing.assert_allclose(np.cov(s.T), Cpost, atol=0.06)
    assert 0.3 < float(res.accept_rate.mean()) < 0.9  # adapted toward 0.574


def test_mala_exact_under_mismatched_preconditioner():
    """A deliberately wrong whitening frame (skewed and offset) must still
    target the same posterior: the q-density correction is exact."""
    misfit, prior, mu, Cpost = _linear_gaussian()
    rng = np.random.default_rng(7)
    A = rng.standard_normal((3, 3)) * 0.4 + np.eye(3)
    ref = (torch.from_numpy(rng.standard_normal(3) * 0.5), torch.from_numpy(np.linalg.cholesky(A @ A.T)))
    gen = torch.Generator().manual_seed(2)
    res = tmala.run_mala(misfit, prior, prior.sample(gen, (512,)), gen, n_steps=940, n_burn=375,
                         ref=ref)
    s = res.samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(s.mean(0), mu, atol=0.05)
    np.testing.assert_allclose(np.cov(s.T), Cpost, atol=0.06)


def test_mala_prior_invariance_no_data():
    prior = TPrior.iid(2, mean=1.0, sigma=0.7, dtype=torch.float64, device="cpu")
    misfit = lambda x: torch.zeros(x.shape[:-1], dtype=x.dtype) * x.sum(-1)
    gen = torch.Generator().manual_seed(2)
    res = tmala.run_mala(misfit, prior, prior.sample(gen, (256,)), gen, n_steps=563, n_burn=125)
    s = res.samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(s.mean(0), 1.0, atol=0.05)
    np.testing.assert_allclose(s.std(0), 0.7, atol=0.05)


def test_mala_beats_pcn_ess_on_concentrated_posterior():
    misfit, prior, mu, Cpost = _linear_gaussian(d=16, m=24, sigma=0.1)
    gen = torch.Generator().manual_seed(0)
    theta0 = prior.sample(gen, (32,))
    res_m = tmala.run_mala(misfit, prior, theta0, gen, n_steps=3000, n_burn=1000)
    res_p = run_pcn(misfit, prior, theta0, gen, n_steps=3000, n_burn=1000)
    ess_m, ess_p = float(torch.min(ess_bulk(res_m.samples))), float(torch.min(ess_bulk(res_p.samples)))
    assert ess_m > 2.0 * ess_p, (ess_m, ess_p)


def test_mala_segmented_matches_single_run_stats():
    misfit, prior, mu, Cpost = _linear_gaussian()
    gen = torch.Generator().manual_seed(0)
    res = tmala.run_mala_segmented(misfit, prior, prior.sample(gen, (512,)), gen, n_steps=875,
                                   n_burn=250, segment=128)
    s = res.samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(s.mean(0), mu, atol=0.05)
    np.testing.assert_allclose(np.cov(s.T), Cpost, atol=0.06)
    assert res.samples.shape == (625, 512, 3)
    assert 0.3 < float(res.accept_rate.mean()) < 0.9


def test_mala_thinning_and_burnin_shapes():
    prior = TPrior.iid(2, dtype=torch.float64, device="cpu")
    misfit = lambda x: 0.5 * torch.sum(x * x, -1)
    gen = torch.Generator().manual_seed(0)
    res = tmala.run_mala(misfit, prior, prior.sample(gen, (8,)), gen, n_steps=1000, n_burn=200, thin=4)
    assert res.samples.shape == (200, 8, 2)
    assert res.phi_trace.shape == (200, 8)
