"""Adaptive tempered SMC in the port (infer/smc.py) against the JAX
reference, in float64.

1. _ess_frac, _next_lambda (32 bisection steps) and _systematic_resample
   (its float cumsum and clip) on seeded inputs, to 1e-10 and index for
   index.
2. Replay: run_smc on the draws of JAX's key schedule (k_init, k_loop; per
   stage k_res, k_mut; per mutation k_prop, k_acc), regenerated here and
   injected: every field of JAX's result to 1e-10.
3. The groups are one population: a batch of G groups on the draws of G
   JAX keys equals, group for group, G single-population runs of the port
   and JAX's runs, although the groups finish at different stages.
4. The analytic cases of tests/test_smc.py on the port's own
   torch.Generator, at that file's tolerances: the linear-Gaussian evidence
   and moments, the bimodal mode mass and evidence, and SMC against the PT
   stepping-stone estimate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.infer import smc as jsm
from bayesianinferencedl_tpu.infer.pcn import gaussian_misfit as j_misfit
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu_torch.infer import smc as tsm
from bayesianinferencedl_tpu_torch.infer.evidence import log_evidence_from_pt
from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit as t_misfit
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior
from bayesianinferencedl_tpu_torch.infer.tempering import run_pt_pcn

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

N, MUT, STAGES = 256, 2, 16
FIELDS = ("particles", "phi", "log_evidence", "n_stages", "lambdas", "ess_frac", "accept_rate", "beta")


def _linear_gaussian():
    """tests/test_smc.py's problem: both sides' batched misfits and priors,
    the analytic log evidence, posterior mean and covariance."""
    d, m, sigma, sp = 3, 4, 0.5, 1.0
    rng = np.random.default_rng(0)
    H, data = rng.standard_normal((m, d)), rng.standard_normal(m)
    S = sp**2 * H @ H.T + sigma**2 * np.eye(m)
    log_z = m * np.log(sigma) - 0.5 * np.linalg.slogdet(S)[1] - 0.5 * data @ np.linalg.solve(S, data)
    P = np.linalg.inv(np.eye(d) / sp**2 + H.T @ H / sigma**2)
    mu = P @ (H.T @ data) / sigma**2
    Hj, Ht = jnp.asarray(H), torch.tensor(H)
    jm = j_misfit(lambda t: t @ Hj.T, jnp.asarray(data), sigma)
    tm = t_misfit(lambda t: t @ Ht.T, torch.tensor(data), sigma)
    return (jm, tm, JPrior.iid(d, sigma=sp, dtype=jnp.float64),
            TPrior.iid(d, sigma=sp, dtype=torch.float64, device="cpu"), float(log_z), mu, P)


def _jax_draws(key, jprior, n, d, n_mut, max_stages):
    """JAX's draws for one population: the initial particles, then per stage
    the resampling uniform and per mutation the normals and uniforms."""
    k_init, key = jax.random.split(key)
    theta0 = np.asarray(jprior.sample(k_init, (n,)))
    us, zs, uus = [], [], []
    for _ in range(max_stages):
        key, k_res, k_mut = jax.random.split(key, 3)
        us.append(float(jax.random.uniform(k_res, (), jnp.float64)))
        z, uu = [], []
        for kk in jax.random.split(k_mut, n_mut):
            k_prop, k_acc = jax.random.split(kk)
            z.append(np.asarray(jax.random.normal(k_prop, (n, d), jnp.float64)))
            uu.append(np.asarray(jax.random.uniform(k_acc, (n,), jnp.float64)))
        zs.append(z)
        uus.append(uu)
    return theta0, np.array(us), np.array(zs), np.array(uus)


def _inject(draws_per_group):
    """Stack groups' draws in run_smc's layout: theta0 (G, N, d),
    resample_uniforms (S, G), normals (S, MUT, G, N, d), uniforms (S, MUT, G, N)."""
    th, u, z, uu = zip(*draws_per_group)
    return dict(theta0=torch.tensor(np.stack(th)), resample_uniforms=torch.tensor(np.stack(u, 1)),
                normals=torch.tensor(np.stack(z, 2)), uniforms=torch.tensor(np.stack(uu, 2)))


def _jax_smc(jm, jprior, key, n=N):
    return jsm.run_smc(jm, jprior, key, n_particles=n, n_mutations=MUT, max_stages=STAGES, batched=True)


def _same(t, j, g=0):
    """Port result group g against a JAX single-population result."""
    for f in FIELDS:
        tv = getattr(t, f)
        tv = tv[:, g] if f in ("lambdas", "ess_frac", "accept_rate") else tv[g]
        np.testing.assert_allclose(tv.numpy(), np.asarray(getattr(j, f)), rtol=1e-10, atol=1e-10,
                                   err_msg=f)


@pytest.mark.parametrize("target", [0.3, 0.5, 0.8])
def test_stage_helpers_match_reference(target):
    rng = np.random.default_rng(int(target * 10))
    phi = rng.gamma(2.0, 30.0, 512)
    for lam in (0.0, 0.01, 0.3):
        lt = tsm._next_lambda(torch.tensor(lam, dtype=torch.float64), torch.tensor(phi), target)
        lj = jsm._next_lambda(jnp.asarray(lam), jnp.asarray(phi), target)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-12)
        log_inc = -(float(lt) - lam) * phi
        np.testing.assert_allclose(float(tsm._ess_frac(torch.tensor(log_inc))),
                                   float(jsm._ess_frac(jnp.asarray(log_inc))), rtol=1e-12)
        key = jax.random.PRNGKey(int(lam * 100))
        u = jax.random.uniform(key, (), jnp.float64)
        idx_t = tsm._systematic_resample(torch.tensor(float(u), dtype=torch.float64),
                                         torch.tensor(log_inc))
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(jsm._systematic_resample(key, jnp.asarray(log_inc))))


def test_resample_clips_a_short_cumsum():
    """A float cumsum that ends below 1 would put the last positions past the
    end; the clip keeps them on the last particle, as the reference does."""
    log_w = torch.log(torch.tensor([0.25, 0.25, 0.25, 0.25 - 1e-9], dtype=torch.float64))
    idx = tsm._systematic_resample(torch.tensor(0.999999999, dtype=torch.float64), log_w)
    assert idx.tolist() == [0, 1, 2, 3]


def test_run_smc_replays_reference():
    jm, tm, jprior, tprior, *_ = _linear_gaussian()
    key = jax.random.PRNGKey(3)
    rj = _jax_smc(jm, jprior, key)
    rt = tsm.run_smc(tm, tprior, n_particles=N, n_mutations=MUT, max_stages=STAGES,
                     **_inject([_jax_draws(key, jprior, N, 3, MUT, STAGES)]))
    assert 1 < int(rj.n_stages) < STAGES
    _same(rt, rj)


def test_groups_batch_equals_single_runs():
    """Three groups in one batch against three single runs (the port's and
    JAX's), on a sharper misfit where the groups' stage counts differ."""
    _, _, jprior, tprior, *_ = _linear_gaussian()
    H = np.random.default_rng(7).standard_normal((4, 3))
    data = np.random.default_rng(8).standard_normal(4)
    jm = j_misfit(lambda t: jnp.tanh(t) @ jnp.asarray(H).T, jnp.asarray(data), 0.03)
    tm = t_misfit(lambda t: torch.tanh(t) @ torch.tensor(H).T, torch.tensor(data), 0.03)
    calls = []
    counted = lambda th: (calls.append(th.shape[0]), tm(th))[1]
    n = 128
    keys = [jax.random.PRNGKey(k) for k in (11, 12, 13)]
    draws = [_jax_draws(k, jprior, n, 3, MUT, STAGES) for k in keys]
    kw = dict(n_particles=n, n_mutations=MUT, max_stages=STAGES)
    batch = tsm.run_smc(counted, tprior, n_groups=3, **kw, **_inject(draws))
    stages = batch.n_stages.tolist()
    assert len(set(stages)) > 1, stages  # a group is frozen while the others go on
    # one batched misfit for the initial particles and one a sweep, over all groups
    assert calls == [3 * n] * (1 + MUT * max(stages))
    for g, (k, dr) in enumerate(zip(keys, draws)):
        single = tsm.run_smc(tm, tprior, **kw, **_inject([dr]))
        for f in FIELDS:
            b = getattr(batch, f)
            b = b[:, g] if f in ("lambdas", "ess_frac", "accept_rate") else b[g]
            s = getattr(single, f)
            s = s[:, 0] if f in ("lambdas", "ess_frac", "accept_rate") else s[0]
            assert torch.equal(b, s), f
        _same(batch, _jax_smc(jm, jprior, k, n), g)


def test_linear_gaussian_evidence_and_moments():
    _, tm, _, tprior, log_z, mu, P = _linear_gaussian()
    res = tsm.run_smc(tm, tprior, torch.Generator().manual_seed(0), n_particles=8192, n_mutations=5)
    n = int(res.n_stages[0])
    assert n < 64 and float(res.lambdas[n - 1, 0]) == 1.0
    assert abs(float(res.log_evidence[0]) - log_z) < 0.06, (float(res.log_evidence[0]), log_z)
    th = res.particles[0].numpy()
    np.testing.assert_allclose(th.mean(0), mu, atol=4 * np.sqrt(np.diag(P).max() / len(th)) + 0.02)
    np.testing.assert_allclose(np.cov(th.T), P, atol=0.05)
    assert (res.ess_frac[:n, 0].numpy() > 0.3).all()


def _bimodal():
    """tests/test_smc.py's 1-D unequal bimodal misfit and its quadrature
    oracles (log Z, the right mode's mass)."""
    a, s, depth = 2.0, 0.15, 1.2

    def misfit(t):
        q1 = torch.sum((t - a) ** 2, -1) / (2 * s**2)
        q2 = torch.sum((t + a) ** 2, -1) / (2 * s**2) + depth
        return -torch.logsumexp(torch.stack([-q1, -q2], -1), dim=-1)

    x = np.linspace(-8, 8, 200_001)
    phi = misfit(torch.tensor(x)[:, None]).numpy()
    post = np.exp(-phi) * np.exp(-0.5 * x**2) / np.sqrt(2 * np.pi)
    log_z = float(np.log(np.sum(post) * (x[1] - x[0])))
    prior = TPrior.iid(1, mean=0.0, sigma=1.0, dtype=torch.float64, device="cpu")
    return misfit, prior, log_z, float(np.sum(post[x > 0]) / np.sum(post))


def test_bimodal_mass_and_evidence():
    misfit, prior, log_z, mass_right = _bimodal()
    res = tsm.run_smc(misfit, prior, torch.Generator().manual_seed(1), n_particles=16384, n_mutations=5)
    assert int(res.n_stages[0]) < 64
    assert abs(float((res.particles[0, :, 0] > 0).double().mean()) - mass_right) < 0.05
    assert abs(float(res.log_evidence[0]) - log_z) < 0.1


def test_smc_and_pt_stepping_stone_agree():
    misfit, prior, log_z, _ = _bimodal()
    smc = tsm.run_smc(misfit, prior, torch.Generator().manual_seed(2), n_particles=8192)
    gen = torch.Generator().manual_seed(4)
    pt = run_pt_pcn(misfit, prior, prior.sample(gen, (64,)), gen, n_steps=8000, n_burn=3000, beta=0.4,
                    n_temps=6, lambda_min=0.01, adapt_ladder=True)
    est = log_evidence_from_pt(pt, misfit, prior, gen)
    lz = float(smc.log_evidence[0])
    assert abs(lz - est.log_z) < max(3 * est.log_z_std, 0.15), (lz, est.log_z, est.log_z_std)
    assert abs(lz - log_z) < 0.1
