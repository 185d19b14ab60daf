"""Multilevel delayed acceptance in the port (infer/mlda.py) against the JAX
reference, in float64 on the reference's linear-Gaussian problem (d = 3,
two differently biased rungs below the fine misfit).

1. Replay: level_kernel steps and run_mlda (burn-in adaptation included,
   pcn and mala bases, two and three levels) and run_mlda_segmented are fed
   the draws JAX's key schedule gives, regenerated here from the
   reference's splits in its nesting order (subchain keys, then each
   level's accept uniform, the base's normals innermost), and must
   reproduce JAX's states, samples, betas and rates to 1e-10 (the rates,
   float32 on both sides, to 1e-6).
2. The reference's cases (tests/test_mlda.py but the sharded one): the
   analytic fine posterior through two biased rungs (pcn and mala bases),
   the two-level ladder, the segmented run's accounting, the evaluation
   count and the validation errors. The analytic cases run 16x the chains
   for 1/20 of the kept steps (256k draws against 320k; the segmented run
   192k as the reference's): the loop is eager, the chains a batch.
3. run_inversion(sampler="mlda_pcn") at res2 with the mid rung at res1 on a
   float64 pipeline converted from JAX's, its draws replaced by JAX's,
   against JAX's run_inversion to 1e-10; the refusals; invert
   --mlda-resolution / --mlda-subchain.
4. run_mlda_checkpointed stopped half-way and resumed, bit-identical to an
   uninterrupted run and to run_mlda_segmented on the same generator.
5. run_pcn_aux on JAX's draws to 1e-10, and api.fom_misfit_aux (each fom
   solve warm-started from the chain's last field) giving run_pcn's chain
   on the cold fom misfit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import _arrays, jax_build

from bayesianinferencedl_tpu import config as jcfg
from bayesianinferencedl_tpu.api import run_inversion as j_run_inversion
from bayesianinferencedl_tpu.infer import GaussianPrior as JPrior
from bayesianinferencedl_tpu.infer import mlda as jm
from bayesianinferencedl_tpu.infer.pcn import gaussian_misfit as j_misfit
from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch import config as tcfg
from bayesianinferencedl_tpu_torch.convert import pipeline_from_arrays
from bayesianinferencedl_tpu_torch.infer import mlda as tm
from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit as t_misfit
from bayesianinferencedl_tpu_torch.infer.pcn import run_pcn
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D, M, SIGMA = 3, 4, 0.5
B1 = np.array([0.4, -0.3, 0.2, 0.1])
B0 = np.array([0.7, 0.5, -0.6, 0.3])
TOL = dict(rtol=1e-10, atol=1e-10)
LEVEL_FIELDS = ("theta", "phi", "phi_sub", "rate_stack")


def _problem(seed=0):
    """The reference's setup: prior, analytic fine posterior (mu, Cpost) and
    the misfits (base c0, mid c1, fine) on both sides, batched."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((M, D))
    data = rng.standard_normal(M)
    Cpost = np.linalg.inv(H.T @ H / SIGMA**2 + np.eye(D))
    mu = Cpost @ H.T @ data / SIGMA**2
    Hj, dj = jnp.asarray(H), jnp.asarray(data)
    Ht, dt = torch.tensor(H), torch.tensor(data)
    j = dict(prior=JPrior.iid(D, mean=0.0, sigma=1.0, dtype=jnp.float64),
             m=tuple(j_misfit(lambda t, b=jnp.asarray(b): t @ Hj.T + b, dj, SIGMA)
                     for b in (B0, B1, np.zeros(M))))
    t = dict(prior=TPrior.iid(D, mean=0.0, sigma=1.0, dtype=torch.float64, device="cpu"),
             m=tuple(t_misfit(lambda x, b=torch.tensor(b): x @ Ht.T + b, dt, SIGMA)
                     for b in (B0, B1, np.zeros(M))))
    return j, t, mu, Cpost


def _step_draws(key, subchains, C, d=D):
    """The draws of one step of JAX's kernel of depth len(subchains) + 1 at
    `key`, in the port's layout: (normals, (uniforms base first, ...))."""
    if not subchains:  # the base: pcn_step / mala_step split (k_prop, k_acc)
        k_prop, k_acc = jax.random.split(key)
        return (np.asarray(jax.random.normal(k_prop, (C, d), jnp.float64)),
                (np.asarray(jax.random.uniform(k_acc, (C,), jnp.float64)),))
    k_sub, k_acc = jax.random.split(key)
    subs = [_step_draws(k, subchains[:-1], C, d) for k in jax.random.split(k_sub, subchains[-1])]
    normals = np.stack([s[0] for s in subs])
    us = tuple(np.stack([s[1][j] for s in subs]) for j in range(len(subchains)))
    return normals, us + (np.asarray(jax.random.uniform(k_acc, (C,), jnp.float64)),)


def _steps_draws(keys, subchains, C, d=D):
    """_step_draws of every key -> torch (normals, us) with a leading step axis."""
    steps = [_step_draws(k, subchains, C, d) for k in keys]
    return (torch.tensor(np.stack([s[0] for s in steps])),
            tuple(torch.tensor(np.stack([s[1][j] for s in steps])) for j in range(len(steps[0][1]))))


def _run_draws(key, n_steps, n_burn, subchains, C, d=D):
    """The draws of JAX's run_mlda(key): k_burn's splits, then k_main's."""
    k_burn, k_main = jax.random.split(key)
    keys = list(jax.random.split(k_burn, n_burn)) if n_burn > 0 else []
    keys += list(jax.random.split(k_main, n_steps - n_burn))
    return _steps_draws(keys, subchains, C, d)


def _segmented_draws(key, n_steps, n_burn, segment, subchains, C, d=D):
    """The draws of JAX's run_mlda_segmented(key): one key split per segment."""
    nrm, us, done = [], [], 0
    while done < n_steps:
        this = min(segment, n_steps - done)
        key, sub = jax.random.split(key)
        n, u = _run_draws(sub, this, min(max(n_burn - done, 0), this), subchains, C, d)
        nrm.append(n)
        us.append(u)
        done += this
    return torch.cat(nrm), tuple(torch.cat([u[j] for u in us]) for j in range(len(us[0])))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


@pytest.mark.parametrize("inner", ["pcn", "mala"])
def test_level_kernel_step_replays_reference(inner):
    j, t, _, _ = _problem()
    C, subchains = 16, (4, 3)
    theta0 = np.asarray(j["prior"].sample(jax.random.PRNGKey(0), (C,)))
    beta = np.full(C, 0.3)
    jk = jm.build_mlda_kernel(j["m"], j["prior"], subchains, inner=inner, batched=True)
    tk = tm.build_mlda_kernel(t["m"], t["prior"], subchains, inner=inner)
    assert (tk.depth, tk.target) == (jk.depth, jk.target) == (3, jk.target)
    js = jk.init(jnp.asarray(theta0), j["m"][-1](jnp.asarray(theta0)))
    ts = tk.init(torch.tensor(theta0), t["m"][-1](torch.tensor(theta0)))
    key = jax.random.PRNGKey(3)
    for step in range(2):  # a second step from the first's state
        key, k = jax.random.split(key)
        js, jacc = jk.step(jnp.asarray(beta), js, k)
        nrm, us = _steps_draws([k], subchains, C)
        ts, tacc = tk.step(torch.tensor(beta), ts, None, (nrm[0], tuple(u[0] for u in us)))
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        for f in LEVEL_FIELDS:
            _close(getattr(ts, f), getattr(js, f))
    assert 0 < int(tacc.sum()) < C  # the replay decides both ways


@pytest.mark.parametrize("inner,subchains", [("pcn", (4, 3)), ("pcn", (5,)), ("mala", (4, 3))])
def test_run_mlda_replays_reference_through_burn_in(inner, subchains):
    j, t, _, _ = _problem()
    levels = slice(3 - len(subchains) - 1, 3)
    C, n_steps, n_burn = 16, 10, 4
    theta0 = np.asarray(j["prior"].sample(jax.random.PRNGKey(0), (C,)))
    key = jax.random.PRNGKey(7)
    beta = 0.4 if inner == "pcn" else 0.3
    rj = jm.run_mlda(j["m"][levels], j["prior"], jnp.asarray(theta0), key, n_steps=n_steps,
                     n_burn=n_burn, beta=beta, subchains=subchains, batched=True, inner=inner)
    nrm, us = _run_draws(key, n_steps, n_burn, subchains, C)
    rt = tm.run_mlda(t["m"][levels], t["prior"], torch.tensor(theta0), n_steps=n_steps, n_burn=n_burn,
                     beta=beta, subchains=subchains, inner=inner, normals=nrm, uniforms=us)
    for f in ("samples", "phi_trace", "beta"):
        _close(getattr(rt, f), getattr(rj, f))
    for f in LEVEL_FIELDS:
        _close(getattr(rt.state, f), getattr(rj.state, f))
    for f in ("accept_rate", "level_rates"):  # float32 on both sides
        assert getattr(rt, f).dtype == torch.float32
        _close(getattr(rt, f), getattr(rj, f), rtol=1e-6, atol=1e-6)
    assert rt.evals_per_step == rj.evals_per_step
    assert not np.allclose(rt.beta.numpy(), beta)  # the burn-in adapted it


def test_run_mlda_segmented_replays_reference_over_three_segments():
    j, t, _, _ = _problem()
    C, n_steps, n_burn, segment, subchains = 16, 12, 5, 4, (3, 2)
    theta0 = np.asarray(j["prior"].sample(jax.random.PRNGKey(0), (C,)))
    key = jax.random.PRNGKey(9)
    rj = jm.run_mlda_segmented(j["m"], j["prior"], jnp.asarray(theta0), key, n_steps=n_steps,
                               n_burn=n_burn, beta=0.4, subchains=subchains, segment=segment,
                               batched=True)
    nrm, us = _segmented_draws(key, n_steps, n_burn, segment, subchains, C)
    rt = tm.run_mlda_segmented(t["m"], t["prior"], torch.tensor(theta0), n_steps=n_steps,
                               n_burn=n_burn, beta=0.4, subchains=subchains, segment=segment,
                               normals=nrm, uniforms=us)
    for f in ("samples", "phi_trace", "beta"):
        _close(getattr(rt, f), getattr(rj, f))
    for f in ("accept_rate", "level_rates"):
        _close(getattr(rt, f), getattr(rj, f), rtol=1e-6, atol=1e-6)
    assert rt.samples.shape == (n_steps - n_burn, C, D)


# the reference's cases, at 16x the chains for 1/20 of the kept steps
C_AN, N_AN, BURN_AN = 1024, 375, 125


def _analytic(t, misfits, inner="pcn", subchains=(4, 3), seed=1):
    theta0 = t["prior"].sample(torch.Generator().manual_seed(0), (C_AN,))
    return tm.run_mlda(misfits, t["prior"], theta0, torch.Generator().manual_seed(seed), n_steps=N_AN,
                       n_burn=BURN_AN, beta=0.4, subchains=subchains, inner=inner)


def test_mlda_corrects_two_biased_rungs_to_fine_posterior():
    _, t, mu, Cpost = _problem()
    res = _analytic(t, t["m"])
    samples = res.samples.reshape(-1, D).numpy()
    np.testing.assert_allclose(samples.mean(0), mu, atol=0.06)
    np.testing.assert_allclose(np.cov(samples.T), Cpost, atol=0.08)
    # the base rung's posterior is genuinely elsewhere
    theta0 = t["prior"].sample(torch.Generator().manual_seed(0), (C_AN,))
    res_c = run_pcn(t["m"][0], t["prior"], theta0, torch.Generator().manual_seed(2), n_steps=375,
                    n_burn=125, beta=0.4)
    mu_c = res_c.samples.reshape(-1, D).numpy().mean(0)
    assert np.linalg.norm(mu_c - mu) > 0.15
    # the rate stack: base first, top last; corrections cheap but not vacuous
    rates = res.level_rates.numpy().mean(axis=1)
    assert rates.shape == (3,)
    assert np.all((rates > 0.05) & (rates <= 1.0))
    assert 0.2 < float(res.accept_rate.mean()) < 0.999


def test_mlda_mala_base_same_posterior():
    _, t, mu, Cpost = _problem()
    samples = _analytic(t, t["m"], inner="mala").samples.reshape(-1, D).numpy()
    np.testing.assert_allclose(samples.mean(0), mu, atol=0.06)
    np.testing.assert_allclose(np.cov(samples.T), Cpost, atol=0.09)


def test_mlda_two_levels_agrees_with_analytic():
    _, t, mu, Cpost = _problem()
    res = _analytic(t, t["m"][1:], subchains=(4,))
    samples = res.samples.reshape(-1, D).numpy()
    np.testing.assert_allclose(samples.mean(0), mu, atol=0.06)
    np.testing.assert_allclose(np.cov(samples.T), Cpost, atol=0.08)
    assert res.evals_per_step == (4, 1)


def test_mlda_segmented_matches_whole_run_distribution():
    _, t, mu, _ = _problem()
    theta0 = t["prior"].sample(torch.Generator().manual_seed(0), (C_AN,))
    res = tm.run_mlda_segmented(t["m"], t["prior"], theta0, torch.Generator().manual_seed(1),
                                n_steps=500, n_burn=125, beta=0.4, subchains=(4, 3), segment=80)
    samples = res.samples.reshape(-1, D).numpy()
    np.testing.assert_allclose(samples.mean(0), mu, atol=0.08)
    assert res.samples.shape[0] == 375
    assert res.level_rates.shape[0] == 3
    assert np.all(res.level_rates.numpy() <= 1.0 + 1e-9)
    assert np.all(res.accept_rate.numpy() <= 1.0 + 1e-9)


def test_mlda_eval_accounting():
    for s in ((4,), (4, 3), (5, 4, 3), (64, 4)):
        assert tm.mlda_evals_per_step(s) == jm.mlda_evals_per_step(s)
    assert tm.mlda_evals_per_step((64, 4)) == (257, 4, 1)


def test_mlda_kernel_validation():
    prior = TPrior.iid(2, mean=0.0, sigma=1.0, dtype=torch.float64, device="cpu")
    m = t_misfit(lambda x: x, torch.zeros(2, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError, match="at least 2"):
        tm.build_mlda_kernel((m,), prior, ())
    with pytest.raises(ValueError, match="subchain lengths"):
        tm.build_mlda_kernel((m, m, m), prior, (4,))
    with pytest.raises(ValueError, match="unknown DA inner"):
        tm.build_mlda_kernel((m, m), prior, (4,), inner="hmc")


# run_inversion(sampler="mlda_pcn"): res2 with the mid rung at res1, on the
# float64 res2 build of test_torch_gradient_slice.py (one JAX build for both)
MLDA_MCMC = dict(n_chains=8, n_steps=10, n_burn=4, noise_sigma=1e-2, likelihood="fom",
                 sampler="mlda_pcn", subchain=3, mlda_resolution=1, mlda_subchain=2)


def _cfg(cfg, **mcmc):
    return cfg.PipelineConfig(
        mesh=cfg.MeshConfig(resolution=2),
        fem=cfg.FEMConfig(biot=0.1, cg_tol=1e-10, cg_maxiter=1500),
        rom=cfg.ROMConfig(n_snapshots=16, basis_size=8),
        surrogate=cfg.SurrogateConfig(hidden=(16, 16), n_train=32, epochs=5),
        mcmc=cfg.MCMCConfig(**mcmc),
    )


@pytest.fixture(scope="module")
def pipes():
    jpipe = jax_build(_cfg(jcfg, **MLDA_MCMC), jnp.float64)
    tpipe = pipeline_from_arrays(_cfg(tcfg, **MLDA_MCMC), _arrays(jpipe), device="cpu",
                                 dtype=torch.float64)
    return jpipe, tpipe


def test_run_inversion_mlda_pcn_replays_reference(pipes, monkeypatch):
    jpipe, tpipe = pipes
    key = jax.random.PRNGKey(31)
    jinv = j_run_inversion(jpipe, key=key)
    mc = MLDA_MCMC
    k_true, k_noise, k_init, k_chain, _ = jax.random.split(key, 5)
    theta0 = np.asarray(jpipe.prior.sample(k_init, (mc["n_chains"],)))
    subchains = (mc["subchain"], mc["mlda_subchain"])
    nrm, us = _segmented_draws(jax.random.fold_in(k_chain, 1), mc["n_steps"], mc["n_burn"], 32,
                               subchains, mc["n_chains"], 5)
    plain = api.run_mlda_segmented
    seen = {}

    def replay(misfits, prior, th0, gen, *, n_steps, n_burn, **kw):
        assert kw["segment"] == 32 and kw["subchains"] == subchains and len(misfits) == 3
        if n_steps != mc["n_steps"]:  # the warm-up run
            return plain(misfits, prior, th0, gen, n_steps=n_steps, n_burn=n_burn, **kw)
        seen["misfits"] = misfits
        return plain(misfits, prior, torch.tensor(theta0), n_steps=n_steps, n_burn=n_burn,
                     normals=nrm, uniforms=us, **kw)

    monkeypatch.setattr(api, "run_mlda_segmented", replay)
    tinv = api.run_inversion(tpipe, data=torch.tensor(np.asarray(jinv.data)))
    res, jres = tinv.result, jinv.result
    assert res.samples.shape == (mc["n_steps"] - mc["n_burn"], mc["n_chains"], 5)
    _close(res.samples, jres.samples)
    _close(res.beta, jres.beta)
    _close(res.level_rates, jres.level_rates, rtol=1e-6, atol=1e-6)
    assert res.evals_per_step == jres.evals_per_step == (3 * 2 + 1, 2, 1)
    assert 0 < float(res.accept_rate.mean()) <= 1
    # the mid rung is the res1 FOM: its misfit against the JAX fin's
    mid = seen["misfits"][1]
    th = torch.tensor(theta0)
    jfin1 = jax.vmap(lambda t: jpipe.fin.__class__.create(resolution=1, biot=0.1, dtype=jnp.float64,
                                                          cg_tol=1e-10, cg_maxiter=1500).forward(jnp.exp(t)))
    r = np.asarray(jfin1(jnp.asarray(theta0))) - np.asarray(jinv.data)
    np.testing.assert_allclose(mid(th).numpy(), 0.5 * (r * r).sum(-1) / 1e-4, rtol=1e-9)
    assert tinv.fom_iter_cap == 1500 and tinv.fom_hit_cap_frac == 0.0


def test_run_inversion_mlda_pcn_refusals(pipes):
    _, tpipe = pipes
    assert not hasattr(api, "_UNPORTED")
    with pytest.raises(ValueError, match="likelihood='fom'"):
        api.run_inversion(tpipe, likelihood="rom_nn")
    fine1 = dataclasses.replace(tpipe, config=dataclasses.replace(
        tpipe.config, mcmc=dataclasses.replace(tpipe.config.mcmc, mlda_resolution=2)))
    with pytest.raises(ValueError, match="must be coarser"):
        api.run_inversion(fine1)


def test_run_mlda_checkpointed_resumes_bit_identical(tmp_path):
    """Stopped half-way and resumed: samples, state, betas and rates equal
    an uninterrupted run's, which equals run_mlda_segmented on the same
    generator."""
    _, t, _, _ = _problem()
    theta0 = t["prior"].sample(torch.Generator().manual_seed(0), (16,))
    kw = dict(n_steps=12, n_burn=4, beta=0.4, subchains=(3, 2), segment=4)
    run = lambda path, resume, **over: api.run_mlda_checkpointed(
        t["m"], t["prior"], theta0, torch.Generator().manual_seed(7), ckpt_path=str(path), resume=resume,
        **{**kw, **over})
    full = run(tmp_path / "full.npz", False)
    run(tmp_path / "crash.npz", False, n_steps=8)
    resumed = run(tmp_path / "crash.npz", True)
    seg = tm.run_mlda_segmented(t["m"], t["prior"], theta0, torch.Generator().manual_seed(7),
                                **{k: v for k, v in kw.items()})
    for other in (resumed, seg):
        for f in ("samples", "phi_trace", "beta", "accept_rate", "level_rates"):
            assert torch.equal(getattr(full, f), getattr(other, f)), f
        for f in LEVEL_FIELDS:
            assert torch.equal(getattr(full.state, f), getattr(other.state, f)), f
    assert full.evals_per_step == (7, 2, 1) and full.samples.shape == (8, 16, D)



def test_run_pcn_aux_replays_reference():
    from bayesianinferencedl_tpu.infer.pcn import run_pcn_aux as j_run_pcn_aux
    from bayesianinferencedl_tpu_torch.infer.pcn import run_pcn_aux

    j, t, _, _ = _problem()
    rng = np.random.default_rng(0)
    H = rng.standard_normal((M, D))
    data = rng.standard_normal(M)
    Hj, Ht = jnp.asarray(H), torch.tensor(H)

    def jmis(props, aux):
        y = props @ Hj.T
        r = y - jnp.asarray(data)
        return 0.5 * jnp.sum(r * r, -1) / SIGMA**2, y

    def tmis(props, aux):
        y = props @ Ht.T
        r = y - torch.tensor(data)
        return 0.5 * torch.sum(r * r, -1) / SIGMA**2, y

    C, n_steps, n_burn = 16, 30, 10
    theta0 = np.asarray(j["prior"].sample(jax.random.PRNGKey(0), (C,)))
    key = jax.random.PRNGKey(1)
    rj, auxj = j_run_pcn_aux(jmis, j["prior"], jnp.asarray(theta0), jnp.zeros((C, M)), key, n_steps=n_steps,
                             n_burn=n_burn, beta=0.4)
    nrm, uni = [], []
    for k in jax.random.split(key, n_steps):
        k_prop, k_acc = jax.random.split(k)
        nrm.append(np.asarray(jax.random.normal(k_prop, (C, D), jnp.float64)))
        uni.append(np.asarray(jax.random.uniform(k_acc, (C,), jnp.float64)))
    rt, auxt = run_pcn_aux(tmis, t["prior"], torch.tensor(theta0), torch.zeros(C, M, dtype=torch.float64),
                           n_steps=n_steps, n_burn=n_burn, beta=0.4, normals=torch.tensor(np.stack(nrm)),
                           uniforms=torch.tensor(np.stack(uni)))
    for f in ("samples", "phi_trace", "beta"):
        _close(getattr(rt, f), getattr(rj, f))
    _close(rt.accept_rate, rj.accept_rate, rtol=1e-6)
    _close(auxt, auxj)
    _close(auxt, rt.state.theta @ Ht.T)  # aux follows the accepted states exactly
    assert rt.samples.shape == (n_steps - n_burn, C, D)


def test_fom_misfit_aux_warm_starts_the_fom_chain(pipes):
    """api.fom_misfit_aux in run_pcn_aux: each solve warm-started from the
    chain's last accepted field, the same chain as run_pcn on the cold fom
    misfit to the solver's tolerance, the aux the accepted states' fields."""
    from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit, run_pcn, run_pcn_aux

    _, tpipe = pipes
    data = tpipe.fin.forward(torch.ones(5, dtype=torch.float64))
    C, n = 6, 12
    theta0 = tpipe.prior.sample(torch.Generator().manual_seed(2), (C,))
    g = lambda: torch.Generator().manual_seed(3)
    rt, aux = run_pcn_aux(api.fom_misfit_aux(tpipe, data), tpipe.prior, theta0,
                          torch.zeros(C, tpipe.fin.op.n, dtype=torch.float64), g(), n_steps=n, n_burn=4)
    ref = run_pcn(gaussian_misfit(tpipe.working_forward_fn("fom"), data, 1e-2), tpipe.prior, theta0, g(),
                  n_steps=n, n_burn=4)
    np.testing.assert_allclose(rt.samples.numpy(), ref.samples.numpy(), rtol=1e-12)
    np.testing.assert_allclose(rt.phi_trace.numpy(), ref.phi_trace.numpy(), rtol=1e-6)
    u_final = tpipe.fin.solve_batch(torch.exp(rt.state.theta))
    np.testing.assert_allclose(aux.numpy(), u_final.numpy(), rtol=1e-8, atol=1e-10)


def test_cli_invert_mlda_flags(capsys, monkeypatch):
    import json

    from bayesianinferencedl_tpu_torch import cli as tcli
    from test_torch_slice import cached_build_pipeline

    monkeypatch.setattr(api, "build_pipeline", cached_build_pipeline)
    seen = {}
    plain = api.run_mlda_segmented

    def spy(misfits, prior, th0, gen, **kw):
        seen.update(kw)
        return plain(misfits, prior, th0, gen, **kw)

    monkeypatch.setattr(api, "run_mlda_segmented", spy)
    tcli.main(["invert", "--device", "cpu", "--resolution", "2", "--n-snapshots", "32", "--r", "8",
               "--n-train", "64", "--epochs", "5", "--chains", "4", "--steps", "4", "--burn", "1",
               "--noise", "1e-2", "--sampler", "mlda_pcn", "--likelihood", "fom", "--subchain", "3",
               "--mlda-resolution", "1", "--mlda-subchain", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert seen["subchains"] == (3, 2) and seen["n_steps"] == 4
    assert out["sampler"] == "mlda_pcn" and 0 <= out["accept_rate"] <= 1
    assert out["fom_iter_audit"]["hit_cap_frac"] == 0.0
