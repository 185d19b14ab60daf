"""The approximation layer's entry points in the port's api.py, on a JAX float32
res2 pipeline carried over by convert.pipeline_from_arrays.

1. run_eki on the converted rom_nn forward, from JAX's initial ensemble and
   NumPy generator, follows JAX's run_eki on the JAX pipeline (float32,
   to 1e-4).
2. run_eki_inversion (rom_nn, and fom with the data passed), run_vi_inversion,
   run_svgd_inversion, psis_certify and run_smc_evidence finish with finite
   outputs of the right shapes and log the reference's events; the fom EKI
   makes exactly one batched FOM solve an iteration and one more.
3. run_smc_evidence simulates the same observations as run_inversion for
   the same seed.
4. run_inversion(init="eki" | "vi") runs and logs the "eki_init" /
   "vi_init" events; an unknown init raises the reference's ValueError."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu import config as jcfg
from bayesianinferencedl_tpu.infer import eki as je
from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch import config as tcfg
from bayesianinferencedl_tpu_torch.convert import pipeline_from_arrays
from bayesianinferencedl_tpu_torch.infer import eki as te
from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger
from test_torch_slice import _arrays, jax_build

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D = 5


def _cfg(cfg):
    return cfg.PipelineConfig(
        mesh=cfg.MeshConfig(resolution=2),
        fem=cfg.FEMConfig(biot=0.1, cg_tol=1e-7, cg_maxiter=1500),
        rom=cfg.ROMConfig(n_snapshots=32, basis_size=8),
        surrogate=cfg.SurrogateConfig(hidden=(16, 16), n_train=64, epochs=20),
        mcmc=cfg.MCMCConfig(noise_sigma=1e-2, n_chains=16, n_steps=30, n_burn=10),
    )


@pytest.fixture(scope="module")
def pipes():
    jpipe = jax_build(_cfg(jcfg), jnp.float32)
    return jpipe, pipeline_from_arrays(_cfg(tcfg), _arrays(jpipe), device="cpu", dtype=torch.float32)


def _events(log):
    return [e["event"] for e in log.events]


def test_eki_on_the_converted_forward_follows_reference(pipes):
    jpipe, tpipe = pipes
    rng = np.random.default_rng(1)
    fwd_j = jpipe.batched_forward_fn("rom_nn")
    data = np.asarray(fwd_j(jnp.asarray(rng.normal(0, 0.6, (1, D)), jnp.float32)))[0]
    data = (data + 1e-2 * rng.normal(size=data.shape)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    rj = je.run_eki(fwd_j, jpipe.prior, jnp.asarray(data), 1e-2, key, n_ensemble=64)
    k_init, k_loop = jax.random.split(key)
    seed = int(jax.random.randint(k_loop, (), 0, np.iinfo(np.int32).max))
    rt = te.run_eki(tpipe.batched_forward_fn("rom_nn"), tpipe.prior, torch.from_numpy(data), 1e-2,
                    n_ensemble=64, theta0=torch.tensor(np.asarray(jpipe.prior.sample(k_init, (64,)))),
                    rng=np.random.default_rng(seed))
    assert len(rt.ts) == len(rj.ts)
    np.testing.assert_allclose(rt.ts, rj.ts, rtol=1e-4)
    np.testing.assert_allclose(rt.ensemble.numpy(), np.asarray(rj.ensemble), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("like", ["rom_nn", "fom"])
def test_run_eki_inversion(pipes, like, monkeypatch):
    _, tpipe = pipes
    log = MetricsLogger()
    data = None
    if like == "fom":  # the data passed: only the ensemble's solves are made
        _, data = api._observations(tpipe, torch.Generator().manual_seed(0), None, None)
    calls = []
    solve = api.make_fom_solver

    def counted(*a, **kw):
        inner = solve(*a, **kw)
        return lambda ks: (calls.append(ks.shape[0]), inner(ks))[1]

    monkeypatch.setattr(api, "make_fom_solver", counted)
    res, theta_true, d_used, wall = api.run_eki_inversion(tpipe, like, n_ensemble=64, data=data,
                                                          metrics=log)
    n_iters = len(res.ts) - 1
    assert res.ensemble.shape == (64, D) and torch.isfinite(res.ensemble).all()
    assert res.ts[-1] == 1.0 and res.n_forward == 64 * (n_iters + 1) and wall > 0
    assert d_used.shape == (tpipe.fin.op.n_obs,) and theta_true.shape == (D,)
    e = log.summary()["eki"]
    assert e["likelihood"] == like and e["n_iters"] == n_iters and np.isfinite(e["misfit_final"])
    if like == "fom":
        assert calls == [64] * (n_iters + 1)


def test_run_vi_inversion_and_psis_certify(pipes):
    _, tpipe = pipes
    log = MetricsLogger()
    res, _, data, _ = api.run_vi_inversion(tpipe, n_steps=40, n_mc=8, metrics=log)
    L = res.theta_chol
    assert res.elbo_trace.shape == (40,) and torch.isfinite(res.elbo_trace).all()
    assert torch.equal(L, torch.tril(L)) and (torch.diagonal(L) > 0).all()
    assert res.n_forward == 320 and "vi" in _events(log)
    cert = api.psis_certify(tpipe, res.theta_mean, res.theta_chol, data, n_draws=256, metrics=log)
    assert cert.samples.shape == (256, D) and np.isfinite(cert.k_hat) and cert.ess > 0
    assert np.isfinite(cert.mean).all() and np.isfinite(cert.log_evidence)
    assert log.summary()["psis"]["n_draws"] == 256


def test_run_svgd_inversion(pipes):
    _, tpipe = pipes
    log = MetricsLogger()
    res, _, _, _ = api.run_svgd_inversion(tpipe, n_particles=32, n_steps=20, metrics=log)
    assert res.particles.shape == (32, D) and torch.isfinite(res.particles).all()
    assert res.misfit_trace.shape == (20,) and res.n_forward == 640
    assert np.isfinite(log.summary()["svgd"]["misfit_final"])


def test_smc_evidence_shares_run_inversions_data(pipes):
    _, tpipe = pipes
    log = MetricsLogger()
    ev = api.run_smc_evidence(tpipe, n_particles=256, n_groups=4, n_mutations=2, metrics=log)
    inv = api.run_inversion(tpipe)
    assert torch.equal(ev.data, inv.data) and torch.equal(ev.theta_true, inv.theta_true)
    assert ev.particles.shape == (256, D) and torch.isfinite(ev.particles).all()
    assert ev.log_z_groups.shape == (4,) and np.isfinite(ev.log_evidence)
    assert ev.n_stages.shape == (4,) and (ev.n_stages < 64).all()
    s = log.summary()["smc_evidence"]
    assert s["method"] == "smc" and s["n_stages"] == ev.n_stages.tolist()
    with pytest.raises(ValueError, match="not divisible"):
        api.run_smc_evidence(tpipe, n_particles=250, n_groups=4)


@pytest.mark.parametrize("init", ["eki", "vi"])
def test_run_inversion_init(pipes, init):
    _, tpipe = pipes
    log = MetricsLogger()
    inv = api.run_inversion(tpipe, init=init, metrics=log)
    assert inv.result.samples.shape == (20, 16, D) and torch.isfinite(inv.result.samples).all()
    assert _events(log).count(f"{init}_init") == 2  # the timer and the event
    assert log.summary()[f"{init}_init"]["n_forward"] > 0


def test_run_inversion_unknown_init_raises(pipes):
    _, tpipe = pipes
    with pytest.raises(ValueError, match="init must be 'prior', 'eki', or 'vi'"):
        api.run_inversion(tpipe, init="laplace")
