"""The flow's entry points in the port's api.py against the JAX package's, on a
JAX float64 res1 pipeline carried over by convert.pipeline_from_arrays.

1. run_flow_vi_inversion (pretrain="none", 8 steps), psis_certify_flow
   (base_scale 1.4) and run_neutra_inversion (8 chains, 20 steps) on the
   same data, each on the draws of the reference's key schedule (cfg.seed,
   seed + 7, seed + 11), regenerated here and injected into the port's
   infer/flow.py: the fit, the certificate and the InversionResult's samples
   to 1e-10 (its bulk and tail ESS, split-R-hat and accept rates, which both
   sides compute in float32, to 1e-6), and the events
   "flow_vi", "psis_flow" and "neutra" with the reference's fields.
2. With data=None the flow driver simulates the observations run_inversion
   simulates for the same seed; the SMC-pretrained route finishes with
   finite outputs and its stage count; on fom the certificate is one
   batched FOM solve, and NeuTra one a step plus one for the chains' start."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu import api as japi
from bayesianinferencedl_tpu import config as jcfg
from bayesianinferencedl_tpu.infer import flow as jf
from bayesianinferencedl_tpu.utils.metrics import MetricsLogger as JLogger
from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch.convert import flow_from_arrays, pipeline_from_arrays
from bayesianinferencedl_tpu_torch.infer import flow as tf
from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger
from test_torch_flow import _arrays as _flow_arrays
from test_torch_flow import _jax_flow, _normal
from test_torch_slice import _arrays, _cfg, jax_build

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D, SEED = 5, 0
TOL = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(scope="module")
def pipes():
    kw = dict(n_chains=8, n_steps=12, n_burn=4, seed=SEED)
    jpipe = jax_build(_cfg(1e-10, jcfg, **kw), jnp.float64)
    tpipe = pipeline_from_arrays(_cfg(1e-10, **kw), _arrays(jpipe), device="cpu", dtype=torch.float64)
    data = np.asarray(api._observations(tpipe, torch.Generator().manual_seed(5), None, None)[1])
    return jpipe, tpipe, data


def _flows(jpipe):
    """A non-identity flow in a frame near the posterior, on both sides."""
    flow, p = _jax_flow(seed=21, scale=0.1, nc=2, hidden=8)
    m, L = np.asarray(jpipe.prior.mean) + 0.1, 0.3 * np.asarray(jpipe.prior.chol)
    jres = jf.FlowVIResult(flow=flow, params=p, ref_mean=jnp.asarray(m), ref_chol=jnp.asarray(L),
                           elbo_trace=jnp.zeros(1), theta_mean=jnp.asarray(m),
                           theta_cov=jnp.eye(D, dtype=jnp.float64), n_forward=0)
    return jres, flow_from_arrays(_flow_arrays(p), ref=(m, L), device="cpu", dtype=torch.float64)


def _fields(log, event):
    return {k for e in log.events if e["event"] == event for k in e} - {"event", "t"}


def test_run_flow_vi_inversion_replays_reference(pipes, monkeypatch):
    jpipe, tpipe, data = pipes
    n_steps, n_mc, kw = 8, 8, dict(n_couplings=2, hidden=8, pretrain="none", lr=0.01)
    jlog, tlog = JLogger(), MetricsLogger()
    key = jax.random.PRNGKey(SEED)
    rj, _, dj, _ = japi.run_flow_vi_inversion(jpipe, data=jnp.asarray(data), n_steps=n_steps, n_mc=n_mc,
                                              key=key, metrics=jlog, **kw)
    # the reference's schedule: key -> k_fit -> k_run -> (k_init, k_steps, k_sum)
    k_init, k_steps, k_sum = jax.random.split(jax.random.split(jax.random.split(key, 3)[2], 3)[2], 3)
    init = jf.CouplingFlow(dim=D, n_couplings=2, hidden=8).init(k_init, jnp.float64)
    vi = tf.run_flow_vi

    def replayed(m, pr, g, *, params, **k):
        assert params is None
        eps = np.stack([_normal(jax.random.fold_in(k_steps, t), (n_mc, D)) for t in range(n_steps)])
        start = flow_from_arrays(_flow_arrays(init), device="cpu", dtype=torch.float64)
        return vi(m, pr, None, params=start, eps=torch.tensor(eps),
                  summary_Z=torch.tensor(_normal(k_sum, (4096, D))), **k)

    monkeypatch.setattr(tf, "run_flow_vi", replayed)
    rt, _, dt, wall = api.run_flow_vi_inversion(tpipe, data=torch.tensor(data), n_steps=n_steps, n_mc=n_mc,
                                                metrics=tlog, **kw)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    for f in ("elbo_trace", "theta_mean", "theta_cov"):
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)), err_msg=f, **TOL)
    assert rt.n_forward == rj.n_forward == n_steps * n_mc and wall > 0
    assert _fields(tlog, "flow_vi") == _fields(jlog, "flow_vi")
    ev = tlog.summary()["flow_vi"]
    assert ev["smc_stages"] is None and ev["pretrain"] == "none"


def test_psis_certify_flow_replays_reference(pipes, monkeypatch):
    jpipe, tpipe, data = pipes
    jres, tres = _flows(jpipe)
    jlog, tlog = JLogger(), MetricsLogger()
    n, s = 256, 1.4
    cj = japi.psis_certify_flow(jpipe, jres, jnp.asarray(data), n_draws=n, base_scale=s, metrics=jlog)
    Z = torch.tensor(s * _normal(jax.random.PRNGKey(SEED + 7), (n, D)))
    cert = tf.flow_psis_certify
    monkeypatch.setattr(api, "flow_psis_certify", lambda *a, **k: cert(*a, **k, Z=Z))
    ct = api.psis_certify_flow(tpipe, tres, torch.tensor(data), n_draws=n, base_scale=s, metrics=tlog)
    for f in ("k_hat", "ess", "log_evidence"):
        np.testing.assert_allclose(getattr(ct, f), getattr(cj, f), err_msg=f, **TOL)
    np.testing.assert_allclose(ct.log_weights, np.asarray(cj.log_weights), **TOL)
    np.testing.assert_allclose(ct.mean, np.asarray(cj.mean), **TOL)
    assert ct.reliable == cj.reliable
    assert _fields(tlog, "psis_flow") == _fields(jlog, "psis_flow")
    assert tlog.summary()["psis_flow"]["base_scale"] == s


def test_run_neutra_inversion_replays_reference(pipes, monkeypatch):
    jpipe, tpipe, data = pipes
    jres, tres = _flows(jpipe)
    jlog, tlog = JLogger(), MetricsLogger()
    C, n_steps, n_burn = 8, 20, 8
    kw = dict(n_chains=C, n_steps=n_steps, n_burn=n_burn)
    ij = japi.run_neutra_inversion(jpipe, jres, jnp.asarray(data), metrics=jlog, **kw)
    k0, k_run = jax.random.split(jax.random.PRNGKey(SEED + 11))
    k_burn, k_main = jax.random.split(k_run)
    keys = list(jax.random.split(k_burn, n_burn)) + list(jax.random.split(k_main, n_steps - n_burn))
    nrm, uni = [], []
    for k in keys:
        k_prop, k_acc = jax.random.split(k)
        nrm.append(_normal(k_prop, (C, D)))
        uni.append(np.asarray(jax.random.uniform(k_acc, (C,), jnp.float64)))
    draws = dict(Z0=torch.tensor(_normal(k0, (C, D))), normals=torch.tensor(np.stack(nrm)),
                 uniforms=torch.tensor(np.stack(uni)))
    neutra = tf.run_neutra_pcn
    monkeypatch.setattr(api, "run_neutra_pcn", lambda *a, **k: neutra(*a, **k, **draws))
    it = api.run_neutra_inversion(tpipe, tres, torch.tensor(data), metrics=tlog, **kw)
    np.testing.assert_allclose(it.result.samples.numpy(), np.asarray(ij.result.samples), **TOL)
    for f in ("ess", "rhat", "ess_tail"):
        np.testing.assert_allclose(getattr(it, f).numpy(), np.asarray(getattr(ij, f)), err_msg=f, rtol=1e-6)
    np.testing.assert_allclose(it.result.accept_rate.numpy(), np.asarray(ij.result.accept_rate), rtol=1e-6)
    np.testing.assert_array_equal(it.theta_true.numpy(), np.asarray(ij.theta_true))
    assert it.samples_per_sec > 0 and np.isfinite(it.ess_per_sec)
    assert _fields(tlog, "neutra") == _fields(jlog, "neutra")


def test_flow_driver_shares_run_inversions_data_and_smc_route(pipes):
    _, tpipe, _ = pipes
    log = MetricsLogger()
    res, theta_true, data, _ = api.run_flow_vi_inversion(
        tpipe, n_couplings=2, hidden=8, pretrain_particles=128, pretrain_steps=20, n_mutations=2,
        metrics=log)
    inv = api.run_inversion(tpipe)
    assert torch.equal(data, inv.data) and torch.equal(theta_true, inv.theta_true)
    ev = log.summary()["flow_vi"]
    assert isinstance(ev["smc_stages"], int) and 0 < ev["smc_stages"] < 64 and ev["n_forward"] == 0
    assert res.elbo_trace.shape == (20,) and torch.isfinite(res.theta_mean).all()
    assert torch.isfinite(res.theta_cov).all()
    with pytest.raises(ValueError, match="pretrain must be"):
        api.run_flow_vi_inversion(tpipe, pretrain="laplace")


def test_fom_route_solves_once_a_call_and_once_a_step(pipes, monkeypatch):
    """On fom the certificate's draws are one batched FOM solve; NeuTra makes
    one for the chains' start and one a step."""
    jpipe, tpipe, data = pipes
    _, tres = _flows(jpipe)
    calls = []
    solve = api.make_fom_solver

    def counted(*a, **kw):
        inner = solve(*a, **kw)
        return lambda ks: (calls.append(ks.shape[0]), inner(ks))[1]

    monkeypatch.setattr(api, "make_fom_solver", counted)
    cert = api.psis_certify_flow(tpipe, tres, torch.tensor(data), "fom", n_draws=64)
    assert calls == [64] and np.isfinite(cert.k_hat)
    calls.clear()
    inv = api.run_neutra_inversion(tpipe, tres, torch.tensor(data), "fom", n_chains=4, n_steps=6, n_burn=2)
    assert calls == [4] * 7 and torch.isfinite(inv.result.samples).all()
