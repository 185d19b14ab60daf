"""Box priors (infer/priors.py BoxPrior) against the JAX package's, and the
composition of ``prior.to_theta`` into every forward of the api.

1. On the same z, float64: to_theta, from_theta and log_density equal the
   reference's to 1e-12 for a uniform, a log-uniform, a mixed and a
   ``low = 0`` uniform box; so does the gradient through to_theta (finite
   for ``low = 0``, the unselected log branch guarded).
2. tests/test_priors.py's push-forward checks (log-uniform and uniform
   boxes: the samples' KS distance, mean and variance) and the round trip,
   on a torch.Generator.
3. pcn on a converted float64 res1 pipeline under log_uniform [0.1, 10]:
   the port's ``run_inversion``, its draws replaced by the reference's
   (JAX's prior draws for the chains' start, JAX's normals and uniforms for
   every step), gives JAX's ``run_inversion`` samples to 1e-10; the
   synthetic truth's FOM solve goes through to_theta on both sides.
4. Under a narrow box every forward the api evaluates (run_inversion with
   pcn, mala, da_pcn, pt_pcn and init="eki", and the EKI, ADVI, SVGD, PSIS,
   SMC, flow-VI, flow-PSIS and NeuTra drivers) receives log k inside the
   box: the samplers' z never reaches a forward uncomposed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu import config as jcfg
from bayesianinferencedl_tpu.api import run_inversion as j_run_inversion
from bayesianinferencedl_tpu.infer.priors import BoxPrior as JBoxPrior
from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch import config as tcfg
from bayesianinferencedl_tpu_torch.convert import pipeline_from_arrays
from bayesianinferencedl_tpu_torch.infer.priors import BoxPrior
from test_torch_slice import _arrays, _cfg, jax_build

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D = 5
F64 = torch.float64


def _pair(low, high, is_log):
    """The same box on both sides, float64, per-component kinds."""
    low, high, is_log = (np.broadcast_to(np.asarray(v, np.float64), (D,)) for v in (low, high, is_log))
    j = JBoxPrior(mean=jnp.zeros(D), chol=jnp.eye(D), low=jnp.asarray(low), high=jnp.asarray(high),
                  is_log=jnp.asarray(is_log))
    t = BoxPrior(mean=torch.zeros(D, dtype=F64), chol=torch.eye(D, dtype=F64),
                 low=torch.tensor(low), high=torch.tensor(high), is_log=torch.tensor(is_log))
    return j, t


BOXES = {
    "uniform": (0.5, 4.0, 0.0),
    "log_uniform": (0.1, 10.0, 1.0),
    "mixed": ([0.1, 0.5, 0.2, 1.0, 0.3], [10.0, 4.0, 5.0, 3.0, 8.0], [1.0, 0.0, 1.0, 0.0, 0.0]),
    "uniform_low0": (0.0, 2.0, 0.0),
}


@pytest.mark.parametrize("box", list(BOXES))
def test_box_functions_and_gradient_match_reference(box):
    jp, tpr = _pair(*BOXES[box])
    z = np.random.default_rng(3).normal(0.0, 1.5, (64, D))
    th_j = np.asarray(jp.to_theta(jnp.asarray(z)))
    zt = torch.tensor(z, requires_grad=True)
    th_t = tpr.to_theta(zt)
    np.testing.assert_allclose(th_t.detach().numpy(), th_j, rtol=1e-12, atol=1e-12)
    w = np.random.default_rng(4).normal(size=(64, D))
    g_j = np.asarray(jax.grad(lambda x: jnp.sum(jp.to_theta(x) * w))(jnp.asarray(z)))
    (g_t,) = torch.autograd.grad(torch.sum(th_t * torch.tensor(w)), zt)
    assert np.all(np.isfinite(g_t.numpy()))
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tpr.from_theta(torch.tensor(th_j)).numpy(),
                               np.asarray(jp.from_theta(jnp.asarray(th_j))), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tpr.log_density(torch.tensor(z)).numpy(), np.asarray(jp.log_density(z)),
                               rtol=1e-12)
    for f in ("whiten", "unwhiten", "precision_apply"):
        assert torch.equal(getattr(tpr, f)(zt.detach()), zt.detach())


def _ks_against_uniform(x, lo, hi):
    u = np.sort((np.asarray(x) - lo) / (hi - lo))
    n = len(u)
    grid = np.arange(1, n + 1) / n
    return max(np.max(np.abs(grid - u)), np.max(np.abs(u - np.arange(n) / n)))


def test_pushforward_distributions_and_roundtrip():
    prior = BoxPrior.create(3, low=0.1, high=10.0, kind="log_uniform", dtype=F64, device="cpu")
    th = prior.to_theta(prior.sample(torch.Generator().manual_seed(0), (20000,))).numpy()
    lo, hi = np.log(0.1), np.log(10.0)
    assert th.min() >= lo - 1e-9 and th.max() <= hi + 1e-9
    for i in range(3):
        assert _ks_against_uniform(th[:, i], lo, hi) < 0.015
    np.testing.assert_allclose(th.mean(0), (lo + hi) / 2, atol=0.05)
    np.testing.assert_allclose(th.var(0), (hi - lo) ** 2 / 12, rtol=0.05)

    prior = BoxPrior.create(2, low=0.5, high=4.0, kind="uniform", dtype=F64, device="cpu")
    k = np.exp(prior.to_theta(prior.sample(torch.Generator().manual_seed(1), (20000,))).numpy())
    assert k.min() >= 0.5 - 1e-9 and k.max() <= 4.0 + 1e-9
    for i in range(2):
        assert _ks_against_uniform(k[:, i], 0.5, 4.0) < 0.015
    np.testing.assert_allclose(k.mean(0), 2.25, atol=0.03)
    np.testing.assert_allclose(k.var(0), 3.5**2 / 12, rtol=0.05)

    for kind in ("uniform", "log_uniform"):
        prior = BoxPrior.create(4, low=0.1, high=10.0, kind=kind, dtype=F64, device="cpu")
        z = torch.linspace(-4.0, 4.0, 33, dtype=F64)[:, None] * torch.ones(4, dtype=F64)
        np.testing.assert_allclose(prior.from_theta(prior.to_theta(z)).numpy(), z.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="kind"):
        BoxPrior.create(2, kind="normal", device="cpu")


C, N_STEPS, N_BURN = 16, 40, 20
BOX_CFG = dict(kind="log_uniform", low=0.1, high=10.0)


@pytest.fixture(scope="module")
def box_pipes():
    jpipe = jax_build(_cfg(1e-10, jcfg), jnp.float64)
    mcmc = dict(n_chains=C, n_steps=N_STEPS, n_burn=N_BURN, sampler="pcn", likelihood="rom_nn")
    jc = dataclasses.replace(_cfg(1e-10, jcfg, **mcmc), prior=jcfg.PriorConfig(**BOX_CFG))
    jbox = dataclasses.replace(jpipe, config=jc, prior=JBoxPrior.create(D, dtype=jnp.float64, **BOX_CFG))
    tc = dataclasses.replace(_cfg(1e-10, **mcmc), prior=tcfg.PriorConfig(**BOX_CFG))
    tbox = pipeline_from_arrays(tc, _arrays(jpipe), device="cpu", dtype=F64)
    assert isinstance(tbox.prior, BoxPrior)
    return jbox, tbox


def test_box_prior_pcn_replays_reference_run_inversion(box_pipes, monkeypatch):
    jbox, tbox = box_pipes
    key = jax.random.PRNGKey(21)
    jinv = j_run_inversion(jbox, key=key)
    k_true, k_noise, k_init, k_chain, _ = jax.random.split(key, 5)
    z_true = np.asarray(jbox.prior.sample(k_true))
    theta0 = np.asarray(jbox.prior.sample(k_init, (C,)))
    k_burn, k_main = jax.random.split(jax.random.fold_in(k_chain, 1))
    keys = list(jax.random.split(k_burn, N_BURN)) + list(jax.random.split(k_main, N_STEPS - N_BURN))
    nrm, uni = [], []
    for k in keys:
        k_prop, k_acc = jax.random.split(k)
        nrm.append(np.asarray(jax.random.normal(k_prop, (C, D), jnp.float64)))
        uni.append(np.asarray(jax.random.uniform(k_acc, (C,), jnp.float64)))
    plain = api.run_pcn

    def replay(misfit_b, prior, th0, gen, *, n_steps, n_burn, **kw):
        if n_steps != N_STEPS:  # the warm-up run
            return plain(misfit_b, prior, th0, gen, n_steps=n_steps, n_burn=n_burn, **kw)
        return plain(misfit_b, prior, torch.tensor(theta0), n_steps=n_steps, n_burn=n_burn,
                     normals=torch.tensor(np.stack(nrm)), uniforms=torch.tensor(np.stack(uni)), **kw)

    monkeypatch.setattr(api, "run_pcn", replay)
    tinv = api.run_inversion(tbox, data=torch.tensor(np.asarray(jinv.data)), theta_true=torch.tensor(z_true))
    np.testing.assert_allclose(tinv.result.samples.numpy(), np.asarray(jinv.result.samples),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tinv.result.accept_rate.numpy(), np.asarray(jinv.result.accept_rate),
                               rtol=1e-6)  # float32 rates on both sides
    # the synthetic truth: the FOM solve of to_theta(z_true), then the noise
    gen = torch.Generator().manual_seed(5)
    _, data = api._observations(tbox, gen, torch.tensor(z_true), None)
    noise = 1e-2 * torch.randn(data.shape, generator=torch.Generator().manual_seed(5), dtype=F64)
    y_true_j = np.asarray(jinv.data) - 1e-2 * np.asarray(jax.random.normal(k_noise, (D,), jnp.float64))
    np.testing.assert_allclose((data - noise).numpy(), y_true_j, rtol=1e-8)


def test_every_api_forward_composes_to_theta(box_pipes, monkeypatch):
    """A narrow box (k in [0.9, 1.1]): prior draws z are far outside its
    log k range, so any forward handed z instead of to_theta(z) trips."""
    _, tbox = box_pipes
    narrow = dict(kind="log_uniform", low=0.9, high=1.1)
    cfg = dataclasses.replace(tbox.config, prior=tcfg.PriorConfig(**narrow))
    pipe = dataclasses.replace(tbox, config=cfg, prior=BoxPrior.create(D, dtype=F64, device="cpu", **narrow))
    lo, hi = np.log(0.9) - 1e-12, np.log(1.1) + 1e-12
    calls = []
    plain = api.Pipeline.batched_forward_fn

    def checked(self, likelihood, *, differentiable=False):
        f = plain(self, likelihood, differentiable=differentiable)

        def g(th):
            calls.append(likelihood)
            assert float(th.min()) >= lo and float(th.max()) <= hi, "a forward got uncomposed z"
            return f(th)

        return g

    monkeypatch.setattr(api.Pipeline, "batched_forward_fn", checked)
    mc = dict(n_chains=8, n_steps=6, n_burn=2, n_temps=2, subchain=2, mala_step=0.05)
    for smp, like, init in (("pcn", "rom_nn", "prior"), ("mala", "rom_nn", "prior"),
                            ("da_pcn", "rom", "prior"), ("pt_pcn", "rom_nn", "prior"),
                            ("pcn", "rom_nn", "eki")):
        p = dataclasses.replace(pipe, config=dataclasses.replace(cfg, mcmc=dataclasses.replace(
            cfg.mcmc, sampler=smp, likelihood=like, **mc)))
        inv = api.run_inversion(p, init=init)
        assert torch.isfinite(inv.result.samples).all()
    gen = lambda: torch.Generator().manual_seed(3)
    res, _, data, _ = api.run_eki_inversion(pipe, n_ensemble=16, generator=gen())
    vi, _, _, _ = api.run_vi_inversion(pipe, n_steps=4, n_mc=4, generator=gen())
    api.run_svgd_inversion(pipe, n_particles=8, n_steps=3, generator=gen())
    api.psis_certify(pipe, vi.theta_mean, vi.theta_chol, data, n_draws=32, generator=gen())
    api.run_smc_evidence(pipe, n_particles=32, n_groups=2, n_mutations=1, max_stages=4, generator=gen())
    flow, _, _, _ = api.run_flow_vi_inversion(pipe, n_couplings=1, hidden=4, pretrain="none", n_steps=4,
                                              n_mc=4, generator=gen())
    api.psis_certify_flow(pipe, flow, data, n_draws=32, generator=gen())
    api.run_neutra_inversion(pipe, flow, data, n_chains=8, n_steps=4, n_burn=2, generator=gen())
    assert {"rom_nn", "rom"} <= set(calls) and len(calls) > 40
