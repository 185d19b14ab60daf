"""The slice as a whole: run_inversion with each sampler this layer ports,
on a JAX float64 res2 pipeline carried over by convert.pipeline_from_arrays
(float64, where the MAP's BFGS converges in a few tens of iterations; in
float32 it runs to its 200-iteration cap, as the reference's does).

Each run finishes with finite samples, diagnostics and accept rates of the
right shapes, here laplace_mh and gpcn on rom_nn (the Laplace-seeded runs
log the MAP); mala_lap and hmc_lap are in test_torch_gradient_slice_lap.py;
mala, hmc and pt_mala on rom_nn, mala on fom (its gradient through the
adjoint solve), da_pcn with MALA subchains on fom and pt_da_pcn with them on
rom in test_torch_gradient_slice_fom.py. The ChEES route of the runner
(hmc_leap=0) runs on an analytic misfit and logs its probe table; the
refusals the reference makes (pt_mala and ChEES on fom) stand. A MAP on the
fom likelihood is not run here: its differentiable solve is the plain PCG,
whose every iteration reads back a convergence flag, and 8 starts take
minutes on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu import config as jcfg
from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch import config as tcfg
from bayesianinferencedl_tpu_torch.convert import pipeline_from_arrays
from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger
from test_torch_slice import _arrays, jax_build

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

G, D = 8, 5


def _cfg(cfg):
    return cfg.PipelineConfig(
        mesh=cfg.MeshConfig(resolution=2),
        fem=cfg.FEMConfig(biot=0.1, cg_tol=1e-10, cg_maxiter=1500),
        rom=cfg.ROMConfig(n_snapshots=16, basis_size=8),
        surrogate=cfg.SurrogateConfig(hidden=(16, 16), n_train=32, epochs=5),
        mcmc=cfg.MCMCConfig(noise_sigma=1e-2, n_chains=G, n_steps=12, n_burn=4, n_temps=3,
                            subchain=3, hmc_leap=2),
    )


@pytest.fixture(scope="module")
def pipe():
    jpipe = jax_build(_cfg(jcfg), jnp.float64)
    return pipeline_from_arrays(_cfg(tcfg), _arrays(jpipe), device="cpu", dtype=torch.float64)


def _check(inv, kept, chains):
    res = inv.result
    assert res.samples.shape == (kept, chains, D)
    trace = res.log_post if hasattr(res, "log_post") else res.phi_trace  # MHResult keeps log_post
    assert trace.shape == (kept, chains)
    for t in (res.samples, trace, res.accept_rate, inv.ess, inv.rhat, inv.data):
        assert torch.isfinite(t).all()
    assert 0.0 <= float(res.accept_rate.mean()) <= 1.0
    assert inv.samples_per_sec > 0 and 0.0 <= inv.ppc["p_value"] <= 1.0


def run_and_check(pipe, sampler, like, extra):
    """run_inversion with these MCMCConfig fields on ``pipe``, and the
    checks of the module docstring."""
    import dataclasses

    cfg = pipe.config
    p = dataclasses.replace(pipe, config=dataclasses.replace(
        cfg, mcmc=dataclasses.replace(cfg.mcmc, sampler=sampler, likelihood=like, **extra)))
    log = MetricsLogger()
    inv = api.run_inversion(p, metrics=log)
    _check(inv, 8, G)
    s = log.summary()
    if sampler in ("laplace_mh", "gpcn", "mala_lap", "hmc_lap"):
        assert np.isfinite(s["map"]["nlp"]) and len(s["map"]["theta_map"]) == D
        assert s["map_laplace"]["seconds"] > 0
    if sampler in ("pt_mala", "pt_da_pcn"):
        assert np.isfinite(inv.log_evidence) and inv.result.swap_rate.shape == (2,)
    if like == "fom":
        assert inv.fom_iter_cap == 1500 and inv.fom_hit_cap_frac == 0.0
    if sampler in ("da_pcn", "pt_da_pcn"):
        assert 0.0 < float(inv.result.inner_accept_rate.mean()) < 1.0


# a MAP each: the 8-start BFGS runs until its slowest start stops (200
# iterations of line searches), ~10 s on one thread, so the four
# Laplace-seeded samplers share two files
@pytest.mark.parametrize("sampler", ["laplace_mh", "gpcn"])
def test_run_inversion_runs_each_new_sampler(pipe, sampler):
    run_and_check(pipe, sampler, "rom_nn", {})


def test_run_inversion_refusals(pipe):
    # mlda_pcn is ported (tests/test_torch_mlda.py): it refuses any likelihood but fom
    assert not hasattr(api, "_UNPORTED")
    with pytest.raises(ValueError, match="likelihood='fom'"):
        api.run_inversion(pipe, sampler="mlda_pcn", likelihood="rom_nn")
    with pytest.raises(NotImplementedError, match="pt_mala with the fom likelihood"):
        api.run_inversion(pipe, sampler="pt_mala", likelihood="fom")
    import dataclasses

    auto = dataclasses.replace(pipe, config=dataclasses.replace(
        pipe.config, mcmc=dataclasses.replace(pipe.config.mcmc, hmc_leap=0)))
    with pytest.raises(ValueError, match="hmc_leap=0"):
        api.run_inversion(auto, sampler="hmc", likelihood="fom")
    with pytest.raises(ValueError, match="unknown sampler"):
        api.run_inversion(pipe, sampler="nuts")


def test_chees_route_of_the_runner_logs_its_probe_table():
    """hmc_leap=0: the runner picks the trajectory length by ChEES and logs
    the probe table as the "chees" event; its warm-up is fixed-length."""
    from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior

    prior = GaussianPrior.iid(2, sigma=1.0, dtype=torch.float64, device="cpu")
    misfit = lambda x: 0.5 * torch.sum((x - 0.3) ** 2, -1) / 0.25
    gen = torch.Generator().manual_seed(0)
    log = MetricsLogger()
    run, warm = api._gradient_sampler_runner("hmc", "rom_nn", misfit, prior, prior.sample(gen, (16,)),
                                             step=0.1, thin=1, n_leap=0, jitter=0.2, log=log)
    assert warm(gen, 6, 3).samples.shape == (3, 16, 2) and "chees" not in log.summary()
    res = run(gen, 40, 20)
    info = log.summary()["chees"]
    assert res.samples.shape == (20, 16, 2) and torch.isfinite(res.samples).all()
    assert info["candidates"] == [1, 2, 4, 8, 16, 32] and info["n_leap"] in info["candidates"]
    assert len(info["chees_per_grad"]) == 6
