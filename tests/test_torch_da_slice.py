"""The da_pcn slice as a whole: the fom likelihood and delayed acceptance
through the port's api and CLI, on the CPU at res1.

1. A float32 JAX pipeline carried into the port through
   convert.pipeline_from_arrays: the port's batched fom forward (a deflated
   batched solve through the plain version of K1/K3) matches the
   reference's vmapped FOM forward to the float32 solve tolerance.
2. run_inversion(da_pcn, fom) on the port's own build, with the sizes of
   the reference's test_da_on_fin_pipeline_fom_likelihood: shapes, outer
   accept > 0.6, fewer fine evaluations than half the coarse steps, and the
   iteration audit at the plain cap with no state at it.
3. The CLI prints the DA keys; FiveParamFin.create defaults to the card."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import _arrays

from bayesianinferencedl_tpu import config as jcfg
from bayesianinferencedl_tpu.api import build_pipeline as j_build
from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch import config as tcfg
from bayesianinferencedl_tpu_torch.convert import pipeline_from_arrays
from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D = 5


def _cfg(cfg=tcfg):
    """The reference DA test's PipelineConfig, from the port's config module
    (default) or the JAX package's (``cfg=jcfg``)."""
    return cfg.PipelineConfig(
        mesh=cfg.MeshConfig(resolution=1),
        fem=cfg.FEMConfig(biot=0.1, cg_tol=1e-7, cg_maxiter=400),
        rom=cfg.ROMConfig(n_snapshots=48, basis_size=14),
        surrogate=cfg.SurrogateConfig(hidden=(32, 32), n_train=96, epochs=60),
        mcmc=cfg.MCMCConfig(
            n_chains=32, n_steps=220, n_burn=100, beta=0.25, noise_sigma=1e-2,
            likelihood="fom", sampler="da_pcn", subchain=4, da_coarse="rom_nn",
        ),
    )


def test_fom_forward_matches_reference():
    # the FOM forward reads no trained weight: the JAX build trains for one step
    jc = _cfg(jcfg)
    jc = dataclasses.replace(jc, surrogate=dataclasses.replace(jc.surrogate, n_train=8, epochs=1))
    jpipe = j_build(jc, dtype=jnp.float32)
    tpipe = pipeline_from_arrays(_cfg(), _arrays(jpipe), device="cpu", dtype=torch.float32)
    thetas = np.random.default_rng(0).normal(0.0, 0.6, (16, D)).astype(np.float32)
    yj = np.asarray(jpipe.batched_forward_fn("fom")(jnp.asarray(thetas)))
    yt = tpipe.batched_forward_fn("fom")(torch.from_numpy(thetas))
    assert yt.dtype == torch.float32 and yt.shape == yj.shape == (16, tpipe.fin.op.n_obs)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=5e-5, atol=5e-5 * np.abs(yj).max())
    np.testing.assert_allclose(tpipe.forward_fn("fom")(torch.from_numpy(thetas[0])).numpy(), yj[0],
                               rtol=5e-5)
    # the fom solver and the audit report per-sample counts under the plain cap
    _, iters = api.make_fom_solver(tpipe.fin, tol=1e-7, maxiter=400, with_iters=True)(
        torch.exp(torch.from_numpy(thetas)))
    assert iters.shape == (16,) and int(iters.max()) < 400
    assert api.audit_fom_iters(tpipe, torch.from_numpy(thetas)) == (400, int(iters.max()), 0.0)


def test_da_pcn_fom_inversion_on_cpu():
    cfg = _cfg()
    log = MetricsLogger()
    pipe = api.build_pipeline(cfg, device="cpu", metrics=log)
    inv = api.run_inversion(pipe, metrics=log)
    res = inv.result
    assert res.samples.shape == (120, 32, D)
    for t in (res.samples, res.phi_trace, inv.ess, inv.ess_tail, inv.rhat, inv.data):
        assert torch.isfinite(t).all()
    # accurate surrogate: fine corrections nearly free
    assert float(res.accept_rate.mean()) > 0.6
    assert 0.05 < float(res.inner_accept_rate.mean()) < 0.9
    assert res.n_fine_evals == 220 + 4  # one per outer step, one per 64-step segment
    assert res.n_fine_evals < cfg.mcmc.n_steps * cfg.mcmc.subchain / 2
    assert inv.fom_iter_cap == cfg.fem.cg_maxiter and inv.fom_hit_cap_frac == 0.0
    assert 0 < inv.fom_iter_max < cfg.fem.cg_maxiter
    assert log.summary()["fom_iter_audit"]["cap"] == 400
    assert 0.0 <= inv.ppc["p_value"] <= 1.0


def test_cli_invert_da_pcn_prints_da_keys(capsys):
    from bayesianinferencedl_tpu_torch.cli import main

    main(["invert", "--device", "cpu", "--resolution", "1", "--n-snapshots", "32", "--r", "8",
          "--n-train", "64", "--epochs", "5", "--chains", "16", "--steps", "24", "--burn", "12",
          "--noise", "1e-2", "--sampler", "da_pcn", "--likelihood", "fom", "--subchain", "4",
          "--cg-maxiter", "400"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"fom_iter_audit", "outer_accept", "inner_accept"} <= set(out)
    assert set(out["fom_iter_audit"]) == {"cap", "max_iters", "hit_cap_frac"}  # the reference's nesting
    assert out["fom_iter_audit"]["cap"] == 400 and out["outer_accept"] == out["accept_rate"]
    assert 0.0 < out["inner_accept"] < 1.0 and len(out["posterior_mean_log_k"]) == D
    # MALA subchains on the differentiable rom_nn coarse model
    main(["invert", "--device", "cpu", "--resolution", "1", "--n-snapshots", "32", "--r", "8",
          "--n-train", "64", "--epochs", "1", "--chains", "8", "--steps", "6", "--burn", "3",
          "--noise", "1e-2", "--sampler", "da_pcn", "--likelihood", "fom", "--subchain", "4",
          "--da-inner", "mala", "--cg-maxiter", "400"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["fom_iter_audit"]["hit_cap_frac"] == 0.0 and 0.0 < out["inner_accept"] < 1.0
    assert np.all(np.isfinite(out["posterior_mean_log_k"]))


def test_fin_defaults_to_the_card():
    fin = FiveParamFin.create(resolution=1, device="cpu")
    assert fin.op.device.type == "cpu"
    if not torch.cuda.is_available():  # no card: the default raises, nothing falls back to the CPU
        with pytest.raises(RuntimeError, match="cuda"):
            FiveParamFin.create(resolution=1)
