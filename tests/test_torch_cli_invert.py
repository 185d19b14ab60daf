"""The port's ``invert`` against the reference CLI's contract, at res1 on the
CPU: ``--dtype`` (the float64 pipeline at tol 1e-10 under the reference's
cap of 4,000; float32, the default, at 1e-7 under max(480, 120 res)),
``--data`` (the ``fom --save-obs`` round trip, with ``theta_true`` null, as
tests/test_external_data.py holds the JAX CLI), and ``build_pipeline``'s
refusal of a ROM method other than POD and the greedy basis (the greedy
build itself: tests/test_torch_greedy.py). Both CLIs run on the
same argv with their pipeline stubbed (what each hands ``build_pipeline``
and ``run_inversion``, and how each prints the same inversion result), and
the float64 FOM solve that makes the synthetic truth is held against the
JAX package's. The tempered samplers, pcn on the fom likelihood and
``--infer-noise`` run end to end and print their keys (``log_evidence``,
``log_evidence_std``, ``noise_sigma_post``); pt_pcn on fom is refused as
the reference refuses it."""

import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu import api as japi
from bayesianinferencedl_tpu import cli as jcli
from bayesianinferencedl_tpu.models.five_param import FiveParamFin as JFin
from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch.cli import main
from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
from bayesianinferencedl_tpu_torch.config import MeshConfig, PipelineConfig, ROMConfig
from test_torch_slice import cached_build_pipeline

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs


@pytest.fixture(autouse=True)
def _one_build_per_config(monkeypatch):
    """The commands' pipelines built once for the file (test_torch_slice.cached_build_pipeline)."""
    monkeypatch.setattr(api, "build_pipeline", cached_build_pipeline)


SMALL = ["--device", "cpu", "--resolution", "1", "--n-snapshots", "32", "--r", "8",
         "--n-train", "64", "--epochs", "5", "--chains", "8", "--steps", "24", "--burn", "12",
         "--noise", "1e-2"]


def test_build_pipeline_refuses_greedy():
    """The greedy basis is ported; what build_pipeline refuses now is a method
    that is neither "pod" nor "greedy" (the reference would build POD)."""
    cfg = PipelineConfig(mesh=MeshConfig(resolution=1), rom=ROMConfig(method="greedy_svd"))
    with pytest.raises(ValueError, match="'pod' or 'greedy'"):
        api.build_pipeline(cfg, device="cpu")


@pytest.fixture()
def spy(monkeypatch):
    """Record what invert hands build_pipeline and run_inversion."""
    seen = {}
    build, run = api.build_pipeline, api.run_inversion

    def build_spy(cfg, **kw):
        seen["cfg"], seen["dtype"] = cfg, kw.get("dtype")
        return build(cfg, **kw)

    def run_spy(pipe, **kw):
        seen["data"] = kw.get("data")
        return run(pipe, **kw)

    monkeypatch.setattr(api, "build_pipeline", build_spy)
    monkeypatch.setattr(api, "run_inversion", run_spy)
    return seen


def test_invert_float64(spy, capsys):
    main(["invert", *SMALL, "--dtype", "float64"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert spy["dtype"] == torch.float64
    assert spy["cfg"].fem.cg_tol == 1e-10 and spy["cfg"].fem.cg_maxiter == 4000
    assert np.all(np.isfinite(out["posterior_mean_log_k"])) and len(out["theta_true"]) == 5


def test_save_obs_then_invert_data(spy, capsys, tmp_path):
    obs = str(tmp_path / "obs.npz")
    main(["fom", "--device", "cpu", "--resolution", "1", "--k", "1.5", "0.8", "1.2", "0.9", "1.1",
          "--save-obs", obs])
    z = np.load(obs)
    assert z["data"].shape == (5,)
    metrics = str(tmp_path / "m.jsonl")
    capsys.readouterr()
    main(["invert", *SMALL, "--data", obs, "--metrics", metrics])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["theta_true"] is None  # external data: the truth is unknown
    # the default dtype: float32 at the reference's tol and cap max(480, 120 res)
    assert spy["dtype"] == torch.float32
    assert spy["cfg"].fem.cg_tol == 1e-7 and spy["cfg"].fem.cg_maxiter == 480
    assert np.all(np.isfinite(out["posterior_mean_log_k"]))
    np.testing.assert_array_equal(spy["data"].numpy(), z["data"])
    with open(metrics) as f:
        events = [json.loads(line) for line in f]
    ext = [e for e in events if e.get("event") == "external_data"]
    assert len(ext) == 1 and ext[0]["path"] == obs and ext[0]["n_obs"] == 5


def _inversion(xp):
    """What both CLIs read from run_inversion's result (a da_pcn fom run),
    in the array type of their package."""
    ones = xp.ones((5,), dtype=xp.float64)
    return SimpleNamespace(
        result=SimpleNamespace(samples=xp.zeros((4, 8, 5), dtype=xp.float64),
                               accept_rate=xp.full((8,), 0.5), inner_accept_rate=xp.full((8,), 0.25)),
        samples_per_sec=1.0, ess=ones, ess_tail=ones, ess_per_sec=1.0, rhat=ones,
        theta_true=xp.zeros((5,), dtype=xp.float64), ppc=None, log_evidence=None,
        noise_sigma_post=None, fom_iter_cap=480, fom_iter_max=37, fom_hit_cap_frac=0.0,
    )


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_invert_matches_the_reference_cli(dtype, monkeypatch, capsys, tmp_path):
    """The same argv through both CLIs: the same tol, cap and dtype handed
    to build_pipeline, the same observations to run_inversion, and the same
    ``fom_iter_audit`` nesting and null ``theta_true`` printed."""
    obs = str(tmp_path / "obs.npz")
    np.savez(obs, data=np.array([0.9, 0.7, 0.5, 0.4, 0.3]))
    argv = ["invert", "--resolution", "1", "--n-snapshots", "32", "--r", "8", "--chains", "8",
            "--steps", "8", "--burn", "4", "--noise", "1e-2", "--sampler", "da_pcn",
            "--likelihood", "fom", "--subchain", "4", "--dtype", dtype, "--data", obs]
    seen = {}

    def stub(mod, key, xp):
        def build(cfg, **kw):
            seen[key] = {"cfg": cfg, "dtype": kw.get("dtype")}
            return SimpleNamespace(prior=SimpleNamespace(to_theta=lambda t: t))

        def run(pipe, **kw):
            seen[key]["data"] = np.asarray(kw.get("data"))
            return _inversion(xp)

        monkeypatch.setattr(mod, "build_pipeline", build)
        monkeypatch.setattr(mod, "run_inversion", run)

    stub(japi, "jax", jnp)
    stub(api, "torch", torch)
    outs = {}
    for key, fn, extra in (("jax", jcli.main, []), ("torch", main, ["--device", "cpu"])):
        fn(argv + extra)
        outs[key] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    j, t = seen["jax"], seen["torch"]
    assert (t["cfg"].fem.cg_tol, t["cfg"].fem.cg_maxiter) == (j["cfg"].fem.cg_tol, j["cfg"].fem.cg_maxiter)
    assert t["cfg"].fem.cg_maxiter == (4000 if dtype == "float64" else 480)
    assert str(t["dtype"]) == f"torch.{jnp.dtype(j['dtype']).name}" == f"torch.{dtype}"
    np.testing.assert_array_equal(t["data"], j["data"])
    assert set(outs["jax"]) <= set(outs["torch"])
    assert outs["torch"]["fom_iter_audit"] == outs["jax"]["fom_iter_audit"]
    assert set(outs["torch"]["fom_iter_audit"]) == {"cap", "max_iters", "hit_cap_frac"}
    assert outs["torch"]["theta_true"] is None and outs["jax"]["theta_true"] is None


def test_float64_truth_solve_matches_reference():
    """``FiveParamFin.forward`` in float64 (``solve_batch``'s plain-PCG branch,
    which makes ``run_inversion``'s synthetic truth) against the JAX
    package's float64 solve of the same k, both at tol 1e-10."""
    k = np.array([1.5, 0.8, 1.2, 0.9, 1.1])
    jf = JFin.create(resolution=1, dtype=jnp.float64, cg_tol=1e-10, cg_maxiter=4000)
    tf = FiveParamFin.create(resolution=1, dtype=torch.float64, device="cpu", cg_tol=1e-10,
                             cg_maxiter=4000)
    u_j = np.asarray(jf.solve(jnp.asarray(k)))
    u_t = tf.solve_batch(torch.tensor(k)[None])[0].numpy()
    assert u_t.dtype == np.float64 and u_t.shape == u_j.shape
    assert np.linalg.norm(u_t - u_j) <= 1e-8 * np.linalg.norm(u_j)
    np.testing.assert_allclose(tf.forward(torch.tensor(k)).numpy(), np.asarray(jf.forward(jnp.asarray(k))),
                               rtol=1e-10)


def test_invert_pt_pcn_prints_log_evidence(spy, capsys):
    main(["invert", *SMALL, "--sampler", "pt_pcn", "--n-temps", "3", "--lambda-min", "0.1",
          "--adapt-ladder"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    mc = spy["cfg"].mcmc
    assert (mc.sampler, mc.n_temps, mc.lambda_min, mc.adapt_ladder) == ("pt_pcn", 3, 0.1, True)
    assert np.isfinite(out["log_evidence"]) and np.isfinite(out["log_evidence_std"])
    assert out["log_evidence_std"] >= 0 and "noise_sigma_post" not in out
    assert np.all(np.isfinite(out["posterior_mean_log_k"]))


def test_invert_infer_noise_prints_noise_posterior(spy, capsys):
    main(["invert", *SMALL, "--infer-noise"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert spy["cfg"].mcmc.infer_noise is True and spy["cfg"].mcmc.adapt_ladder is False
    post = out["noise_sigma_post"]
    assert set(post) == {"sigma_mean", "sigma_sd", "sigma_q05", "sigma_q50", "sigma_q95", "n_draws",
                         "n_obs"}
    assert 0 < post["sigma_q05"] < post["sigma_q50"] < post["sigma_q95"] and post["n_obs"] == 5
    assert 0.0 <= out["ppc_p_value"] <= 1.0 and "log_evidence" not in out


@pytest.mark.parametrize("sampler", ["pcn", "pt_da_pcn"])
def test_invert_fom_samplers_run(sampler, capsys):
    main(["invert", *SMALL, "--sampler", sampler, "--likelihood", "fom", "--subchain", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["sampler"] == sampler and out["likelihood"] == "fom"
    audit = out["fom_iter_audit"]
    assert audit["cap"] == 480 and 0 < audit["max_iters"] < 480 and audit["hit_cap_frac"] == 0.0
    assert np.all(np.isfinite(out["posterior_mean_log_k"]))
    if sampler == "pt_da_pcn":
        assert out["outer_accept"] == out["accept_rate"] and 0.0 <= out["inner_accept"] <= 1.0
        assert np.isfinite(out["log_evidence"])
    else:
        assert "outer_accept" not in out and "log_evidence" not in out


def test_invert_pt_pcn_on_fom_is_refused():
    with pytest.raises(NotImplementedError, match="pt_da_pcn"):
        main(["invert", *SMALL, "--sampler", "pt_pcn", "--likelihood", "fom"])
