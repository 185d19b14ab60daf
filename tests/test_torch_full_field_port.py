"""The port's own full-field build and its commands on the CPU.

1. build_full_field_pipeline end to end at res2 (float32): finite errors,
   the "fom_solve" events; every sampler of run_full_field_inversion at a
   few steps (the MAP-seeded ones on a 4-feature float64 build), the
   evidence, select_correlation_length, prediction and the approximation
   layer.
2. The commands (invert-ff, sbc-ff, evidence-ff, select-ell) on the
   reference's argv at tiny sizes (res1, 8 features) print the reference
   CLI's JSON keys (cmd_invert_ff, cmd_sbc_ff, cmd_evidence_ff and
   cmd_select_ell of the JAX package's cli.py); the same argv parses in the
   reference's parser."""

import argparse
import json

import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu import cli as jcli
from bayesianinferencedl_tpu_torch import api_full_field as aff
from bayesianinferencedl_tpu_torch import cli as tcli
from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

M, NOISE = 16, 1e-2

BUILD = ["--resolution", "1", "--n-snapshots", "16", "--r", "4", "--k-basis", "8", "--n-features", "8",
         "--n-train", "32", "--epochs", "2"]
INVERT_KEYS = {"likelihood", "sampler", "n_features", "samples_per_sec", "ess_min", "accept_rate",
               "rhat_split_max", "data_misfit_posterior_mean", "data_misfit_prior_mean", "ppc_p_value"}
CASES = {
    "invert": (["invert-ff", *BUILD, "--chains", "8", "--steps", "20", "--burn", "10", "--noise", "1e-2"],
               INVERT_KEYS),
    "invert_da": (["invert-ff", *BUILD, "--chains", "8", "--steps", "4", "--burn", "2", "--noise", "1e-2",
                   "--sampler", "da_pcn", "--likelihood", "fom", "--subchain", "2", "--infer-noise",
                   "--predict-at", "0,0.5", "--shard"],
                  INVERT_KEYS | {"noise_sigma_post", "predictions"}),
    "sbc": (["sbc-ff", *BUILD, "--datasets", "4", "--sbc-chains", "7", "--steps", "20", "--burn", "10"],
            {"likelihood", "sampler", "noise_sigma", "n_features", "n_datasets", "n_posterior_draws",
             "p_min", "sidak_threshold_alpha01", "n_below_sidak", "calibrated", "accept_rate"}),
    "evidence": (["evidence-ff", *BUILD, "--particles", "32", "--groups", "2", "--mutations", "1",
                  "--noise", "1e-2"],
                 {"likelihood", "n_features", "estimator", "log_evidence", "log_evidence_std", "n_stages",
                  "n_particles", "wall_seconds"}),
    "select_ell": (["select-ell", "--resolution", "1", "--ells", "0.5", "2", "--ell-true", "1",
                    "--n-features", "8", "--particles", "16", "--groups", "2", "--mutations", "1",
                    "--max-stages", "4"],
                   {"ells", "log_z", "log_z_std", "posterior", "ell_map", "n_datasets"}),
}


class _Parser(Exception):
    def __init__(self, parser):
        self.parser = parser


def _raise_parser(self, args=None, namespace=None):
    raise _Parser(self)


def test_reference_parser_takes_the_argv(monkeypatch):
    for argv, _ in CASES.values():
        with monkeypatch.context() as m:
            m.setattr(argparse.ArgumentParser, "parse_args", _raise_parser)
            with pytest.raises(_Parser) as got:
                jcli.main(argv)
        args = got.value.parser.parse_args(argv)  # an unknown flag or a bad value exits here
        assert args.fn.__name__ == "cmd_" + argv[0].replace("-", "_")


_BUILDS: dict = {}
_build = aff.build_full_field_pipeline


def _cached_build(**kw):
    """build_full_field_pipeline once per process for each argument set (the
    build is deterministic and no code of the port mutates a pipeline)."""
    key = repr(sorted((k, v) for k, v in kw.items() if k != "metrics"))
    if key not in _BUILDS:
        _BUILDS[key] = _build(**kw)
    return _BUILDS[key]


@pytest.mark.parametrize("case", list(CASES))
def test_command_prints_the_reference_keys(case, capsys, monkeypatch):
    monkeypatch.setattr(aff, "build_full_field_pipeline", _cached_build)
    argv, keys = CASES[case]
    tcli.main(argv + ["--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == keys
    if case.startswith("invert"):
        assert np.isfinite(rec["data_misfit_posterior_mean"]) and 0 <= rec["accept_rate"] <= 1
    if case == "evidence":
        assert np.isfinite(rec["log_evidence"])
    if case == "select_ell":
        assert len(rec["log_z"]) == 2 and np.isfinite(rec["log_z"]).all()


@pytest.fixture(scope="module")
def own():
    log = MetricsLogger()
    pipe = aff.build_full_field_pipeline(resolution=2, n_features=M, n_snapshots=32, basis_size=8,
                                         k_basis_size=16, n_train=64, surrogate_hidden=(16, 16),
                                         surrogate_steps=60, seed=1, device="cpu", metrics=log)
    return pipe, log


def test_own_build_end_to_end(own):
    pipe, log = own
    ev = {e["event"]: e for e in log.events}
    assert ev["fom_built"]["assembler"] in ("native", "numpy") and ev["fom_built"]["m"] == 128
    solves = [e for e in log.events if e["event"] == "fom_solve"]
    assert [e["batch"] for e in solves] == [32, 64, 64]
    assert all(e["n_at_cap"] == 0 and e["n_failed"] == 0 and e["max_iters"] > 0 for e in solves)
    for k in ("rom_rel_err", "corrected_rel_err"):
        assert np.isfinite(ev[k]["value"]) and 0 < ev[k]["value"] < 0.5
    assert np.isfinite(ev["holdout_rel_err"]["rom"]) and np.isfinite(ev["holdout_rel_err"]["corrected"])
    res, z_true, data, ess, r, wall = aff.run_full_field_inversion(
        pipe, n_chains=16, n_steps=40, n_burn=20, noise_sigma=NOISE,
        generator=torch.Generator().manual_seed(0))
    assert res.samples.shape == (20, 16, M) and torch.isfinite(res.samples).all()
    assert 0.0 < float(res.accept_rate.mean()) < 1.0 and torch.isfinite(r).all()
    pred = aff.predict_temperature_ff(pipe, res.samples, points=np.array([[0.0, 0.5]]), n_draws=16)
    assert np.isfinite(pred.mean).all() and pred.n_draws == 16
    cond = aff.predict_conductivity_ff(pipe, res.samples, n_draws=16)
    assert np.isfinite(cond.mean).all() and cond.mean.shape == (pipe.node_mesh_ids()[0].n_nodes,)


@pytest.fixture(scope="module")
def small():
    """A float64 res1 build with 4 features, where the MAP of the
    Laplace-seeded samplers converges in a few BFGS iterations (in float32
    at 16 features it runs all 300)."""
    return aff.build_full_field_pipeline(resolution=1, n_features=4, n_snapshots=16, basis_size=6,
                                         k_basis_size=8, n_train=32, surrogate_hidden=(8,),
                                         surrogate_steps=30, seed=1, device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("sampler,likelihood", [
    ("laplace_mh", "rom_nn"), ("gpcn", "rom_nn"), ("mala", "rom_nn"), ("hmc_lap", "rom_nn"),
    ("pt_pcn", "rom_nn"), ("pt_mala", "rom"), ("lis_pcn", "rom_nn"),
    ("pcn", "fom"), ("da_pcn", "fom"), ("pt_da_pcn", "fom"), ("mlda_pcn", "fom"),
])
def test_every_sampler_runs(own, small, sampler, likelihood):
    laplace = sampler in ("laplace_mh", "gpcn", "hmc_lap", "lis_pcn")
    pipe = small if laplace else own[0]
    M = pipe.prior.dim
    log = MetricsLogger()
    res, z_true, data, ess, r, wall = aff.run_full_field_inversion(
        pipe, likelihood=likelihood, sampler=sampler, n_chains=8, n_steps=6, n_burn=3,
        noise_sigma=NOISE, subchain=2, mlda_resolution=1, mlda_subchain=2, n_temps=3, lis_points=4,
        generator=torch.Generator().manual_seed(2), metrics=log)
    assert res.samples.shape[-1] == M and torch.isfinite(res.samples).all()
    ev = {e["event"]: e for e in log.events}
    assert ev["ff_inversion"]["sampler"] == sampler
    if likelihood == "fom":
        assert ev["fom_iter_audit"]["hit_cap_frac"] == 0.0
    if sampler == "lis_pcn":
        assert 1 <= ev["lis_built"]["rank"] <= 5


def test_evidence_and_approximations(own):
    pipe, _ = own
    g = lambda: torch.Generator().manual_seed(3)
    ev = aff.run_full_field_evidence(pipe, likelihood="rom_nn", noise_sigma=NOISE, n_particles=64,
                                     n_groups=2, n_mutations=2, generator=g())
    assert np.isfinite(ev.log_evidence)
    eki, z_true, data, _ = aff.run_eki_inversion_ff(pipe, noise_sigma=NOISE, n_ensemble=32, generator=g())
    vi, _, _, _ = aff.run_vi_inversion_ff(pipe, noise_sigma=NOISE, n_steps=5, n_mc=4, generator=g())
    svgd, _, _, _ = aff.run_svgd_inversion_ff(pipe, noise_sigma=NOISE, n_particles=16, n_steps=3,
                                              generator=g(), segment=2)
    cert = aff.psis_certify_ff(pipe, vi.theta_mean, vi.theta_chol, data, noise_sigma=NOISE, n_draws=64,
                               generator=g())
    for t in (eki.ensemble, vi.theta_mean, svgd.particles):
        assert torch.isfinite(t).all()
    assert np.isfinite(cert.k_hat)
    sel = aff.select_correlation_length([0.5, 2.0], resolution=1, n_features=8, noise_sigma=NOISE,
                                        ell_true=1.0, n_particles=32, n_groups=2, n_mutations=1,
                                        max_stages=8, device="cpu")
    assert len(sel["log_z"]) == 2 and np.isfinite(sel["log_z"]).all()
    assert abs(sum(sel["posterior"]) - 1.0) < 1e-3
