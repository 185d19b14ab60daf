"""The port's approximation commands at res1 on the CPU (``eki``, ``vi``,
``svgd``, ``evidence``, ``map --psis``, ``invert --init``): each prints the
reference CLI's JSON keys with finite values; ``--psis`` adds the
reference's ``psis`` block; ``vi --flow N`` runs the normalizing flow and
prints its keys, and without ``--flow`` the flow-only flags ``--neutra``
and ``--psis-widen`` are ignored, as in the reference (plain ADVI)."""

import json

import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch.cli import main
from test_torch_flow_cli import FLOW_KEYS, flow_spy
from test_torch_slice import cached_build_pipeline

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs


@pytest.fixture(autouse=True)
def _one_build_per_config(monkeypatch):
    """The commands' pipelines built once for the file (test_torch_slice.cached_build_pipeline)."""
    monkeypatch.setattr(api, "build_pipeline", cached_build_pipeline)


SMALL = ["--device", "cpu", "--resolution", "1", "--n-snapshots", "32", "--r", "8", "--n-train", "64",
         "--epochs", "5", "--noise", "1e-2"]
SUMMARY = {"wall_seconds", "posterior_mean_log_k", "posterior_std_log_k", "theta_true", "mean_abs_err"}
PSIS_WORKING = {"n_draws", "k_hat", "reliable", "ess", "corrected_mean_working", "log_evidence"}


def _run(argv, capsys) -> dict:
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _finite_summary(out):
    for k in ("posterior_mean_log_k", "posterior_std_log_k", "theta_true"):
        assert len(out[k]) == 5 and np.all(np.isfinite(out[k]))
    assert np.all(np.array(out["posterior_std_log_k"]) > 0) and np.isfinite(out["mean_abs_err"])


def _psis(block, keys, n):
    assert set(block) == keys and block["n_draws"] == n
    assert np.isfinite(block["k_hat"]) and block["ess"] > 0


def test_eki_prints_the_reference_keys(capsys):
    out = _run(["eki", *SMALL, "--ensemble", "64", "--psis", "256"], capsys)
    assert set(out) == SUMMARY | {"likelihood", "n_ensemble", "n_iters", "n_forward_evals",
                                  "misfit_trace", "tempering_knots", "psis"}
    _finite_summary(out)
    assert out["tempering_knots"][0] == 0.0 and out["tempering_knots"][-1] == 1.0
    assert out["n_forward_evals"] == 64 * (out["n_iters"] + 1) == 64 * len(out["misfit_trace"])
    _psis(out["psis"], PSIS_WORKING, 256)


def test_vi_prints_the_reference_keys(capsys):
    out = _run(["vi", *SMALL, "--steps", "60", "--mc", "8", "--psis", "256"], capsys)
    assert set(out) == SUMMARY | {"likelihood", "rank", "n_steps", "n_mc", "n_forward_evals",
                                  "elbo_first_last", "psis"}
    _finite_summary(out)
    assert out["n_forward_evals"] == 480 and np.all(np.isfinite(out["elbo_first_last"]))
    _psis(out["psis"], {"n_draws", "k_hat", "reliable", "ess", "corrected_mean_log_k"}, 256)


def test_svgd_prints_the_reference_keys(capsys):
    out = _run(["svgd", *SMALL, "--particles", "32", "--steps", "30", "--psis", "256"], capsys)
    assert set(out) == SUMMARY | {"likelihood", "n_particles", "n_steps", "n_forward_evals",
                                  "misfit_first_last", "psis"}
    _finite_summary(out)
    assert out["n_forward_evals"] == 960 and out["misfit_first_last"][1] < out["misfit_first_last"][0]
    _psis(out["psis"], PSIS_WORKING, 256)


def test_evidence_prints_the_reference_keys(capsys):
    out = _run(["evidence", *SMALL, "--particles", "256", "--groups", "4", "--mutations", "2"], capsys)
    assert set(out) == {"likelihood", "estimator", "log_evidence", "log_evidence_std", "n_stages",
                        "n_particles", "posterior_mean_log_k", "theta_true", "wall_seconds"}
    assert np.isfinite(out["log_evidence"]) and out["log_evidence_std"] >= 0
    assert len(out["n_stages"]) == 4 and max(out["n_stages"]) < 64


def test_map_psis_certifies_the_laplace_fit(capsys):
    out = _run(["map", *SMALL, "--psis", "64"], capsys)
    _psis(out["psis"], PSIS_WORKING, 64)
    assert len(out["psis"]["corrected_mean_working"]) == 5


def test_invert_init_eki(capsys):
    out = _run(["invert", *SMALL, "--chains", "16", "--steps", "40", "--burn", "10", "--init", "eki"],
               capsys)
    assert len(out["posterior_mean_log_k"]) == 5 and np.all(np.isfinite(out["posterior_mean_log_k"]))


@pytest.mark.parametrize("flag", [["--flow", "2"], ["--neutra", "100"], ["--psis-widen", "1.5"]])
def test_vi_flow_is_refused(flag, monkeypatch, capsys):
    """The flow flags as the reference's ``cmd_vi`` takes them (it branches
    only on --flow > 0): --flow 2 runs the flow (its SMC pretraining at
    test_torch_flow_cli's small sizes) and prints the flow's keys; --neutra
    and --psis-widen without --flow run plain ADVI and print ADVI's."""
    seen = flow_spy(monkeypatch)
    out = _run(["vi", *SMALL, "--steps", "20", "--mc", "8", *flag], capsys)
    _finite_summary(out)
    if flag[0] == "--flow":
        assert seen["n_couplings"] == 2 and set(out) == FLOW_KEYS
        assert out["family"] == "flow (couplings=2, pretrain=smc)"
    else:
        assert not seen and set(out) == SUMMARY | {"likelihood", "rank", "n_steps", "n_mc",
                                                   "n_forward_evals", "elbo_first_last"}
        assert out["n_steps"] == 20 and out["n_forward_evals"] == 160
