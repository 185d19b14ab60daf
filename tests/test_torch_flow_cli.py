"""The port's ``vi --flow`` at res1 on the CPU: the reference CLI's JSON keys
(``_cmd_vi_flow``) with finite values, for the SMC-pretrained flow with its
PSIS certificate through a widened base and NeuTra, and for plain annealed
flow-VI (``--flow-pretrain none --steps``). The driver is wrapped so that
the test records what the command hands it (couplings, pretraining, steps,
draws, learning rate) and, on the SMC route, runs the pretraining on 256
particles over 100 MLE steps in place of the defaults' 2,048 and 2,000;
every other default stands."""

import json

import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch.cli import main
from test_torch_slice import cached_build_pipeline

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs


@pytest.fixture(autouse=True)
def _one_build_per_config(monkeypatch):
    """The commands' pipelines built once for the file (test_torch_slice.cached_build_pipeline)."""
    monkeypatch.setattr(api, "build_pipeline", cached_build_pipeline)


SMALL = ["--device", "cpu", "--resolution", "1", "--n-snapshots", "32", "--r", "8", "--n-train", "64",
         "--epochs", "5", "--noise", "1e-2"]
SUMMARY = {"wall_seconds", "posterior_mean_log_k", "posterior_std_log_k", "theta_true", "mean_abs_err"}
FLOW_KEYS = SUMMARY | {"likelihood", "family", "n_forward_evals"}
PSIS_KEYS = {"n_draws", "base_scale", "k_hat", "reliable", "ess", "corrected_mean_log_k"}
NEUTRA_KEYS = {"n_steps", "rhat_split_max", "ess_bulk_min", "accept_rate", "posterior_mean_log_k",
               "wall_seconds"}
SMALL_SMC = dict(pretrain_particles=256, pretrain_steps=100)


def flow_spy(monkeypatch) -> dict:
    """Wrap api.run_flow_vi_inversion: record its keyword arguments and run
    the SMC pretraining at SMALL_SMC's sizes."""
    seen = {}
    run = api.run_flow_vi_inversion

    def spy(pipe, likelihood, **kw):
        seen.update(kw, likelihood=likelihood)
        return run(pipe, likelihood, **kw, **(SMALL_SMC if kw["pretrain"] == "smc" else {}))

    monkeypatch.setattr(api, "run_flow_vi_inversion", spy)
    return seen


def run_cli(argv, capsys) -> dict:
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def finite_summary(out):
    for k in ("posterior_mean_log_k", "posterior_std_log_k", "theta_true"):
        assert len(out[k]) == 5 and np.all(np.isfinite(out[k]))
    assert np.all(np.array(out["posterior_std_log_k"]) > 0) and np.isfinite(out["mean_abs_err"])


def test_vi_flow_smc_psis_widen_and_neutra(monkeypatch, capsys):
    seen = flow_spy(monkeypatch)
    out = run_cli(["vi", *SMALL, "--flow", "2", "--psis", "64", "--neutra", "40", "--psis-widen", "1.5"],
                  capsys)
    assert seen["n_couplings"] == 2 and seen["pretrain"] == "smc" and seen["n_steps"] is None
    assert set(out) == FLOW_KEYS | {"psis", "neutra"}
    assert out["family"] == "flow (couplings=2, pretrain=smc)" and out["n_forward_evals"] == 0
    finite_summary(out)
    p = out["psis"]
    assert set(p) == PSIS_KEYS and p["n_draws"] == 64 and p["base_scale"] == 1.5
    assert np.isfinite(p["k_hat"]) and p["ess"] > 0 and np.all(np.isfinite(p["corrected_mean_log_k"]))
    n = out["neutra"]
    assert set(n) == NEUTRA_KEYS and n["n_steps"] == 40 and 0.0 <= n["accept_rate"] <= 1.0
    assert np.isfinite(n["rhat_split_max"]) and np.all(np.isfinite(n["posterior_mean_log_k"]))


def test_vi_flow_pretrain_none_runs_steps(monkeypatch, capsys):
    seen = flow_spy(monkeypatch)
    steps = 30
    out = run_cli(["vi", *SMALL, "--flow", "2", "--flow-pretrain", "none", "--steps", str(steps),
                   "--mc", "8", "--lr", "0.01"], capsys)
    assert (seen["pretrain"], seen["n_steps"], seen["n_mc"], seen["lr"]) == ("none", steps, 8, 0.01)
    assert set(out) == FLOW_KEYS and out["family"] == "flow (couplings=2, pretrain=none)"
    assert out["n_forward_evals"] == steps * 8
    finite_summary(out)
