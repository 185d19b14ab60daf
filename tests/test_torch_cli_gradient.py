"""The port's ``invert`` with the Laplace-seeded and gradient samplers at
res1 on the CPU: ``--sampler laplace_mh``, ``mala_lap`` and ``hmc`` print
the reference CLI's keys with finite values, and ``--mala-step`` and
``--hmc-leap`` reach the MCMCConfig that run_inversion reads."""

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


SMALL = ["--device", "cpu", "--resolution", "1", "--n-snapshots", "32", "--r", "8",
         "--n-train", "64", "--epochs", "5", "--chains", "8", "--steps", "24", "--burn", "12",
         "--noise", "1e-2"]


@pytest.mark.parametrize("sampler", ["laplace_mh", "mala_lap", "hmc"])
def test_invert_gradient_and_laplace_samplers(sampler, monkeypatch, capsys):
    seen = {}
    run = api.run_inversion

    def run_spy(pipe, **kw):
        seen["mcmc"] = pipe.config.mcmc
        return run(pipe, **kw)

    monkeypatch.setattr(api, "run_inversion", run_spy)
    main(["invert", *SMALL, "--sampler", sampler, "--mala-step", "0.05", "--hmc-leap", "3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    mc = seen["mcmc"]
    assert (mc.sampler, mc.mala_step, mc.hmc_leap) == (sampler, 0.05, 3)
    assert out["sampler"] == sampler and out["likelihood"] == "rom_nn"
    for k in ("samples_per_sec", "ess_min", "ess_per_sec", "accept_rate", "rhat_split_max",
              "ppc_p_value"):
        assert np.isfinite(out[k]), k
    assert 0.0 <= out["accept_rate"] <= 1.0 and len(out["posterior_mean_log_k"]) == 5
    assert np.all(np.isfinite(out["posterior_mean_log_k"]))
