"""The port's ``map`` command at res1 on the CPU: the reference CLI's keys
(``theta_map``, ``theta_true``, ``laplace_sd_working``, ``k_map``, ``nlp``,
``prior``, and ``noise_sigma_plugin`` with ``--infer-noise``), finite, with
the MAP near the truth behind the data and positive Laplace standard
deviations; ``--psis`` with ``--infer-noise`` is refused with the
reference's SystemExit."""

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
KEYS = {"theta_map", "theta_true", "laplace_sd_working", "k_map", "nlp", "prior"}


@pytest.mark.parametrize("infer_noise", [False, True])
def test_map_prints_the_reference_keys(infer_noise, capsys):
    main(["map", *SMALL] + (["--infer-noise"] if infer_noise else []))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == KEYS | ({"noise_sigma_plugin"} if infer_noise else set())
    theta_map, sd = np.array(out["theta_map"]), np.array(out["laplace_sd_working"])
    assert theta_map.shape == sd.shape == (5,) and np.all(np.isfinite(theta_map)) and np.all(sd > 0)
    np.testing.assert_allclose(out["k_map"], np.exp(theta_map), rtol=1e-6)
    # at noise 1e-2 the data pin the MAP within a few Laplace sds of the truth
    assert np.all(np.abs(theta_map - np.array(out["theta_true"])) < 5 * sd + 0.05)
    assert np.isfinite(out["nlp"]) and out["prior"] == "gaussian"
    if infer_noise:
        assert 0 < out["noise_sigma_plugin"] < 1


def test_map_psis_is_refused():
    """The certificate of the sigma-marginal potential is refused, as the
    reference refuses it (map --psis itself: test_torch_cli_approx.py)."""
    with pytest.raises(SystemExit, match="--psis with --infer-noise is unsupported"):
        main(["map", *SMALL, "--psis", "64", "--infer-noise"])
