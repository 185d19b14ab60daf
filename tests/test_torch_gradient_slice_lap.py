"""run_inversion with mala_lap and hmc_lap (the Laplace-preconditioned
gradient samplers: a MAP, its Laplace approximation, then MALA or HMC in
its frame) on test_torch_gradient_slice.py's converted float64 res2
pipeline, under that file's checks."""

import pytest
import torch

from test_torch_gradient_slice import pipe, run_and_check  # noqa: F401 (pipe is a fixture)

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs


@pytest.mark.parametrize("sampler", ["mala_lap", "hmc_lap"])
def test_run_inversion_runs_each_laplace_gradient_sampler(pipe, sampler):  # noqa: F811
    run_and_check(pipe, sampler, "rom_nn", {})
