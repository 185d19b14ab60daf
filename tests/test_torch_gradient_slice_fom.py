"""run_inversion with the prior-preconditioned gradient samplers and the
MALA subchains of delayed acceptance on test_torch_gradient_slice.py's
converted float64 res2 pipeline, under that file's checks: mala, hmc and
pt_mala on rom_nn; mala on fom (its gradient through the adjoint solve);
da_pcn with MALA subchains on fom; pt_da_pcn with them on rom (on fom its
evidence estimate solves 4,096 prior draws on the plain float64 PCG)."""

import pytest
import torch

from test_torch_gradient_slice import pipe, run_and_check  # noqa: F401 (pipe is a fixture)

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs


@pytest.mark.parametrize("sampler,like,extra", [
    ("mala", "rom_nn", {}),
    ("hmc", "rom_nn", {}),
    ("pt_mala", "rom_nn", {}),
    ("mala", "fom", {}),
    ("da_pcn", "fom", {"da_inner": "mala"}),
    ("pt_da_pcn", "rom", {"da_inner": "mala"}),
])
def test_run_inversion_runs_each_gradient_sampler(pipe, sampler, like, extra):  # noqa: F811
    run_and_check(pipe, sampler, like, extra)
