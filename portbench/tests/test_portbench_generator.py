"""The traffic is a function of the seed: the same seed gives the same
draws, another seed others; seeds beyond 32 bits and negative ones work."""

import numpy as np
import pytest
import torch

from portbench.yardstick.traffic import sample_log_uniform, sub_seeds


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3, -5])
def test_sub_seeds_are_deterministic_and_distinct(seed):
    a, b = sub_seeds(seed, 6), sub_seeds(seed, 6)
    assert a == b and len(set(a)) == 6
    assert all(0 <= s < 2**63 for s in a)
    assert sub_seeds(seed, 6) != sub_seeds(seed + 1, 6)


def test_log_uniform_draws_repeat_and_stay_in_the_box():
    g = lambda s: torch.Generator().manual_seed(sub_seeds(s, 1)[0])
    a, b, c = (sample_log_uniform(g(s), 4096) for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.1 * (1 - 1e-6) and float(a.max()) <= 10.0 * (1 + 1e-6)
    logs = torch.log10(a.double())
    assert abs(float(logs.mean())) < 0.02 and abs(float(logs.std()) - 2 / np.sqrt(12)) < 0.02


def test_the_frozen_copy_draws_what_the_package_draws():
    from bayesianinferencedl_tpu_torch.rom.snapshots import sample_log_uniform as package_draw

    a = sample_log_uniform(torch.Generator().manual_seed(12), 64)
    b = package_draw(torch.Generator().manual_seed(12), 64)
    assert torch.equal(a, b)


def test_a_cell_is_a_function_of_its_seed():
    from portbench import harness
    from portbench.tests.tiny import tiny_cell

    cell = tiny_cell("fin5_res32.fom_sweep")
    driver = harness.load_module(harness.BENCH / "drivers" / "fom_sweep.py")

    def first_batch(seed):
        run = harness.Run(cell=cell, seed=seed, seconds=0.1, trace=False, device=torch.device("cpu"))
        return driver.setup(run).draw()

    a, b, c = first_batch(21), first_batch(21), first_batch(22)
    assert torch.equal(a, b) and not torch.equal(a, c)
