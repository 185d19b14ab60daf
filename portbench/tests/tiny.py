"""Tiny CPU versions of the benchmark's cells for the tests: the same
drivers, files and checks at sizes a test run holds."""

from __future__ import annotations

import copy

import torch

from portbench import harness

TINY = {
    "fin5_res8.da_fom": (dict(resolution=2, n_snapshots=64, basis_size=24, n_train=128, epochs=5),
                          dict(chains=32, subchain=8, burn_in=2, check_chains=8, check_steps=2)),
    "fin5_res32.fom_sweep": (dict(resolution=2, cg_maxiter=480), dict(batch=8, check_per_batch=2)),
}


def tiny_cell(name: str, spec: dict | None = None, bench=harness.BENCH):
    cell = harness.find_cell(spec or harness.load_spec(bench.parent), name, bench)
    cell = copy.deepcopy(cell)
    cfg, params = TINY[name]
    cell.config.update(cfg)
    cell.mix["params"].update(params)
    return cell


def tiny_run(name: str, seed: int, *, seconds: float = 0.6, trace: bool = False, control=False,
             cell=None, bench=harness.BENCH):
    """(run, result line) of one tiny CPU run; control=True puts the
    driver's control in the package's place."""
    cell = cell or tiny_cell(name, bench=bench)
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=torch.device("cpu"))
    module = harness.load_module(cell.bench / "drivers" / f"{cell.mix['driver']}.py")
    driver = module
    if control:
        class WithControl:
            @staticmethod
            def setup(r):
                st = module.setup(r)
                module.control(r, st)
                return st

            window, check = module.window, module.check

        driver = WithControl
    return run, harness.execute(run, driver)
