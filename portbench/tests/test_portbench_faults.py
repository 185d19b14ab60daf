"""Each cell's check, driven through the rest of a run on the CPU (the look
for a card skipped) with the timed path broken underneath, comes out not
correct; sound runs come out correct. The faults: a step that returns its
state unchanged, half of the batch left out, and an answer altered where it
is produced. (No cell exchanges anything between chips.)"""

import pytest
import torch

from portbench.tests.tiny import tiny_run


@pytest.mark.parametrize("cell", ["fin5_res8.da_fom", "fin5_res32.fom_sweep"])
def test_sound_runs_are_correct(cell):
    run, out = tiny_run(cell, 31)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == set(run.cell.end_to_end)


def _da_fault(monkeypatch, kind):
    from bayesianinferencedl_tpu_torch import api
    from bayesianinferencedl_tpu_torch.infer import delayed_acceptance as da

    real_step, real_solver = da.da_step, api.make_fom_solver
    if kind == "unchanged":
        def step(*a, **k):
            new, acc, n_inner = real_step(*a, **k)
            state = a[4]
            return state, torch.zeros_like(acc), n_inner

        monkeypatch.setattr(da, "da_step", step)
    elif kind == "half":
        def step(*a, **k):
            new, acc, n_inner = real_step(*a, **k)
            old, h = a[4], acc.shape[0] // 2
            keep = lambda x, y: torch.cat([x[:h], y[h:]])
            return type(new)(*(keep(x, y) for x, y in zip(new, old))), keep(acc, torch.zeros_like(acc)), n_inner

        monkeypatch.setattr(da, "da_step", step)
    else:
        def solver(*a, **k):
            solve = real_solver(*a, **k)
            if not k.get("with_iters"):  # the build's solves
                return solve

            def altered(ks, x0=None):
                u, its = solve(ks, x0)
                return u * 1.01, its

            return altered

        monkeypatch.setattr(api, "make_fom_solver", solver)


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_da_faults_are_not_correct(monkeypatch, kind):
    _da_fault(monkeypatch, kind)
    _, out = tiny_run("fin5_res8.da_fom", 32)
    assert not out["correct"], out["checks"]


def _build_fault(monkeypatch, kind):
    from bayesianinferencedl_tpu_torch import api

    if kind == "pod_trailing_modes":  # the eigenpairs taken in eigh's ascending order
        real_pod = api.pod_basis_host

        def pod(snapshots, r):
            V, sv = real_pod(snapshots, min(snapshots.shape))
            return V[:, -r:], sv

        monkeypatch.setattr(api, "pod_basis_host", pod)
    else:  # the error model trained on the FOM's observables, not the ROM's error
        real_dataset = api.generate_error_dataset

        def dataset(*a, **k):
            ds = real_dataset(*a, **k)
            return ds._replace(error=ds.y_fom)

        monkeypatch.setattr(api, "generate_error_dataset", dataset)


@pytest.mark.parametrize("kind", ["pod_trailing_modes", "wrong_error_targets"])
def test_a_faulty_build_is_not_correct(monkeypatch, kind):
    """A fault in the build (the POD basis, the trained error model): the
    window's coarse forward follows the package's state faithfully, so only
    ``model_gap``, which holds the ROM+NN that state makes against the
    reference's full-order solve, can fail it."""
    _build_fault(monkeypatch, kind)
    _, out = tiny_run("fin5_res8.da_fom", 34)
    assert not out["correct"], out["checks"]
    assert out["checks"]["model_gap"]["value"] > out["checks"]["model_gap"]["limit"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_sweep_faults_are_not_correct(monkeypatch, kind):
    from bayesianinferencedl_tpu_torch import api

    real_solver = api.make_fom_solver

    def solver(*a, **k):
        solve = real_solver(*a, **k)
        if not k.get("with_iters"):
            return solve

        def broken(ks, x0=None):
            u, its = solve(ks, x0)
            if kind == "unchanged":  # the solve hands back its start
                return torch.zeros_like(u), torch.zeros_like(its)
            if kind == "half":
                h = u.shape[0] // 2
                return torch.cat([u[:h], torch.zeros_like(u[h:])]), its
            return u * 1.01, its

        return broken

    monkeypatch.setattr(api, "make_fom_solver", solver)
    _, out = tiny_run("fin5_res32.fom_sweep", 33, seconds=1.0)
    assert not out["correct"], out["checks"]
