"""The checkpointed chain runners (infer/checkpointed.py): a run stopped
after its first segments and resumed from its checkpoint equals an
uninterrupted run from the same generator state bit for bit (samples,
final state, adapted step sizes, accept accounting), the cases of the
reference's tests/test_resume.py on the port's own runs: pcn, da, pt,
pt_da, mala and hmc, the odd-segment refusal and a burn-only run's empty
arrays (mlda waits for its sampler). An uninterrupted checkpointed run
also equals the sampler's segmented runner on the same generator, so the
checkpoints change nothing of the draws. Float64, 16 chains, a linear
Gaussian misfit in three dimensions, the reference's step counts."""

import functools

import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu_torch.api import (
    run_da_checkpointed,
    run_hmc_checkpointed,
    run_mala_checkpointed,
    run_pcn_checkpointed,
    run_pt_checkpointed,
    run_pt_da_checkpointed,
)
from bayesianinferencedl_tpu_torch.infer.delayed_acceptance import run_da_pcn_segmented
from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit, run_pcn_segmented
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.infer.tempering import run_pt_da_segmented
from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs


def _setup():
    rng = np.random.default_rng(0)
    H = torch.tensor(rng.standard_normal((4, 3)))
    data = torch.tensor(rng.standard_normal(4))
    prior = GaussianPrior.iid(3, sigma=1.0, dtype=torch.float64, device="cpu")
    misfit = gaussian_misfit(lambda t: t @ H.T, data, 0.5)
    theta0 = prior.sample(torch.Generator().manual_seed(0), (16,))
    return misfit, prior, theta0


def _resumed(run, tmp_path, tag, seed, kw, stop):
    """(uninterrupted, resumed): the same run whole, and stopped at step
    ``stop`` then resumed, both from generator seed ``seed``; the resumed
    process starts from a generator in another state, which the checkpoint
    overwrites."""
    full = run(torch.Generator().manual_seed(seed), str(tmp_path / f"{tag}_full.npz"), False, kw)
    crash = str(tmp_path / f"{tag}_crash.npz")
    run(torch.Generator().manual_seed(seed), crash, False, {**kw, "n_steps": stop})
    log = MetricsLogger()
    resumed = run(torch.Generator().manual_seed(seed + 1000), crash, True, {**kw, "metrics": log})
    assert log.summary()[f"{tag}chain_resume"]["step"] == stop
    return full, resumed


def _equal(a, b, fields):
    get = lambda r, f: functools.reduce(getattr, f.split("."), r)
    for f in fields:
        assert torch.equal(get(a, f), get(b, f)), f


def test_resume_bit_identical(tmp_path):
    misfit, prior, theta0 = _setup()
    run = lambda g, path, resume, kw: run_pcn_checkpointed(misfit, prior, theta0, g, ckpt_path=path,
                                                           resume=resume, **kw)
    full, resumed = _resumed(run, tmp_path, "", 42, dict(n_steps=1000, n_burn=200, segment=400), 400)
    _equal(full, resumed, ("samples", "phi_trace", "state.theta", "state.phi", "beta", "accept_rate"))
    seg = run_pcn_segmented(misfit, prior, theta0, torch.Generator().manual_seed(42), n_steps=1000,
                            n_burn=200, segment=400)
    _equal(full, seg, ("samples", "phi_trace", "state.theta", "beta", "accept_rate"))


def test_checkpointed_matches_statistics(tmp_path):
    misfit, prior, theta0 = _setup()
    res = run_pcn_checkpointed(misfit, prior, theta0, torch.Generator().manual_seed(1), n_steps=3000,
                               n_burn=500, segment=1000, ckpt_path=str(tmp_path / "c.npz"), resume=False)
    assert res.samples.shape[0] == 2500
    assert 0.1 < float(torch.mean(res.accept_rate)) < 0.6  # adapted toward 0.234


def test_da_resume_bit_identical(tmp_path):
    misfit, prior, theta0 = _setup()
    misfit_c = lambda t: misfit(t) * 0.97  # a slightly-off surrogate
    run = lambda g, path, resume, kw: run_da_checkpointed(misfit, misfit_c, prior, theta0, g, ckpt_path=path,
                                                          resume=resume, **kw)
    kw = dict(n_steps=600, n_burn=150, subchain=4, segment=250)
    full, resumed = _resumed(run, tmp_path, "da_", 7, kw, 250)
    _equal(full, resumed, ("samples", "phi_trace", "state.theta", "state.phi_f", "state.phi_c", "beta",
                           "accept_rate", "inner_accept_rate"))
    assert full.n_fine_evals == resumed.n_fine_evals == 603
    seg = run_da_pcn_segmented(misfit, misfit_c, prior, theta0, torch.Generator().manual_seed(7), **kw)
    _equal(full, seg, ("samples", "state.theta", "beta", "accept_rate", "inner_accept_rate"))


def test_pt_resume_bit_identical(tmp_path):
    misfit, prior, theta0 = _setup()
    run = lambda g, path, resume, kw: run_pt_checkpointed(misfit, prior, theta0, g, ckpt_path=path,
                                                          resume=resume, **kw)
    kw = dict(n_steps=800, n_burn=200, n_temps=3, lambda_min=0.1, segment=200, adapt_ladder=True)
    full, resumed = _resumed(run, tmp_path, "pt_", 3, kw, 400)
    _equal(full, resumed, ("samples", "phi_trace", "theta", "beta", "lambdas", "accept_rate", "swap_rate",
                           "phi_level_mean", "phi2_level_mean", "ss_level_mean"))


def test_pt_da_resume_bit_identical(tmp_path):
    misfit, prior, theta0 = _setup()
    misfit_c = lambda t: misfit(t) * 0.95
    run = lambda g, path, resume, kw: run_pt_da_checkpointed(misfit, misfit_c, prior, theta0, g,
                                                             ckpt_path=path, resume=resume, **kw)
    kw = dict(n_steps=300, n_burn=100, subchain=3, n_temps=3, lambda_min=0.1, segment=100)
    full, resumed = _resumed(run, tmp_path, "ptda_", 9, kw, 100)
    _equal(full, resumed, ("samples", "phi_trace", "theta", "beta", "lambdas", "accept_rate",
                           "inner_accept_rate", "swap_rate", "ss_level_mean"))
    assert full.n_fine_evals == resumed.n_fine_evals
    seg = run_pt_da_segmented(misfit, misfit_c, prior, theta0, torch.Generator().manual_seed(9), **kw)
    _equal(full, seg, ("samples", "theta", "beta", "lambdas", "accept_rate", "swap_rate", "ss_level_mean"))


def test_mala_resume_bit_identical(tmp_path):
    misfit, prior, theta0 = _setup()
    run = lambda g, path, resume, kw: run_mala_checkpointed(misfit, prior, theta0, g, ckpt_path=path,
                                                            resume=resume, **kw)
    full, resumed = _resumed(run, tmp_path, "mala_", 13, dict(n_steps=1000, n_burn=200, segment=400), 400)
    _equal(full, resumed, ("samples", "phi_trace", "state.y", "state.grad", "step", "accept_rate"))


def test_pt_checkpointed_rejects_odd_segment(tmp_path):
    misfit, prior, theta0 = _setup()
    for run in (lambda: run_pt_checkpointed(misfit, prior, theta0, torch.Generator(), n_steps=10, segment=5,
                                            ckpt_path=str(tmp_path / "x.npz")),
                lambda: run_pt_da_checkpointed(misfit, misfit, prior, theta0, torch.Generator(), n_steps=10,
                                               segment=5, ckpt_path=str(tmp_path / "y.npz"))):
        with pytest.raises(ValueError, match="even"):
            run()


def test_checkpointed_burn_only_returns_empty_arrays(tmp_path):
    misfit, prior, theta0 = _setup()
    res = run_pcn_checkpointed(misfit, prior, theta0, torch.Generator().manual_seed(0), n_steps=100,
                               n_burn=100, segment=50, ckpt_path=str(tmp_path / "b.npz"), resume=False)
    assert res.samples.shape == (0, 16, 3) and res.phi_trace.shape == (0, 16)
    res_da = run_da_checkpointed(misfit, lambda t: misfit(t) * 0.9, prior, theta0,
                                 torch.Generator().manual_seed(1), n_steps=60, n_burn=60, subchain=2,
                                 segment=30, ckpt_path=str(tmp_path / "bd.npz"), resume=False)
    assert res_da.samples.shape == (0, 16, 3)
    # resuming a finished run with nothing kept has nothing to return
    with pytest.raises(ValueError, match="no kept sample"):
        run_pcn_checkpointed(misfit, prior, theta0, torch.Generator(), n_steps=100, n_burn=100, segment=50,
                             ckpt_path=str(tmp_path / "b.npz"), resume=True)


def test_hmc_resume_bit_identical(tmp_path):
    misfit, prior, theta0 = _setup()
    run = lambda g, path, resume, kw: run_hmc_checkpointed(misfit, prior, theta0, g, ckpt_path=path,
                                                           resume=resume, **kw)
    full, resumed = _resumed(run, tmp_path, "hmc_", 11, dict(n_steps=600, n_burn=150, n_leap=4, segment=250),
                             250)
    _equal(full, resumed, ("samples", "phi_trace", "state.y", "step", "accept_rate"))
