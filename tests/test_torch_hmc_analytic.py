"""The analytic cases of tests/test_hmc.py on the port's HMC
(infer/hmc.py) with its own torch.Generator, at that file's tolerances: the
linear-Gaussian posterior at d = 16, HMC's ESS lead per gradient over MALA,
and the Laplace frame with the segmented runner. The ESS comparison runs
1,000 trajectories where the reference runs 2,000; the two posterior cases
run 512 chains for 188 kept trajectories each (64 x 1,500 kept before, the
reference 3,000 trajectories), the chains a batch and the loop eager, to
keep the file within its time on one CPU thread; their gates are the
reference's. The replays against JAX and the ChEES case are in
test_torch_hmc.py."""

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.infer import hmc as thmc
from bayesianinferencedl_tpu_torch.infer import mala as tmala
from bayesianinferencedl_tpu_torch.infer.diagnostics import ess_bulk
from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit as t_misfit
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs


def _setup(d=16, m=24, sigma=0.5, seed=0):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((m, d))
    data = rng.standard_normal(m)
    prior = TPrior.iid(d, mean=0.0, sigma=1.0, dtype=torch.float64, device="cpu")
    Cpost = np.linalg.inv(H.T @ H / sigma**2 + np.eye(d))
    mu = Cpost @ H.T @ data / sigma**2
    Ht = torch.from_numpy(H)
    return prior, t_misfit(lambda x: x @ Ht.T, torch.from_numpy(data), sigma), mu, Cpost


def test_hmc_matches_analytic_posterior():
    prior, misfit, mu, Cpost = _setup()
    gen = torch.Generator().manual_seed(0)
    res = thmc.run_hmc(misfit, prior, prior.sample(gen, (512,)), gen, n_steps=313, n_burn=125, step=0.1,
                       n_leap=8)
    s = res.samples.reshape(-1, 16).numpy()
    np.testing.assert_allclose(s.mean(0), mu, atol=0.05)
    np.testing.assert_allclose(np.cov(s.T), Cpost, atol=0.06)
    assert 0.5 < float(res.accept_rate.mean()) < 0.8  # Robbins-Monro lands near 0.651


def test_hmc_beats_mala_per_gradient():
    prior, misfit, mu, Cpost = _setup()
    gen = torch.Generator().manual_seed(0)
    theta0 = prior.sample(gen, (64,))
    L = 8
    res_h = thmc.run_hmc(misfit, prior, theta0, gen, n_steps=1000, n_burn=200, step=0.1, n_leap=L)
    res_m = tmala.run_mala(misfit, prior, theta0, gen, n_steps=1000 * L, n_burn=200 * L, step=0.1)
    e_h, e_m = float(torch.min(ess_bulk(res_h.samples))), float(torch.min(ess_bulk(res_m.samples)))
    assert e_h > 3.0 * e_m, (e_h, e_m)


def test_hmc_laplace_frame_and_segmented():
    prior, misfit, mu, Cpost = _setup(d=8, m=12)
    gen = torch.Generator().manual_seed(3)
    ref = (torch.from_numpy(mu), torch.from_numpy(np.linalg.cholesky(Cpost)))
    res = thmc.run_hmc_segmented(misfit, prior, prior.sample(gen, (512,)), gen, n_steps=313, n_burn=125,
                                 step=0.5, n_leap=4, segment=64, ref=ref)
    s = res.samples.reshape(-1, 8).numpy()
    np.testing.assert_allclose(s.mean(0), mu, atol=0.05)
    np.testing.assert_allclose(np.cov(s.T), Cpost, atol=0.06)
    assert res.samples.shape[0] == 188
