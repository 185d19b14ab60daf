"""The bimodal analytic cases of tests/test_svgd.py for the port's SVGD
(infer/svgd.py) on its own torch.Generator, in float64 at that file's sizes
and tolerances: both basins kept under annealing, the classic kernel's
collapse onto the basin it starts in. The linear-Gaussian case is in
test_torch_svgd_gaussian.py; no JAX run: the replays are in
test_torch_svgd.py."""

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.infer import svgd as ts
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs


def _bimodal_1d(a=2.0, s=0.6, prior_sigma=3.0):
    """G(theta) = theta^2 observed at a^2: modes at +-a."""
    misfit = lambda th: 0.5 / s**2 * (th[..., 0] ** 2 - a * a) ** 2
    return misfit, TPrior.iid(1, sigma=prior_sigma, dtype=torch.float64, device="cpu")


def test_annealed_svgd_keeps_both_basins():
    misfit, prior = _bimodal_1d()
    res = ts.run_svgd(misfit, prior, torch.Generator().manual_seed(5), n_particles=128, n_steps=800,
                      lr=0.05, anneal_steps=400)
    th = res.particles.numpy()[:, 0]
    assert 0.25 < float((th > 0).mean()) < 0.75
    assert np.abs(np.abs(th) - 2.0).mean() < 0.35


def test_classic_svgd_collapses_from_biased_start():
    misfit, prior = _bimodal_1d()
    theta0 = 2.0 + 0.3 * torch.randn((128, 1), generator=torch.Generator().manual_seed(6),
                                     dtype=torch.float64)
    res = ts.run_svgd(misfit, prior, n_steps=800, lr=0.05, anneal_steps=0, theta0=theta0)
    assert (res.particles[:, 0] > 0).all()
