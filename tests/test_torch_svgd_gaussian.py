"""The linear-Gaussian analytic case of tests/test_svgd.py for the port's
SVGD (infer/svgd.py) on its own torch.Generator, in float64 at that file's
size and tolerances: 512 particles x 1,500 steps on an anisotropic,
correlated d = 6 posterior whose mean and marginal sds are exact. No JAX
run: the replays are in test_torch_svgd.py."""

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.infer import svgd as ts
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs


def _linear_gaussian(d=6, sigma=0.5, seed=0, cond=20.0):
    """tests/test_svgd.py's anisotropic correlated problem and its exact
    posterior."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((d, d)) * np.geomspace(1.0, cond, d)[None, :]
    data = rng.standard_normal(d)
    Cpost = np.linalg.inv(A.T @ A / sigma**2 + np.eye(d))
    mu = Cpost @ (A.T @ data) / sigma**2
    At, dt = torch.tensor(A), torch.tensor(data)
    tm = lambda th: 0.5 / sigma**2 * torch.sum((th @ At.T - dt) ** 2, dim=-1)
    return tm, TPrior.iid(d, sigma=1.0, dtype=torch.float64, device="cpu"), mu, Cpost


def test_linear_gaussian_posterior_on_the_port_generator():
    tm, tprior, mu, Cpost = _linear_gaussian()
    res = ts.run_svgd(tm, tprior, torch.Generator().manual_seed(1), n_particles=512, n_steps=1500,
                      lr=0.05)
    np.testing.assert_allclose(res.mean.numpy(), mu, atol=0.05)
    ratio = res.std.numpy() / np.sqrt(np.diag(Cpost))
    assert np.all(ratio > 0.7) and np.all(ratio < 1.3), ratio
    tr = res.misfit_trace.numpy()
    assert tr[-1] < 0.2 * tr[0]
