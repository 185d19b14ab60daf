"""SVGD in the port (infer/svgd.py) against the JAX reference, in float64.

1. _stein_direction on seeded particles and scores, for odd and even J
   (jnp.median of an even count averages the two middle values), to 1e-10.
2. Replay: run_svgd from a shared theta0 (SVGD draws nothing per step) over
   30 steps, annealed and not, and JAX's segmented run against the port's
   one loop: particles and the misfit trace to 1e-10.
The analytic cases of tests/test_svgd.py are in test_torch_svgd_analytic.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.infer import svgd as js
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu_torch.infer import svgd as ts
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs


def _linear_gaussian(d=6, sigma=0.5, seed=0, cond=20.0):
    """tests/test_svgd.py's problem: both misfits and priors, the exact
    posterior."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((d, d)) * np.geomspace(1.0, cond, d)[None, :]
    data = rng.standard_normal(d)
    Cpost = np.linalg.inv(A.T @ A / sigma**2 + np.eye(d))
    mu = Cpost @ (A.T @ data) / sigma**2
    Aj, dj, At, dt = jnp.asarray(A), jnp.asarray(data), torch.tensor(A), torch.tensor(data)
    jm = lambda th: 0.5 / sigma**2 * jnp.sum((th @ Aj.T - dj) ** 2, axis=-1)
    tm = lambda th: 0.5 / sigma**2 * torch.sum((th @ At.T - dt) ** 2, dim=-1)
    return (jm, tm, JPrior.iid(d, sigma=1.0, dtype=jnp.float64),
            TPrior.iid(d, sigma=1.0, dtype=torch.float64, device="cpu"), mu, Cpost)


@pytest.mark.parametrize("J", [7, 8, 64, 65])
def test_stein_direction_matches_reference(J):
    rng = np.random.default_rng(J)
    Y, g = rng.standard_normal((J, 4)), rng.standard_normal((J, 4))
    out = ts._stein_direction(torch.tensor(Y), torch.tensor(g), J).numpy()
    np.testing.assert_allclose(out, np.asarray(js._stein_direction(jnp.asarray(Y), jnp.asarray(g), J)),
                               rtol=1e-10, atol=1e-12)
    D = rng.standard_normal((J, J))
    assert float(ts._median(torch.tensor(D))) == float(jnp.median(jnp.asarray(D)))


@pytest.mark.parametrize("anneal, segment", [(None, None), (0, None), (None, 12)])
def test_run_svgd_replays_reference(anneal, segment):
    jm, tm, jprior, tprior, _, _ = _linear_gaussian(seed=2)
    theta0 = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (32, 6), jnp.float64))
    kw = dict(n_steps=30, lr=0.05, anneal_steps=anneal)
    rj = js.run_svgd(jm, jprior, jax.random.PRNGKey(0), theta0=jnp.asarray(theta0), batched=True,
                     segment=segment, **kw)
    rt = ts.run_svgd(tm, tprior, theta0=torch.tensor(theta0), **kw)
    for f in ("particles", "mean", "std", "misfit_trace"):
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)), rtol=1e-10,
                                   atol=1e-10, err_msg=f)
    assert rt.n_forward == rj.n_forward == 32 * 30
