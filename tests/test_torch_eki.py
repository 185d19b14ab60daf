"""EKI in the port (infer/eki.py) against the JAX reference, in float64.

1. The step rule (_ess_fraction, _adaptive_dt) on seeded misfits.
2. Replay: run_eki from JAX's initial ensemble and with the NumPy generator
   JAX seeds from its key, on the linear forward of tests/test_eki.py and
   on a nonlinear one: the knots, the misfit trace and the ensemble to 1e-10.
3. The analytic cases of tests/test_eki.py on the port's own
   torch.Generator, at that file's tolerances: the linear-Gaussian
   posterior, the schedule contract, the pace set by the noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.infer import eki as je
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu_torch.infer import eki as te
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D, M, SIG = 5, 7, 0.1
A = np.random.default_rng(0).standard_normal((M, D))


def _posterior():
    """tests/test_eki.py's problem: priors, data from JAX's truth, the
    analytic posterior."""
    jprior = JPrior.iid(D, sigma=1.0, dtype=jnp.float64)
    theta_true = jprior.sample(jax.random.PRNGKey(10))
    y = jnp.asarray(A) @ theta_true + SIG * jax.random.normal(jax.random.PRNGKey(11), (M,), jnp.float64)
    P = np.linalg.inv(np.eye(D) + A.T @ A / SIG**2)
    mu = P @ (A.T @ np.asarray(y) / SIG**2)
    return jprior, TPrior.iid(D, sigma=1.0, dtype=torch.float64, device="cpu"), np.asarray(y), mu, P


def _forwards(kind):
    Aj, At = jnp.asarray(A), torch.tensor(A)
    if kind == "linear":
        return (lambda th: th @ Aj.T), (lambda th: th @ At.T)
    return (lambda th: jnp.tanh(th) @ Aj.T + 0.1 * th[:, :1] ** 2), \
        (lambda th: torch.tanh(th) @ At.T + 0.1 * th[:, :1] ** 2)


@pytest.mark.parametrize("target", [0.3, 0.5, 0.9])
def test_step_rule_matches_reference(target):
    dphi = np.random.default_rng(1).gamma(2.0, 50.0, 256)
    for dt in (1e-4, 0.01, 1.0):
        assert te._ess_fraction(dphi, dt) == je._ess_fraction(dphi, dt)
    assert te._adaptive_dt(dphi, 0.7, target) == je._adaptive_dt(dphi, 0.7, target)


@pytest.mark.parametrize("kind, J, sig", [("linear", 256, SIG), ("linear", 128, 0.01),
                                          ("nonlinear", 256, 0.05)])
def test_run_eki_replays_reference(kind, J, sig):
    jprior, tprior, y, _, _ = _posterior()
    jf, tf = _forwards(kind)
    key = jax.random.PRNGKey(3)
    rj = je.run_eki(jf, jprior, jnp.asarray(y), sig, key, n_ensemble=J)
    k_init, k_loop = jax.random.split(key)
    theta0 = np.asarray(jprior.sample(k_init, (J,)))
    rng = np.random.default_rng(int(jax.random.randint(k_loop, (), 0, np.iinfo(np.int32).max)))
    rt = te.run_eki(tf, tprior, torch.tensor(y), sig, n_ensemble=J, theta0=torch.tensor(theta0), rng=rng)
    assert rt.ts == rj.ts and rt.n_forward == rj.n_forward
    np.testing.assert_allclose(rt.misfit_trace, rj.misfit_trace, rtol=1e-10)
    for f in ("ensemble", "mean", "std"):
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)), rtol=1e-10,
                                   atol=1e-10)


def test_linear_gaussian_posterior_on_the_port_generator():
    _, tprior, y, mu, P = _posterior()
    _, tf = _forwards("linear")
    res = te.run_eki(tf, tprior, torch.tensor(y), SIG, torch.Generator().manual_seed(2),
                     n_ensemble=4096)
    np.testing.assert_allclose(res.mean.numpy(), mu, atol=0.02)
    np.testing.assert_allclose(res.std.numpy(), np.sqrt(np.diag(P)), atol=0.02)


def test_schedule_contract_on_the_port_generator():
    _, tprior, y, _, _ = _posterior()
    _, tf = _forwards("linear")
    res = te.run_eki(tf, tprior, torch.tensor(y), SIG, torch.Generator().manual_seed(3), n_ensemble=512)
    ts = np.asarray(res.ts)
    assert ts[0] == 0.0 and ts[-1] == 1.0 and np.all(np.diff(ts) > 0)
    assert np.all(np.diff(res.misfit_trace) < 0), res.misfit_trace
    assert res.n_forward == len(res.ts) * 512


def test_sharp_likelihood_takes_more_steps_on_the_port_generator():
    _, tprior, y, _, _ = _posterior()
    _, tf = _forwards("linear")
    n = {sig: len(te.run_eki(tf, tprior, torch.tensor(y), sig, torch.Generator().manual_seed(4),
                             n_ensemble=512).ts) - 1 for sig in (0.1, 0.01)}
    assert n[0.01] > n[0.1], n
