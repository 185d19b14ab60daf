"""The MAP and Laplace layer of the port (infer/optimize.py, infer/map.py),
and the diagnostics it added (infer/diagnostics.py), against the JAX
reference.

1. minimize_bfgs on a quadratic and on Rosenbrock, from one start and from a
   batch of starts (against JAX's vmapped runs): the iterates, n_iter and
   converged, in float64 to 1e-10.
2. find_map_multistart from injected starts, laplace_approximation (Gauss-
   Newton and full Hessian) on a nonlinear forward, and the Laplace
   approximation's sample and log_density on injected normals, to 1e-10.
3. effective_sample_size, rhat and ks_distance on tests/test_diagnostics.py's
   inputs: rhat and ks_distance to 1e-10; effective_sample_size to rtol
   1e-5, since both sides autocorrelate in float32, as the reference does.
4. The analytic cases of tests/test_map_laplace.py on the port (its
   MAP-on-ROM case is in test_torch_reduced_solve.py, with the converted
   pipelines).

The differentiable reduced solve is held against JAX in
test_torch_reduced_solve.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.infer import diagnostics as jd
from bayesianinferencedl_tpu.infer import map as jm
from bayesianinferencedl_tpu.infer import optimize as jo
from bayesianinferencedl_tpu.infer.pcn import gaussian_misfit as j_misfit
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu_torch.infer import diagnostics as td
from bayesianinferencedl_tpu_torch.infer import map as tm
from bayesianinferencedl_tpu_torch.infer import optimize as to
from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit as t_misfit
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs


def _close(t, j, tol=1e-10):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol, atol=tol)


# --- 1. BFGS ------------------------------------------------------------------


def _objectives(d):
    rng = np.random.default_rng(d)
    M = rng.standard_normal((d, d))
    A = M @ M.T + 0.5 * np.eye(d)
    b = rng.standard_normal(d)
    Aj, bj, At, bt = jnp.asarray(A), jnp.asarray(b), torch.from_numpy(A), torch.from_numpy(b)
    rosen_j = lambda x: jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)
    rosen_t = lambda x: torch.sum(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1.0 - x[:, :-1]) ** 2, -1)
    return {
        "quadratic": (lambda x: 0.5 * x @ Aj @ x - bj @ x,
                      lambda x: 0.5 * torch.sum((x @ At) * x, -1) - x @ bt),
        "rosenbrock": (rosen_j, rosen_t),
    }


@pytest.mark.parametrize("name", ["quadratic", "rosenbrock"])
@pytest.mark.parametrize("batch", [False, True])
def test_minimize_bfgs_matches_reference(name, batch):
    d = 4
    fj, ft = _objectives(d)[name]
    rng = np.random.default_rng(7)
    x0 = rng.normal(0.0, 1.2, (6, d)) if batch else rng.normal(0.0, 1.2, d)
    kw = dict(maxiter=200, gtol=1e-8, max_ls=25)
    if batch:  # JAX's vmapped while_loops: finished starts frozen
        rj = jax.vmap(lambda s: jo.minimize_bfgs(fj, s, **kw))(jnp.asarray(x0))
    else:
        rj = jo.minimize_bfgs(fj, jnp.asarray(x0), **kw)
    rt = to.minimize_bfgs(ft, torch.from_numpy(x0), **kw)
    assert rt.x.shape == x0.shape
    np.testing.assert_array_equal(rt.n_iter.numpy(), np.asarray(rj.n_iter))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    _close(rt.x, rj.x)
    _close(rt.fun, rj.fun)
    assert np.all(np.asarray(rj.converged))
    if batch:  # the starts really finish at different iterations
        assert len(set(np.asarray(rj.n_iter).tolist())) > 1


def test_minimize_bfgs_backtracks_through_non_finite_values():
    """exp() overflows at the first full step from x = -10: the NaN-safe
    Armijo test keeps halving, as the reference's does, while the other
    start takes its own steps."""
    fj = lambda x: jnp.sum(jnp.exp(3.0 * x) - 400.0 * x)
    ft = lambda x: torch.sum(torch.exp(3.0 * x) - 400.0 * x, -1)
    x0 = np.array([[-10.0, -1.0], [0.5, 0.2]])
    assert not np.isfinite(np.exp(3.0 * (x0[0] + 400.0))).all()  # the full first step overflows
    for maxiter in (3, 200):
        kw = dict(maxiter=maxiter, gtol=1e-8, max_ls=25)
        rj = jax.vmap(lambda s: jo.minimize_bfgs(fj, s, **kw))(jnp.asarray(x0))
        rt = to.minimize_bfgs(ft, torch.from_numpy(x0), **kw)
        _close(rt.x, rj.x)
        _close(rt.fun, rj.fun)
        np.testing.assert_array_equal(rt.n_iter.numpy(), np.asarray(rj.n_iter))
        np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
        assert torch.isfinite(rt.fun).all()
    assert bool(rt.converged.all())
    np.testing.assert_allclose(rt.x.numpy(), np.log(400.0 / 3.0) / 3.0, rtol=1e-8)


# --- 2. the MAP and the Laplace approximation ----------------------------------


def _nonlinear():
    """A nonlinear forward (m = 4, d = 3) and a correlated prior, each side."""
    rng = np.random.default_rng(3)
    H = rng.standard_normal((4, 3))
    data = rng.standard_normal(4) * 0.5
    mean = np.array([0.1, -0.2, 0.05])
    L = np.tril(0.15 * np.ones((3, 3))) + 0.6 * np.eye(3)
    Hj, Ht = jnp.asarray(H), torch.from_numpy(H)
    fj = lambda t: jnp.tanh(Hj @ t) + 0.1 * (Hj @ t) ** 2
    ft = lambda x: torch.tanh(x @ Ht.T) + 0.1 * (x @ Ht.T) ** 2
    sigma = 0.3
    j = dict(fwd=fj, misfit=j_misfit(fj, jnp.asarray(data), sigma),
             prior=JPrior(jnp.asarray(mean), jnp.asarray(L)), data=jnp.asarray(data))
    t = dict(fwd=ft, misfit=t_misfit(ft, torch.from_numpy(data), sigma),
             prior=TPrior(torch.from_numpy(mean), torch.from_numpy(L)), data=torch.from_numpy(data))
    return j, t, sigma


def test_find_map_multistart_and_laplace_match_reference():
    j, t, sigma = _nonlinear()
    key = jax.random.PRNGKey(4)
    starts = np.asarray(j["prior"].sample(key, (8,)))
    xj, fjv = jm.find_map_multistart(j["misfit"], j["prior"], key, n_starts=8)
    xt, ftv = tm.find_map_multistart(t["misfit"], t["prior"], starts=torch.from_numpy(starts))
    _close(xt, xj)
    _close(ftv, fjv)
    # the per-start runs too
    xs_j, fs_j = jax.vmap(lambda s: jm.find_map(j["misfit"], j["prior"], s))(jnp.asarray(starts))
    xs_t, fs_t = tm.find_map(t["misfit"], t["prior"], torch.from_numpy(starts))
    _close(xs_t, xs_j)
    _close(fs_t, fs_j)
    for gn in (True, False):
        lj = jm.laplace_approximation(j["fwd"], j["data"], sigma, j["prior"], xj, use_gauss_newton=gn)
        lt = tm.laplace_approximation(t["fwd"], t["data"], sigma, t["prior"], xt, use_gauss_newton=gn)
        for f in ("mean", "cov", "chol"):
            _close(getattr(lt, f), getattr(lj, f))
    # GN and the full Hessian differ on this nonlinear forward
    assert not np.allclose(lt.cov.numpy(), tm.laplace_approximation(
        t["fwd"], t["data"], sigma, t["prior"], xt).cov.numpy(), atol=1e-6)


def test_laplace_sample_and_log_density_match_reference():
    j, t, sigma = _nonlinear()
    xj, _ = jm.find_map_multistart(j["misfit"], j["prior"], jax.random.PRNGKey(0), n_starts=4)
    lj = jm.laplace_approximation(j["fwd"], j["data"], sigma, j["prior"], xj)
    lt = tm.LaplaceApproximation(*(torch.from_numpy(np.asarray(a)) for a in lj))
    key = jax.random.PRNGKey(5)
    z = np.asarray(jax.random.normal(key, (7, 3), jnp.float64))
    sj = np.asarray(lj.sample(key, (7,)))
    st = lt.sample(normals=torch.from_numpy(z))
    _close(st, sj)
    _close(lt.log_density(st), jax.vmap(lj.log_density)(jnp.asarray(sj)))
    _close(lt.log_density(st[0]), lj.log_density(jnp.asarray(sj[0])))
    assert lt.sample(torch.Generator().manual_seed(0), (5, 2)).shape == (5, 2, 3)


# --- 3. diagnostics ------------------------------------------------------------


def _diag_inputs():
    """tests/test_diagnostics.py's inputs: iid chains, chains parked in two
    modes, trending chains and an AR(1) series."""
    rng = np.random.default_rng(0)
    iid = rng.standard_normal((1000, 8, 3))
    rng = np.random.default_rng(0)
    modes = np.repeat([[-3.0], [3.0]], 4, axis=0).T
    stuck = modes[None].repeat(1000, 0).reshape(1000, 8, 1) + 0.1 * rng.standard_normal((1000, 8, 1))
    rng = np.random.default_rng(0)
    t = np.linspace(-3, 3, 1000)[:, None, None].repeat(8, 1)
    trend = t + 0.1 * rng.standard_normal((1000, 8, 1))
    rng = np.random.default_rng(0)
    e = rng.standard_normal((2000, 8))
    ar = np.zeros((2000, 8))
    for i in range(1, 2000):
        ar[i] = 0.9 * ar[i - 1] + e[i]
    return {"iid": iid, "stuck": stuck, "trend": trend, "ar1": ar}


@pytest.mark.parametrize("case", ["iid", "stuck", "trend", "ar1"])
def test_plain_diagnostics_match_reference(case):
    x = _diag_inputs()[case]
    ess_t = td.effective_sample_size(torch.from_numpy(x)).numpy()
    ess_j = np.asarray(jd.effective_sample_size(jnp.asarray(x)))
    assert ess_t.shape == ess_j.shape
    np.testing.assert_allclose(ess_t, ess_j, rtol=1e-5)
    _close(td.rhat(torch.from_numpy(x)), jd.rhat(jnp.asarray(x)))
    if case == "stuck":  # the flattery the reference's test documents
        assert ess_t[0] > 4000
    if case == "trend":
        assert float(td.rhat(torch.from_numpy(x))[0]) < 1.01
    with pytest.raises(ValueError, match="2 chains"):
        td.rhat(torch.from_numpy(x[:, :1]))


def test_ks_distance_matches_reference():
    a = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4000, 2), jnp.float64))
    b = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4000, 2), jnp.float64))
    for other, expect in ((b, lambda d: (d < 0.05).all()),
                          (b + np.array([1.0, 0.0]), lambda d: d[0] > 0.3 and d[1] < 0.05)):
        dt = td.ks_distance(torch.from_numpy(a), torch.from_numpy(other)).numpy()
        _close(dt, jd.ks_distance(jnp.asarray(a), jnp.asarray(other)))
        assert expect(dt)
    # unequal sizes and a (T, C, d) input, flattened
    c = b[:3000].reshape(1000, 3, 2)
    _close(td.ks_distance(torch.from_numpy(a), torch.from_numpy(c)),
           jd.ks_distance(jnp.asarray(a), jnp.asarray(c)))


# --- 4. the analytic cases of tests/test_map_laplace.py -------------------------


def _linear(seed, m, d, prior_sigma):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((m, d))
    data = rng.standard_normal(m)
    prior = TPrior.iid(d, sigma=prior_sigma, dtype=torch.float64, device="cpu")
    Ht = torch.from_numpy(H)
    return H, data, prior, (lambda x: x @ Ht.T)


def test_map_linear_gaussian_analytic():
    H, data, prior, fwd = _linear(0, 6, 3, 1.2)
    sigma = 0.3
    theta_map, _ = tm.find_map(t_misfit(fwd, torch.from_numpy(data), sigma), prior,
                               torch.zeros(3, dtype=torch.float64))
    A = H.T @ H / sigma**2 + np.eye(3) / 1.2**2
    np.testing.assert_allclose(theta_map.numpy(), np.linalg.solve(A, H.T @ data / sigma**2), atol=1e-6)


def test_laplace_linear_gaussian_exact():
    """For a linear forward model the Laplace approximation is the posterior,
    by Gauss-Newton and by the full Hessian."""
    H, data, prior, fwd = _linear(1, 5, 3, 0.9)
    sigma = 0.4
    d_t = torch.from_numpy(data)
    theta_map, _ = tm.find_map(t_misfit(fwd, d_t, sigma), prior, torch.zeros(3, dtype=torch.float64))
    Cpost = np.linalg.inv(H.T @ H / sigma**2 + np.eye(3) / 0.9**2)
    for gn in (True, False):
        lap = tm.laplace_approximation(fwd, d_t, sigma, prior, theta_map, use_gauss_newton=gn)
        np.testing.assert_allclose(lap.cov.numpy(), Cpost, atol=1e-8)


def test_laplace_sampling():
    prior = TPrior.iid(2, sigma=1.0, dtype=torch.float64, device="cpu")
    data = torch.tensor([0.5, -0.5], dtype=torch.float64)
    fwd = lambda x: x
    theta_map, _ = tm.find_map(t_misfit(fwd, data, 0.5), prior, torch.zeros(2, dtype=torch.float64))
    lap = tm.laplace_approximation(fwd, data, 0.5, prior, theta_map)
    s = lap.sample(torch.Generator().manual_seed(0), (20000,)).numpy()
    np.testing.assert_allclose(s.mean(0), lap.mean.numpy(), atol=0.03)
    np.testing.assert_allclose(np.cov(s.T), lap.cov.numpy(), atol=0.03)
