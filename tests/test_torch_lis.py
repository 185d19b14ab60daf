"""LIS-pCN (infer/lis.py) against the JAX reference in float64 on the
reference's linear test forward (tests/test_lis.py): ``build_lis`` to
1e-10, and ``lis_pcn_step``, ``run_lis_pcn`` (burn-in adaptation included)
and ``run_lis_pcn_segmented`` fed the draws of JAX's key schedule, to
1e-10; the port's own chains under a torch.Generator land on the analytic
posterior."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.infer import lis as jl
from bayesianinferencedl_tpu.infer.pcn import PCNState as JState
from bayesianinferencedl_tpu.infer.pcn import gaussian_misfit as j_misfit
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu_torch.infer import lis as tl
from bayesianinferencedl_tpu_torch.infer.pcn import PCNState
from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit as t_misfit
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D, M, SIGMA, C = 12, 3, 0.05, 16


def _problem(seed=0):
    """The reference's linear test: y = A theta, A (M, D) with M << D, a
    correlated Gaussian prior; both sides' forwards and priors."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, D)) / np.sqrt(D)
    L = np.tril(0.1 * rng.standard_normal((D, D)), -1) + np.diag(rng.uniform(0.6, 1.2, D))
    mean = rng.normal(0, 0.2, D)
    data = A @ (mean + L @ rng.standard_normal(D)) + SIGMA * rng.standard_normal(M)
    j = dict(fwd=lambda t: jnp.dot(jnp.asarray(A), t), prior=JPrior(jnp.asarray(mean), jnp.asarray(L)),
             data=jnp.asarray(data))
    t = dict(fwd=lambda x: x @ torch.from_numpy(A).T,
             prior=GaussianPrior(torch.from_numpy(mean), torch.from_numpy(L)), data=torch.from_numpy(data))
    return j, t, A, L, mean, data


def _lis_pair(j, t, pts):
    lis_j = jl.build_lis(j["fwd"], j["prior"], jnp.asarray(pts), SIGMA, lam_tol=0.1)
    lis_t = tl.build_lis(t["fwd"], t["prior"], torch.from_numpy(pts), SIGMA, lam_tol=0.1)
    return lis_j, lis_t


def test_build_lis_matches_reference():
    j, t, A, L, mean, data = _problem()
    pts = np.random.default_rng(1).normal(size=(5, D))
    lis_j, lis_t = _lis_pair(j, t, pts)
    assert lis_t.rank == lis_j.rank == M
    np.testing.assert_allclose(lis_t.lam.numpy(), np.asarray(lis_j.lam), rtol=1e-10)
    # eigenvectors up to sign
    Vj, Vt = np.asarray(lis_j.V), lis_t.V.numpy()
    sign = np.sign(np.sum(Vj * Vt, 0))
    np.testing.assert_allclose(Vt * sign, Vj, rtol=0, atol=1e-10)
    # the analytic whitened GN Hessian's spectrum
    H = (A @ L).T @ (A @ L) / SIGMA**2
    np.testing.assert_allclose(lis_t.lam.numpy(), np.sort(np.linalg.eigvalsh(H))[::-1][:M], rtol=1e-10)
    r2 = tl.build_lis(t["fwd"], t["prior"], torch.from_numpy(pts), SIGMA, rank_max=2)
    assert r2.rank == 2


def _step_draws(key, shape):
    k_prop, k_acc = jax.random.split(key)
    return (np.asarray(jax.random.normal(k_prop, shape, jnp.float64)),
            np.asarray(jax.random.uniform(k_acc, shape[:-1], jnp.float64)))


def _run_draws(key, n_steps, n_burn):
    k_burn, k_main = jax.random.split(key)
    keys = (list(jax.random.split(k_burn, n_burn)) if n_burn else []) + list(
        jax.random.split(k_main, n_steps - n_burn))
    nrm, uni = zip(*(_step_draws(k, (C, D)) for k in keys))
    return torch.tensor(np.stack(nrm)), torch.tensor(np.stack(uni))


@pytest.fixture(scope="module")
def setup():
    j, t, A, L, mean, data = _problem()
    pts = np.random.default_rng(1).normal(size=(4, D))
    lis_j, lis_t = _lis_pair(j, t, pts)
    mj = j_misfit(j["fwd"], j["data"], SIGMA)
    mt = t_misfit(t["fwd"], t["data"], SIGMA)
    theta0 = np.random.default_rng(2).normal(size=(C, D))
    # the chains' misfits take batches on the port's side; JAX vmaps its per-sample one
    return dict(j=j, t=t, lis_j=lis_j, lis_t=lis_t, mj=mj, mt=mt, theta0=theta0, A=A, L=L, mean=mean,
                data=data)


def test_lis_pcn_step_replays_reference(setup):
    s = setup
    y = np.random.default_rng(3).normal(size=(C, D))
    beta0 = np.linspace(0.1, 0.9, C)
    to_j = lambda Y: s["j"]["prior"].mean + jnp.dot(Y, s["j"]["prior"].chol.T)
    to_t = lambda Y: s["t"]["prior"].mean + Y @ s["t"]["prior"].chol.T
    phi = np.array(jax.vmap(s["mj"])(to_j(jnp.asarray(y))))
    sj = JState(theta=jnp.asarray(y), phi=jnp.asarray(phi), n_accept=jnp.zeros(C, jnp.int32))
    st = PCNState(theta=torch.from_numpy(y), phi=torch.from_numpy(phi), n_accept=torch.zeros(C, dtype=torch.int32))
    key = jax.random.PRNGKey(4)
    for _ in range(4):
        key, sub = jax.random.split(key)
        sj, acc_j = jl.lis_pcn_step(s["mj"], s["lis_j"], to_j, jnp.asarray(beta0), sj, sub)
        nrm, uni = _step_draws(sub, (C, D))
        st, acc_t = tl.lis_pcn_step(s["mt"], s["lis_t"], to_t, torch.from_numpy(beta0), st,
                                    normals=torch.tensor(nrm), uniforms=torch.tensor(uni))
        np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
        np.testing.assert_allclose(st.theta.numpy(), np.asarray(sj.theta), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("segmented", [False, True])
def test_run_lis_pcn_replays_reference(setup, segmented):
    s = setup
    n_steps, n_burn = 32, 10
    key = jax.random.PRNGKey(5)
    kw = dict(n_steps=n_steps, n_burn=n_burn, beta=0.5)
    if segmented:
        rj = jl.run_lis_pcn_segmented(s["mj"], s["j"]["prior"], s["lis_j"], jnp.asarray(s["theta0"]),
                                      key, segment=16, **kw)
        # the segments' draws: drive_segments splits one key per segment
        nrm, uni, done, k = [], [], 0, key
        while done < n_steps:
            this = min(16, n_steps - done)
            k, sub = jax.random.split(k)
            a, b = _run_draws(sub, this, min(max(n_burn - done, 0), this))
            nrm.append(a), uni.append(b)
            done += this
        nrm, uni = torch.cat(nrm), torch.cat(uni)
        rt = tl.run_lis_pcn_segmented(s["mt"], s["t"]["prior"], s["lis_t"], torch.from_numpy(s["theta0"]),
                                      segment=16, normals=nrm, uniforms=uni, **kw)
    else:
        rj = jl.run_lis_pcn(s["mj"], s["j"]["prior"], s["lis_j"], jnp.asarray(s["theta0"]), key, **kw)
        nrm, uni = _run_draws(key, n_steps, n_burn)
        rt = tl.run_lis_pcn(s["mt"], s["t"]["prior"], s["lis_t"], torch.from_numpy(s["theta0"]),
                            normals=nrm, uniforms=uni, **kw)
    np.testing.assert_allclose(rt.samples.numpy(), np.asarray(rj.samples), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(rt.beta.numpy(), np.asarray(rj.beta), rtol=1e-10)
    np.testing.assert_allclose(rt.accept_rate.numpy(), np.asarray(rj.accept_rate), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rt.state.theta.numpy(), np.asarray(rj.state.theta), rtol=1e-10, atol=1e-10)


def test_lis_pcn_lands_on_the_analytic_posterior(setup):
    s = setup
    A, L, mean, data = s["A"], s["L"], s["mean"], s["data"]
    C0 = L @ L.T
    K = C0 @ A.T @ np.linalg.inv(A @ C0 @ A.T + SIGMA**2 * np.eye(M))
    mu = mean + K @ (data - A @ mean)
    sd = np.sqrt(np.diag(C0 - K @ A @ C0))
    theta0 = mean + np.random.default_rng(8).normal(size=(256, D)) @ L.T
    res = tl.run_lis_pcn(lambda x: s["mt"](x), s["t"]["prior"], s["lis_t"], torch.from_numpy(theta0),
                         torch.Generator().manual_seed(0), n_steps=600, n_burn=200)
    x = res.samples.numpy().reshape(-1, D)
    mcse = sd / np.sqrt(x.shape[0] / 20.0)
    assert np.all(np.abs(x.mean(0) - mu) < 5 * mcse + 1e-3), (x.mean(0) - mu) / mcse
    np.testing.assert_allclose(x.std(0), sd, rtol=0.1)
