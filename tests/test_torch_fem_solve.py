"""The port's differentiable FOM solve (bayesianinferencedl_tpu_torch.fem.solve)
and the misfit derivatives of ``FiveParamFin`` against the JAX package's
``fem/solve.py`` and ``models/five_param.py``, in float64 at res1.

Both run the same Jacobi-PCG with the same stop test, so in float64 the
solutions agree to 1e-10 and the iteration counts are equal. Gradients go
through one adjoint solve on each side (JAX: ``custom_linear_solve``; the
port: a ``torch.autograd.Function``), at solver tol 1e-12: gradients agree to
1e-8 relative, Hessian-vector products (a second level of solves) to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.fem.dia import StencilOperator as JStencil
from bayesianinferencedl_tpu.fem.dia import assemble_fin_dia as j_assemble
from bayesianinferencedl_tpu.fem.solve import pcg as j_pcg
from bayesianinferencedl_tpu.fem.solve import solve_fom as j_solve_fom
from bayesianinferencedl_tpu.models.five_param import FiveParamFin as JFin
from bayesianinferencedl_tpu_torch.fem import solve as S
from bayesianinferencedl_tpu_torch.fem.dia import StencilOperator, assemble_fin_dia
from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

BIOT = 0.1
NOISE = 1e-2


@pytest.fixture(scope="module")
def ops(mesh_r1):
    jop = JStencil.from_host(j_assemble(mesh_r1, pad_to=128), biot=BIOT, dtype=jnp.float64)
    top = StencilOperator.from_host(assemble_fin_dia(mesh_r1, pad_to=128), biot=BIOT,
                                    dtype=torch.float64, device="cpu")
    ks = np.exp(np.random.default_rng(2).uniform(np.log(0.1), np.log(10), (3, 5)))
    return jop, top, ks


@pytest.fixture(scope="module")
def fins():
    jfin = JFin.create(resolution=1, biot=BIOT, dtype=jnp.float64, cg_tol=1e-12, cg_maxiter=4000)
    tfin = FiveParamFin.create(resolution=1, biot=BIOT, dtype=torch.float64, device="cpu",
                               cg_tol=1e-12, cg_maxiter=4000)
    rng = np.random.default_rng(4)
    k = np.exp(rng.normal(0, 0.4, 5))
    data = np.asarray(jfin.forward(jnp.asarray(k))) * (1 + 0.05 * rng.normal(size=5))
    v = rng.normal(size=5)
    return jfin, tfin, k, data, v


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def test_pcg_matches_reference(ops):
    jop, top, ks = ops
    kt = torch.from_numpy(ks)
    vals = top.vals(kt)
    x, it, rel = S.pcg(lambda v: top.matvec(vals, v), top.F_root.expand(3, -1), top.diag(vals),
                       tol=1e-10, maxiter=4000)
    x0 = torch.from_numpy(np.random.default_rng(1).normal(size=(3, top.n)) * 1e-3)
    xw, itw, _ = S.pcg(lambda v: top.matvec(vals, v), top.F_root.expand(3, -1), top.diag(vals),
                       tol=1e-10, maxiter=4000, x0=x0)
    for b in range(3):
        jv = jop.vals(jnp.asarray(ks[b]))
        mv = lambda u: jop.matvec(jv, u)
        xj, itj, relj = j_pcg(mv, jop.F_root, jop.diag(jv), tol=1e-10, maxiter=4000)
        assert _rel(x[b], xj) < 1e-10 and int(it[b]) == int(itj)
        assert abs(float(rel[b]) - float(relj)) < 1e-12 and float(rel[b]) <= 1e-10
        xj, itj, _ = j_pcg(mv, jop.F_root, jop.diag(jv), tol=1e-10, maxiter=4000,
                           x0=jnp.asarray(x0[b].numpy()))
        assert _rel(xw[b], xj) < 1e-10 and int(itw[b]) == int(itj)
    # the cap: every sample stops at maxiter, unconverged
    _, it5, rel5 = S.pcg(lambda v: top.matvec(vals, v), top.F_root.expand(3, -1), top.diag(vals),
                         tol=1e-10, maxiter=5)
    assert it5.tolist() == [5, 5, 5] and (rel5 > 1e-10).all()


def test_solve_fom_matches_reference(ops):
    jop, top, ks = ops
    u = S.solve_fom(top, torch.from_numpy(ks), tol=1e-10, maxiter=4000)
    u1 = S.solve_fom(top, torch.from_numpy(ks[1]), tol=1e-10, maxiter=4000)
    assert u.shape == (3, top.n) and u1.shape == (top.n,)
    for b in range(3):
        uj = j_solve_fom(jop, jnp.asarray(ks[b]), tol=1e-10, maxiter=4000)
        assert _rel(u[b], uj) < 1e-10
    assert torch.equal(u1, u[1])
    assert torch.equal(S.solve_fom_batch(top, torch.from_numpy(ks), tol=1e-10, maxiter=4000), u)
    np.testing.assert_allclose(S.forward(top, torch.from_numpy(ks), tol=1e-10, maxiter=4000).numpy(),
                               top.observe(u).numpy(), rtol=1e-14)


def test_gradient_hvp_gn_hvp_match_reference(fins):
    jfin, tfin, k, data, v = fins
    jk, jd, jv = jnp.asarray(k), jnp.asarray(data), jnp.asarray(v)
    np.testing.assert_allclose(tfin.misfit(torch.from_numpy(k), torch.from_numpy(data), NOISE).item(),
                               float(jfin.misfit(jk, jd, NOISE)), rtol=1e-10)
    g = tfin.gradient(torch.from_numpy(k), torch.from_numpy(data), NOISE).numpy()
    np.testing.assert_allclose(g, np.asarray(jfin.gradient(jk, jd, NOISE)), rtol=1e-8)
    h = tfin.hvp(torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(data), NOISE).numpy()
    np.testing.assert_allclose(h, np.asarray(jfin.hvp(jk, jv, jd, NOISE)), rtol=1e-6)
    gn = tfin.gn_hvp(torch.from_numpy(k), torch.from_numpy(v), NOISE).numpy()
    np.testing.assert_allclose(gn, np.asarray(jfin.gn_hvp(jk, jv, NOISE)), rtol=1e-6)


def test_gradcheck(fins):
    _, tfin, k, _, _ = fins
    kt = torch.from_numpy(k).requires_grad_()
    assert torch.autograd.gradcheck(lambda kk: tfin.qoi(tfin.solve(kk)), (kt,), eps=1e-6, atol=1e-6,
                                    rtol=1e-4)
    # in k and the load F together: F has n entries, so by random projections
    F = tfin.op.F_root.clone().requires_grad_()
    assert torch.autograd.gradcheck(lambda kk, ff: tfin.qoi(tfin.solve(kk, ff)), (kt, F), eps=1e-6,
                                    atol=1e-6, rtol=1e-4, fast_mode=True)


def test_backward_is_one_adjoint_solve(fins, monkeypatch):
    _, tfin, k, data, _ = fins
    calls = []
    pcg = S.pcg

    def counted(*a, **kw):
        calls.append(kw["maxiter"])
        return pcg(*a, **kw)

    monkeypatch.setattr(S, "pcg", counted)
    kt = torch.from_numpy(k).requires_grad_()
    u = tfin.solve(kt)
    assert len(calls) == 1
    # one graph node for the whole solve, straight back to k: no iterations recorded
    assert type(u.grad_fn).__name__ == "_SolveBackward"
    assert {type(f).__name__ for f, _ in u.grad_fn.next_functions if f is not None} == {"AccumulateGrad"}
    torch.autograd.grad(tfin.qoi(u).sum(), kt)
    assert len(calls) == 2
