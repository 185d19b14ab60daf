"""The port's multigrid FCG (experimental/multigrid.py) against the JAX
package's, in float64 on the CPU: the transfers to 1e-14 with the reference's
linear-exactness check, MGHierarchy.solve at res2 and res4 with the JAX
solve's per-sample iteration counts, u within 1e-10 of JAX's and within 1e-9
of the port's SciPy oracle, and a batch of 4 whose samples each equal their
solo solve, as under JAX's vmap. The JAX side runs under jax.jit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.experimental import multigrid as jmg
from bayesianinferencedl_tpu_torch.experimental import multigrid as tmg
from bayesianinferencedl_tpu_torch.fem import oracle
from bayesianinferencedl_tpu_torch.geometry import build_fin_mesh
from bayesianinferencedl_tpu_torch.infer.oed import mesh_node_grid_ids

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

F64 = torch.float64
BIOT = 0.1
K_TEST = np.array([0.4, 1.7, 3.1, 0.9, 1.2])
KS4 = np.exp(np.random.default_rng(0).normal(0, 0.4, (4, 5)))


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


@pytest.mark.parametrize("shape", [(9, 7), (5, 17)])
def test_transfers_match_reference(shape):
    Xc, Yc = shape
    rng = np.random.default_rng(1)
    e = rng.standard_normal((2, Xc, Yc))
    r = rng.standard_normal((2, 2 * Xc - 1, 2 * Yc - 1))
    fine = tmg.prolong(torch.from_numpy(e), (2 * Xc - 1, 2 * Yc - 1)).numpy()
    coarse = tmg.restrict(torch.from_numpy(r)).numpy()
    for b in range(2):
        np.testing.assert_allclose(fine[b], np.asarray(jmg.prolong(jnp.asarray(e[b]), fine.shape[1:])),
                                   rtol=0, atol=1e-14)
        np.testing.assert_allclose(coarse[b], np.asarray(jmg.restrict(jnp.asarray(r[b]))), rtol=0,
                                   atol=1e-14)
    # the reference's exactness: prolongation reproduces a linear function,
    # restriction keeps a constant away from the boundary
    x = torch.arange(Xc, dtype=F64)[:, None] * torch.ones(1, Yc, dtype=F64)
    expect = 0.5 * torch.arange(2 * Xc - 1, dtype=F64)[:, None] * torch.ones(1, 2 * Yc - 1, dtype=F64)
    np.testing.assert_allclose(tmg.prolong(x[None], (2 * Xc - 1, 2 * Yc - 1))[0].numpy(), expect.numpy(),
                               atol=1e-14)
    rc = tmg.restrict(torch.ones(1, 2 * Xc - 1, 2 * Yc - 1, dtype=F64))[0]
    np.testing.assert_allclose(rc[1:-1, 1:-1].numpy(), 1.0, atol=1e-14)


@pytest.mark.parametrize("res", [2, 4])
def test_mg_solve_matches_reference(res):
    mg = tmg.MGHierarchy.create(res, biot=BIOT, dtype=F64, device="cpu")
    jh = jmg.MGHierarchy.create(res, biot=BIOT, dtype=jnp.float64)
    assert [lev.shape for lev in mg.levels] == [lev.shape for lev in jh.levels]
    for lev, jlev in zip(mg.levels, jh.levels):
        for f in ("comp", "ext", "fixed", "F"):
            np.testing.assert_array_equal(getattr(lev, f).numpy(), np.asarray(getattr(jlev, f)))
    ks = np.stack([K_TEST, KS4[1]])
    u, it = mg.solve(torch.from_numpy(ks), tol=1e-11, maxiter=100)
    ju, jit_ = jax.jit(jax.vmap(lambda k: jh.solve(k, tol=1e-11, maxiter=100)))(jnp.asarray(ks))
    assert it.tolist() == np.asarray(jit_).tolist()
    assert int(it.max()) < 60  # the point of multigrid: far below Jacobi-PCG's ~80 res
    mesh = build_fin_mesh(res)
    gid = mesh_node_grid_ids(mesh)
    for b in range(2):
        assert _rel(u[b].numpy(), ju[b]) < 1e-10
        assert _rel(u[b].numpy().reshape(-1)[gid], oracle.solve(mesh, ks[b], BIOT)) < 1e-9


def test_mg_batch_equals_solo_solves():
    """Each sample of a batch stops at its own tolerance and keeps its state
    while the others iterate: its count and field are its solo solve's, as
    under JAX's vmap of the while_loop."""
    mg = tmg.MGHierarchy.create(2, biot=BIOT, dtype=F64, device="cpu")
    jh = jmg.MGHierarchy.create(2, biot=BIOT, dtype=jnp.float64)
    ks = KS4.copy()
    ks[3] *= 25.0  # a stiffer sample, for counts that differ
    u, it = mg.solve(torch.from_numpy(ks), tol=1e-10, maxiter=100)
    ju, jit_ = jax.jit(jax.vmap(lambda k: jh.solve(k, tol=1e-10, maxiter=100)))(jnp.asarray(ks))
    assert it.tolist() == np.asarray(jit_).tolist()
    for b in range(4):
        us, its = mg.solve(torch.from_numpy(ks[b:b + 1]), tol=1e-10, maxiter=100)
        assert int(its[0]) == int(it[b])
        assert torch.allclose(us[0], u[b], rtol=0, atol=1e-13 * float(u[b].abs().max()))
        assert _rel(u[b].numpy(), ju[b]) < 1e-10
    # the cap: every sample stops at maxiter
    _, it3 = mg.solve(torch.from_numpy(ks), tol=1e-10, maxiter=3)
    assert it3.tolist() == [3, 3, 3, 3]
