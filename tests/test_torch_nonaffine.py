"""The nodal (full-field) operator, its coarse projection, its solves and
the affinized ROM of the port against the JAX package on the CPU, res1 and
res2, float64 unless stated:

- ``assemble_nodal_coeff`` equal to JAX's; ``vals`` and ``matvec`` on a
  batch of nodal fields to 1e-12;
- ``DeflationBasis.coarse_inverses_from_vals`` against ``np.linalg.inv`` of
  the projection computed by JAX's code on the same basis, to 1e-8;
- the batched nodal solve on its plain path (float32, deflated) against
  JAX's ``solve_fom_stencil_pallas`` in interpret mode at B = 4 and tol
  1e-6: relative error < 5e-5 to it and to a float64 direct solve, the
  tolerance of tests/test_pallas_ops.py;
- the gradient of an observable through the planes-level adjoint against
  ``jax.grad`` of the reference's ``solve_fom`` to 1e-8, and the element
  operator's ``FullFieldFin`` against the reference's;
- ``AffinizedReducedOperator``'s projection, Cholesky forward and
  ``fast_forward`` to 1e-10, and the greedy basis's picks;
- ``RandomField.from_weights`` equal to JAX's ``RandomField.create`` on W
  and b drawn exactly as it draws them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from jax.experimental.pallas import tpu as pltpu

from bayesianinferencedl_tpu.fem.dia import StencilOperator as JStencil
from bayesianinferencedl_tpu.fem.dia import assemble_fin_dia as j_assemble
from bayesianinferencedl_tpu.fem.dia_nonaffine import NodalStencilOperator as JNodal
from bayesianinferencedl_tpu.fem.dia_nonaffine import assemble_nodal_coeff as j_coeff
from bayesianinferencedl_tpu.fem.solve import solve_fom as j_solve
from bayesianinferencedl_tpu.models.full_field import FullFieldFin as JFullFieldFin
from bayesianinferencedl_tpu.models.full_field import RandomField as JRandomField
from bayesianinferencedl_tpu.ops.deflation import DeflationBasis as JDefl
from bayesianinferencedl_tpu.ops.pcg_stencil import solve_fom_stencil_pallas
from bayesianinferencedl_tpu.rom.nonaffine import AffinizedReducedOperator as JARO
from bayesianinferencedl_tpu.rom.nonaffine import greedy_basis_nonaffine as j_greedy
from bayesianinferencedl_tpu_torch.fem.dia import StencilOperator, assemble_fin_dia
from bayesianinferencedl_tpu_torch.fem.dia_nonaffine import NodalStencilOperator, assemble_nodal_coeff
from bayesianinferencedl_tpu_torch.fem.solve import solve_fom
from bayesianinferencedl_tpu_torch.geometry.mesh import build_fin_mesh
from bayesianinferencedl_tpu_torch.infer.oed import mesh_node_grid_ids
from bayesianinferencedl_tpu_torch.models.full_field import FullFieldFin, RandomField
from bayesianinferencedl_tpu_torch.ops.deflation import DeflationBasis
from bayesianinferencedl_tpu_torch.ops.pcg_stencil import solve_fom_stencil
from bayesianinferencedl_tpu_torch.rom.nonaffine import AffinizedReducedOperator, greedy_basis_nonaffine

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

BIOT = 0.1


def _setup(res, dtype=np.float64):
    mesh = build_fin_mesh(res)
    host = assemble_fin_dia(mesh, pad_to=128)
    G = assemble_nodal_coeff(mesh, host)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    op = NodalStencilOperator(base=StencilOperator.from_host(host, biot=BIOT, dtype=tdt, device="cpu"),
                              G=torch.as_tensor(G, dtype=tdt))
    jhost = j_assemble(mesh, pad_to=128)
    jop = JNodal(base=JStencil.from_host(jhost, biot=BIOT, dtype=jnp.dtype(dtype)),
                 G=jnp.asarray(j_coeff(mesh, jhost), dtype))
    return mesh, host, G, op, jop


def _fields(op, mesh, B, seed, scale=0.4):
    """(B, n) smooth-ish log-conductivity fields on the mesh nodes, 0 off them."""
    rng = np.random.default_rng(seed)
    gid = mesh_node_grid_ids(mesh)
    x, y = mesh.nodes[:, 0], mesh.nodes[:, 1]
    th = np.zeros((B, op.n))
    for b in range(B):
        a = rng.normal(size=4)
        th[b, gid] = scale * (a[0] * np.sin(a[1] * x) + a[2] * np.cos(a[3] * y) + 0.3 * rng.normal(size=x.size))
    return th


@pytest.mark.parametrize("res", [1, 2])
def test_assembly_vals_and_matvec(res):
    mesh, host, G, op, jop = _setup(res)
    np.testing.assert_array_equal(G, np.asarray(jop.G))
    ks = np.exp(_fields(op, mesh, 3, res))
    vals = op.vals(torch.from_numpy(ks))
    jvals = jax.vmap(jop.vals)(jnp.asarray(ks))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-12, atol=1e-12)
    u = np.random.default_rng(7).normal(size=(3, op.n))
    Au = op.matvec(vals, torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(Au, np.asarray(jax.vmap(jop.matvec)(jvals, jnp.asarray(u))),
                               rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def r1():
    mesh, host, G, op, jop = _setup(1)
    defl = DeflationBasis.create(host, biot=BIOT, m=64, dtype=torch.float64, device="cpu")
    return dict(mesh=mesh, host=host, G=G, op=op, jop=jop, defl=defl)


def test_coarse_inverses_from_vals(r1):
    op, jop, defl = r1["op"], r1["jop"], r1["defl"]
    ks = np.exp(_fields(op, r1["mesh"], 3, 11))
    vals = op.vals(torch.from_numpy(ks))
    Binv = defl.coarse_inverses_from_vals(op, vals, chunk=2).numpy()
    Wt = jnp.asarray(defl.Wt.numpy())
    for b in range(3):  # JAX's projection (ops/deflation.py), on the same basis
        jv = jop.vals(jnp.asarray(ks[b]))
        AW = jax.vmap(lambda w: jop.matvec(jv, w))(Wt)
        Bk = np.asarray(jnp.dot(Wt, AW.T, precision=jax.lax.Precision.HIGHEST))
        ref = np.linalg.inv(0.5 * (Bk + Bk.T))
        assert np.abs(Binv[b] - ref).max() <= 1e-8 * np.abs(ref).max()


def _direct(host, G, k):
    """float64 SciPy solve of the nodal operator (its planes assembled on the host)."""
    n = host.n
    op = NodalStencilOperator(base=StencilOperator.from_host(host, biot=BIOT, dtype=torch.float64,
                                                             device="cpu"),
                              G=torch.as_tensor(G))
    vals = op.vals(torch.from_numpy(k)).numpy()
    rows, cols, data = [], [], []
    for s, off in enumerate(host.offsets):
        r = np.arange(n)
        c = r + int(off)
        ok = (c >= 0) & (c < n) & (vals[:, s] != 0)
        rows.append(r[ok]), cols.append(c[ok]), data.append(vals[ok, s])
    A = sp.csr_matrix((np.concatenate(data), (np.concatenate(rows), np.concatenate(cols))), (n, n))
    return spla.spsolve(A.tocsc(), host.F_root)


def test_nodal_solve_matches_pallas_and_direct():
    mesh, host, G, op, jop = _setup(1, np.float32)
    B, tol = 4, 1e-6
    ks = np.exp(_fields(op, mesh, B, 5)).astype(np.float32)
    defl = DeflationBasis.create(host, biot=BIOT, m=128, device="cpu")
    jdefl = JDefl.create(j_assemble(mesh, pad_to=128), biot=BIOT, m=128, dtype=jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        u_j, _ = solve_fom_stencil_pallas(jop, jnp.asarray(ks), tol=tol, maxiter=800, layout="lanes",
                                          deflation=jdefl)
    u_t, it_t = solve_fom_stencil(op, torch.from_numpy(ks), tol=tol, maxiter=800, deflation=defl)
    u_j = np.asarray(u_j, np.float64)
    u_t = u_t.double().numpy()
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    for b in range(B):
        u_ref = _direct(host, G, ks[b].astype(np.float64))
        assert rel(u_t[b], u_j[b]) < 5e-5, b
        assert rel(u_t[b], u_ref) < 5e-5 and rel(u_j[b], u_ref) < 5e-5, b
    assert np.all(it_t.numpy() > 0)


def test_nodal_gradient_matches_jax(r1):
    op, jop = r1["op"], r1["jop"]
    th = _fields(op, r1["mesh"], 1, 2)[0]
    w = np.array([0.3, -1.0, 0.5, 2.0, 0.7])

    def j_loss(t):
        return jnp.dot(jnp.asarray(w), jop.observe(j_solve(jop, jnp.exp(t), tol=1e-13, maxiter=5000)))

    g_j = np.asarray(jax.grad(j_loss)(jnp.asarray(th)))
    t = torch.from_numpy(th).requires_grad_()
    loss = torch.dot(torch.from_numpy(w), op.observe(solve_fom(op, torch.exp(t), tol=1e-13,
                                                               maxiter=5000)))
    (g_t,) = torch.autograd.grad(loss, t)
    np.testing.assert_allclose(loss.item(), float(j_loss(jnp.asarray(th))), rtol=1e-10)
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-8 * np.abs(g_j).max()


def test_full_field_fin_matches_reference(r1, mesh_r1, host_r1):
    """FullFieldFin (element operator on the grid numbering) against the
    reference's (element operator on the mesh numbering): the same forward
    and gradient on the same nodal field."""
    jfin = JFullFieldFin.create(mesh_r1, host_r1, biot=BIOT, dtype=jnp.float64, n_features=8,
                                cg_tol=1e-13, cg_maxiter=4000)
    fin = FullFieldFin.create(r1["mesh"], r1["host"], biot=BIOT, dtype=torch.float64, device="cpu",
                              n_features=8, cg_tol=1e-13, cg_maxiter=4000)
    gid = mesh_node_grid_ids(r1["mesh"])
    th_grid = _fields(r1["op"], r1["mesh"], 1, 4)[0]
    th_mesh = np.zeros(host_r1.n)
    th_mesh[: gid.size] = th_grid[gid]
    y_j, vjp = jax.vjp(jfin.forward, jnp.asarray(th_mesh))
    t = torch.from_numpy(th_grid).requires_grad_()
    y_t = fin.forward(t)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=1e-10)
    w = np.array([1.0, -0.5, 0.2, 0.3, 1.5])
    (g_t,) = torch.autograd.grad(torch.dot(torch.from_numpy(w), y_t), t)
    g_j = np.asarray(vjp(jnp.asarray(w))[0])[: gid.size]
    np.testing.assert_allclose(g_t.numpy()[gid], g_j, rtol=1e-8, atol=1e-8 * np.abs(g_j).max())


def test_affinized_rom_and_greedy_match(r1):
    op, jop, G, mesh = r1["op"], r1["jop"], r1["G"], r1["mesh"]
    ks = np.exp(_fields(op, mesh, 12, 9))
    S = np.stack([np.asarray(j_solve(jop, jnp.asarray(k), tol=1e-12, maxiter=4000)) for k in ks])
    W = np.linalg.qr(ks[:8].T)[0]
    V = np.linalg.qr(S[:6].T)[0]
    jrom = JARO.project_host(jop, G, V, W, dtype=jnp.float64)
    rom = AffinizedReducedOperator.project_host(op, G, V, W, dtype=torch.float64, device="cpu")
    for f in ("Ahat", "Mhat", "Fhat", "Bhat"):
        np.testing.assert_allclose(getattr(rom, f).numpy(), np.asarray(getattr(jrom, f)), rtol=1e-12,
                                   atol=1e-14)
    c_ref = np.asarray(jax.vmap(jrom.coeffs)(jnp.asarray(ks))).mean(0)
    P0_j = jrom.preconditioner(jnp.asarray(c_ref))
    P0 = rom.preconditioner(rom.coeffs(torch.from_numpy(ks)).mean(0))
    np.testing.assert_allclose(P0.numpy(), np.asarray(P0_j), rtol=1e-10, atol=1e-12)
    kq = ks[8:]
    np.testing.assert_allclose(rom.forward(torch.from_numpy(kq)).numpy(),
                               np.asarray(jax.vmap(jrom.forward)(jnp.asarray(kq))), rtol=1e-10)
    ff_j = jax.vmap(jrom.fast_forward(P0_j, 5))
    for diff in (False, True):
        ff = rom.fast_forward(P0, 5, differentiable=diff)
        np.testing.assert_allclose(ff(torch.from_numpy(kq)).detach().numpy(),
                                   np.asarray(ff_j(jnp.asarray(kq))), rtol=1e-10)
    V_t, sel_t, ind_t = greedy_basis_nonaffine(op, G, ks, S, W, 4)
    V_j, sel_j, ind_j = j_greedy(jop, G, ks, S, W, 4)
    np.testing.assert_array_equal(sel_t, sel_j)
    np.testing.assert_allclose(ind_t, ind_j, rtol=1e-10)


def test_random_field_from_weights_matches_reference(r1):
    mesh, host = r1["mesh"], r1["host"]
    gid = mesh_node_grid_ids(mesh)
    ell, M, seed = 0.7, 16, 3
    jf = JRandomField.create(mesh, host.n, ell=ell, sigma=0.5, n_features=M, seed=seed,
                             dtype=jnp.float64, node_ids=gid)
    # W and b exactly as the reference's RandomField.create draws them
    kw, kb = jax.random.split(jax.random.PRNGKey(seed))
    W = jax.random.normal(kw, (2, M)) / ell
    b = jax.random.uniform(kb, (M,), maxval=2 * jnp.pi)
    f = RandomField.from_weights(mesh, host.n, np.asarray(W), np.asarray(b), sigma=0.5,
                                 dtype=torch.float64, device="cpu", node_ids=gid)
    np.testing.assert_allclose(f.features.numpy(), np.asarray(jf.features), rtol=0, atol=1e-15)
    z = np.random.default_rng(0).normal(size=(2, M))
    np.testing.assert_allclose(f.theta(torch.from_numpy(z)).numpy(),
                               np.asarray(0.5 * jnp.asarray(z) @ jf.features.T), rtol=1e-13, atol=1e-15)
    g = RandomField.create(mesh, host.n, ell=ell, n_features=M, seed=seed, dtype=torch.float64,
                           device="cpu", node_ids=gid)
    torch.testing.assert_close(g.features, RandomField.create(
        mesh, host.n, ell=ell, n_features=M, seed=seed, dtype=torch.float64, device="cpu",
        node_ids=gid).features, rtol=0, atol=0)
