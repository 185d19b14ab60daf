"""Kernel K1's module (bayesianinferencedl_tpu_torch.ops.pcg_stencil, with
ops.deflation) against the JAX Pallas lanes kernel in interpret mode and the
SciPy float64 oracle, at res1 with an m = 64 coarse space.

On the CPU the wrapper runs the plain torch version; the CUDA kernel itself
is held against that plain version on the card by chip_smoke.py.

Tolerances: the JAX kernel stops when its whole 128-sample tile has
converged, the port per sample, so the two solutions differ at the level
the tolerance allows: per-sample relative L2 difference < 5e-5 at tol 1e-6,
and each within 5e-5 of the f64 direct solve (the bound the JAX package's
own deflation test uses)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bayesianinferencedl_tpu.fem import oracle
from bayesianinferencedl_tpu.fem.dia import StencilOperator as JStencil
from bayesianinferencedl_tpu.fem.dia import assemble_fin_dia as j_assemble
from bayesianinferencedl_tpu.ops.deflation import DeflationBasis as JDefl
from bayesianinferencedl_tpu.ops.pcg_stencil import solve_fom_stencil_pallas
from bayesianinferencedl_tpu_torch.fem.dia import StencilOperator, assemble_fin_dia
from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K1
from bayesianinferencedl_tpu_torch.ops.deflation import DeflationBasis
from bayesianinferencedl_tpu_torch.ops.pcg_stencil import solve_fom_stencil

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

BIOT = 0.1
TOL = 1e-6
B = 6


@pytest.fixture(scope="module")
def setup(mesh_r1):
    jhost = j_assemble(mesh_r1, pad_to=128)
    jop = JStencil.from_host(jhost, biot=BIOT, dtype=jnp.float32)
    jdefl = JDefl.create(jhost, biot=BIOT, m=64, dtype=jnp.float32)
    host = assemble_fin_dia(mesh_r1, pad_to=128)
    op = StencilOperator.from_host(host, biot=BIOT, dtype=torch.float32, device="cpu")
    defl = DeflationBasis.create(host, biot=BIOT, m=64, device="cpu")
    ks = np.exp(np.random.default_rng(3).uniform(np.log(0.1), np.log(10), (B, 5))).astype(np.float32)
    n_res = mesh_r1.resolution
    h = 0.25 / n_res
    ny = 16 * n_res
    gi = np.rint((mesh_r1.nodes[:, 0] + 3.0) / h).astype(int)
    gj = np.rint(mesh_r1.nodes[:, 1] / h).astype(int)
    gid = gi * (ny + 1) + gj
    u_ref = [oracle.solve(mesh_r1, ks[b].astype(np.float64), BIOT) for b in range(B)]
    return dict(jop=jop, jdefl=jdefl, op=op, defl=defl, ks=ks, gid=gid, u_ref=u_ref)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _check_against_jax_and_oracle(s, u_t, u_j):
    for b in range(B):
        assert _rel(u_t[b], u_j[b]) < 5e-5, (b, _rel(u_t[b], u_j[b]))
        for u in (u_t, u_j):
            rel = _rel(u[b][s["gid"]], s["u_ref"][b])
            assert rel < 5e-5, (b, rel)


def test_basis_equals_reference(setup):
    s = setup
    np.testing.assert_allclose(s["defl"].Wt.numpy(), np.asarray(s["jdefl"].Wt), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s["defl"].C.numpy(), np.asarray(s["jdefl"].C), rtol=1e-6, atol=1e-6)
    assert s["defl"].Wt_bf16.dtype == torch.bfloat16


def test_cholesky_coarse_inverses_match_newton_schulz(setup):
    s = setup
    ks = s["ks"]
    Xj = np.asarray(s["jdefl"].coarse_inverses(jnp.asarray(ks), BIOT), np.float64)
    Xt = s["defl"].coarse_inverses(torch.from_numpy(ks), BIOT).double().numpy()
    for b in range(B):
        assert _rel(Xt[b], Xj[b]) < 1e-4, (b, _rel(Xt[b], Xj[b]))
    Bk = s["defl"].coarse_matrices(torch.from_numpy(ks), BIOT).double().numpy()
    for b in range(B):
        assert np.abs(Bk[b] @ Xt[b] - np.eye(64)).max() < 1e-3


def test_failed_coarse_factor_gives_nan_for_that_sample_only(setup):
    s = setup
    ks = torch.from_numpy(s["ks"])
    bad = ks.clone()
    bad[2] = -bad[2]  # negative conductivities: B(k) is not positive definite
    X_ok = s["defl"].coarse_inverses(ks, BIOT)
    X_bad = s["defl"].coarse_inverses(bad, BIOT)
    keep = [b for b in range(B) if b != 2]
    assert torch.isnan(X_bad[2]).all()
    torch.testing.assert_close(X_bad[keep], X_ok[keep], rtol=0, atol=0)
    kw = dict(tol=TOL, maxiter=800, deflation=s["defl"])
    u_ok, _ = solve_fom_stencil(s["op"], ks, **kw)
    u_bad, _ = solve_fom_stencil(s["op"], bad, **kw)
    assert torch.isnan(u_bad[2]).all()
    torch.testing.assert_close(u_bad[keep], u_ok[keep], rtol=0, atol=0)


def test_deflated_solve_matches_pallas_and_oracle(setup):
    s = setup
    Binv_j = s["jdefl"].coarse_inverses(jnp.asarray(s["ks"]), BIOT)
    with pltpu.force_tpu_interpret_mode():
        u_j, it_j = solve_fom_stencil_pallas(
            s["jop"], jnp.asarray(s["ks"]), tol=TOL, maxiter=800, layout="lanes",
            deflation=s["jdefl"], coarse_inv=Binv_j,
        )
    u_t, it_t = solve_fom_stencil(
        s["op"], torch.from_numpy(s["ks"]), tol=TOL, maxiter=800, deflation=s["defl"],
        coarse_inv=torch.tensor(np.asarray(Binv_j)),
    )
    assert u_t.dtype == torch.float32 and it_t.dtype == torch.int32 and u_t.shape == (B, s["op"].n)
    _check_against_jax_and_oracle(s, u_t.numpy(), np.asarray(u_j))
    # per-sample counts: multiples of check_every, none past the tile's joint count
    it_t = it_t.numpy()
    assert np.all(it_t % 16 == 0) and np.all(it_t > 0)
    assert np.all(it_t <= np.asarray(it_j))


def test_undeflated_solve_matches_pallas_and_oracle(setup):
    s = setup
    with pltpu.force_tpu_interpret_mode():
        u_j, it_j = solve_fom_stencil_pallas(
            s["jop"], jnp.asarray(s["ks"]), tol=TOL, maxiter=800, layout="lanes",
        )
    u_t, it_t = solve_fom_stencil(s["op"], torch.from_numpy(s["ks"]), tol=TOL, maxiter=800)
    _check_against_jax_and_oracle(s, u_t.numpy(), np.asarray(u_j))
    assert np.all(it_t.numpy() <= np.asarray(it_j))
    # deflation cuts the iteration count (>= 2x, as in the JAX package's test)
    _, it_d = solve_fom_stencil(s["op"], torch.from_numpy(s["ks"]), tol=TOL, maxiter=800,
                                deflation=s["defl"])
    assert np.all(it_d.numpy() * 2 <= it_t.numpy())


def test_warm_start_matches_pallas_and_saves_iterations(setup):
    s = setup
    rng = np.random.default_rng(5)
    # warm starts: the oracle solutions, perturbed by 1%
    x0 = np.zeros((B, s["op"].n), np.float32)
    for b in range(B):
        x0[b, s["gid"]] = s["u_ref"][b] * (1 + 1e-2 * rng.normal(size=s["u_ref"][b].shape))
    Binv_j = s["jdefl"].coarse_inverses(jnp.asarray(s["ks"]), BIOT)
    with pltpu.force_tpu_interpret_mode():
        u_j, _ = solve_fom_stencil_pallas(
            s["jop"], jnp.asarray(s["ks"]), tol=TOL, maxiter=800, layout="lanes",
            x0=jnp.asarray(x0), deflation=s["jdefl"], coarse_inv=Binv_j,
        )
    kw = dict(tol=TOL, maxiter=800, deflation=s["defl"],
              coarse_inv=torch.tensor(np.asarray(Binv_j)))
    u_t, it_w = solve_fom_stencil(s["op"], torch.from_numpy(s["ks"]), x0=torch.from_numpy(x0), **kw)
    _check_against_jax_and_oracle(s, u_t.numpy(), np.asarray(u_j))
    _, it_c = solve_fom_stencil(s["op"], torch.from_numpy(s["ks"]), **kw)
    assert np.all(it_w.numpy() <= it_c.numpy())


def test_maxiter_caps_every_sample(setup):
    s = setup
    u, it = solve_fom_stencil(s["op"], torch.from_numpy(s["ks"]), tol=TOL, maxiter=4,
                              deflation=s["defl"])
    assert it.tolist() == [4] * B
    assert torch.isfinite(u).all()


def test_wrapper_checks_inputs_and_counts_only_launches(setup):
    s = setup
    op = s["op"]
    vals4 = K1.upper_planes(op.vals(torch.from_numpy(s["ks"])))
    offs = op.offsets[4:]
    before = K1.launches
    K1.pcg_stencil(vals4, op.F_root, offsets=offs, tol=TOL, maxiter=8)  # CPU: plain version
    assert K1.launches == before
    with pytest.raises(TypeError):
        K1.pcg_stencil(vals4.double(), op.F_root.double(), offsets=offs, tol=TOL, maxiter=8)
    with pytest.raises(ValueError):
        K1.pcg_stencil(vals4, op.F_root, offsets=offs, tol=TOL, maxiter=8, Wt=s["defl"].Wt_bf16)
    with pytest.raises(ValueError):
        K1.pcg_stencil(vals4[:, :, :-1], op.F_root, offsets=offs, tol=TOL, maxiter=8)
    with pytest.raises(ValueError):
        K1.pcg_stencil(vals4.transpose(0, 2).contiguous().transpose(0, 2), op.F_root,
                       offsets=offs, tol=TOL, maxiter=8)
