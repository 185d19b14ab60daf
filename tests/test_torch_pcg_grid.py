"""Kernel K4's module (bayesianinferencedl_tpu_torch.ops.pcg_stencil:
``pcg_stencil_grid``, ``layout_for`` and the "single" route of
``solve_fom_stencil``, reached at res1 by lowering the size thresholds) and the grid views of ``fem/dia.py``, against the JAX
package's single-sample Pallas kernel in interpret mode and the SciPy float64
oracle, at res1.

On the CPU the wrapper runs the plain torch version; the CUDA kernel itself
is held against that plain version on the card by chip_smoke.py. Both sides
test convergence before every iteration and per sample, so in float64 the
solutions agree to 1e-10 and the iteration counts are equal. In float32 at
tol 1e-6 the summation orders differ, and near the tolerance a residual
norm that is not monotone can stop a sample a few iterations apart: the
solutions agree to 1e-5 relative and the counts to within 4 iterations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bayesianinferencedl_tpu.fem import oracle
from bayesianinferencedl_tpu.fem.dia import StencilOperator as JStencil
from bayesianinferencedl_tpu.fem.dia import assemble_fin_dia as j_assemble
from bayesianinferencedl_tpu.ops.pcg_stencil import pick_layout, solve_fom_stencil_pallas
from bayesianinferencedl_tpu_torch.fem.dia import StencilOperator, assemble_fin_dia
from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

BIOT = 0.1
B = 4
MAXITER = 800
COUNT_BAND_F32 = 4  # iterations; see the module docstring
DTYPES = {"f64": (jnp.float64, torch.float64, 1e-10, 1e-10),
          "f32": (jnp.float32, torch.float32, 1e-6, 1e-5)}  # (jax, torch, tol, rel gate)


@pytest.fixture(scope="module")
def setup(mesh_r1):
    jhost = j_assemble(mesh_r1, pad_to=128)
    host = assemble_fin_dia(mesh_r1, pad_to=128)
    ops = {name: (JStencil.from_host(jhost, biot=BIOT, dtype=jdt),
                  StencilOperator.from_host(host, biot=BIOT, dtype=tdt, device="cpu"))
           for name, (jdt, tdt, _, _) in DTYPES.items()}
    ks = np.exp(np.random.default_rng(3).uniform(np.log(0.1), np.log(10), (B, 5)))
    h = 0.25 / mesh_r1.resolution
    ny = 16 * mesh_r1.resolution
    gi = np.rint((mesh_r1.nodes[:, 0] + 3.0) / h).astype(int)
    gj = np.rint(mesh_r1.nodes[:, 1] / h).astype(int)
    gid = gi * (ny + 1) + gj
    u_ref = [oracle.solve(mesh_r1, ks[b], BIOT) for b in range(B)]
    x0 = np.zeros((B, host.n))
    rng = np.random.default_rng(5)
    for b in range(B):  # warm starts: the oracle solutions perturbed by 1%
        x0[b, gid] = u_ref[b] * (1 + 1e-2 * rng.normal(size=u_ref[b].shape))
    return dict(ops=ops, ks=ks, gid=gid, u_ref=u_ref, x0=x0)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture()
def via_k4(setup, monkeypatch):
    """Send solve_fom_stencil at res1 to K4's "single" route."""
    monkeypatch.setattr(K, "LANES_MAX_N", 0)
    monkeypatch.setattr(K, "SUBLANES_MAX_N", 0)
    assert K.layout_for(setup["ops"]["f32"][1].n) == "single"


def test_grid_views_equal_reference(setup):
    jop, top = setup["ops"]["f64"]
    assert top.grid_shape0 == jop.grid_shape0 and top.grid_shape == jop.grid_shape
    v = np.random.default_rng(0).normal(size=(3, top.n))
    g = top.to_grid(torch.from_numpy(v))
    for b in range(3):
        jg = np.asarray(jop.to_grid(jnp.asarray(v[b])))
        np.testing.assert_array_equal(g[b].numpy(), jg)
        np.testing.assert_array_equal(top.from_grid(g[b]).numpy(), np.asarray(jop.from_grid(jnp.asarray(jg))))
    np.testing.assert_array_equal(top.from_grid(g).numpy()[:, : top.n_grid], v[:, : top.n_grid])
    assert (top.from_grid(g).numpy()[:, top.n_grid:] == 0).all()
    ks = setup["ks"]
    tv = top.vals_grid(torch.from_numpy(ks))
    assert tv.shape == (B, 7, *top.grid_shape) and tv.is_contiguous()
    for b in range(B):
        np.testing.assert_array_equal(tv[b].numpy(), np.asarray(jop.vals_grid(jnp.asarray(ks[b]))))


CASES = [(dt, warm) for dt in DTYPES for warm in (False, True)]


@pytest.mark.parametrize("dtype,warm", CASES, ids=[f"{d}-{'warm' if w else 'cold'}" for d, w in CASES])
def test_single_layout_matches_pallas_and_oracle(setup, via_k4, dtype, warm):
    jdt, tdt, tol, gate = DTYPES[dtype]
    jop, top = setup["ops"][dtype]
    ks, x0 = setup["ks"], setup["x0"] if warm else None
    with pltpu.force_tpu_interpret_mode():
        u_j, it_j = solve_fom_stencil_pallas(
            jop, jnp.asarray(ks, jdt), tol=tol, maxiter=MAXITER, layout="single",
            x0=None if x0 is None else jnp.asarray(x0, jdt))
    before = K.grid_launches
    u_t, it_t = K.solve_fom_stencil(top, torch.from_numpy(ks), tol=tol, maxiter=MAXITER,
                                    x0=None if x0 is None else torch.from_numpy(x0).to(tdt))
    assert K.grid_launches == before  # CPU tensors: the plain version, no launch
    assert u_t.dtype == tdt and it_t.dtype == torch.int32 and u_t.shape == (B, top.n)
    u_t, u_j, it_t, it_j = u_t.numpy(), np.asarray(u_j), it_t.numpy(), np.asarray(it_j)
    assert (it_t > 0).all() and (it_t < MAXITER).all()
    if dtype == "f64":
        np.testing.assert_array_equal(it_t, it_j)
    else:
        assert np.abs(it_t - it_j).max() <= COUNT_BAND_F32, (it_t, it_j)
    for b in range(B):
        assert _rel(u_t[b], u_j[b]) < gate, (b, _rel(u_t[b], u_j[b]))
        assert (u_t[b][top.n_grid:] == 0).all()
        rel = _rel(u_t[b][setup["gid"]], setup["u_ref"][b])
        assert rel < 5e-5, (b, rel)  # the gate of tests/test_pallas_ops.py


def test_single_layout_neither_applies_nor_computes_deflation(setup, via_k4, monkeypatch):
    _, top = setup["ops"]["f32"]
    ks = torch.from_numpy(setup["ks"])
    u, it = K.solve_fom_stencil(top, ks, tol=1e-6, maxiter=MAXITER)
    # any use of the basis or of the coarse inverses would raise or spread NaN
    u_d, it_d = K.solve_fom_stencil(top, ks, tol=1e-6, maxiter=MAXITER,
                                    deflation=object(), coarse_inv=torch.full((B, 8, 8), torch.nan))
    assert torch.equal(u, u_d) and torch.equal(it, it_d)
    # make_fom_solver and FiveParamFin.solve_batch on the single route build no basis
    from bayesianinferencedl_tpu_torch import api
    from bayesianinferencedl_tpu_torch.ops.deflation import DeflationBasis

    def no_basis(*a, **kw):
        raise AssertionError("a deflation basis was built on the single route")

    monkeypatch.setattr(DeflationBasis, "create", no_basis)
    fin = FiveParamFin.create(resolution=1, device="cpu", cg_tol=1e-6, cg_maxiter=MAXITER)
    u_s, it_s = api.make_fom_solver(fin, tol=1e-6, maxiter=MAXITER, with_iters=True)(ks)
    assert torch.equal(it_s, it) and torch.equal(u_s, u)
    assert torch.equal(fin.solve_batch(ks), u) and fin._deflation is None


def test_wrapper_checks_inputs(setup):
    _, top = setup["ops"]["f32"]
    ks = torch.from_numpy(setup["ks"])
    v2, F2 = top.vals_grid(ks), top.to_grid(top.F_root)
    x, it = K.pcg_stencil_grid(v2, F2, tol=1e-6, maxiter=3)
    assert x.shape == (B, *top.grid_shape) and it.tolist() == [3] * B
    x, it = K.pcg_stencil_grid(v2, F2, x, tol=1e-6, maxiter=0)
    assert it.tolist() == [0] * B
    with pytest.raises(ValueError, match=r"\(B, 7, X, Y\)"):
        K.pcg_stencil_grid(v2[:, :4].contiguous(), F2, tol=1e-6, maxiter=3)
    with pytest.raises(TypeError):
        K.pcg_stencil_grid(v2.half(), F2.half(), tol=1e-6, maxiter=3)
    with pytest.raises(TypeError):
        K.pcg_stencil_grid(v2, F2.double(), tol=1e-6, maxiter=3)
    with pytest.raises(ValueError, match="shape"):
        K.pcg_stencil_grid(v2, F2[:-1].contiguous(), tol=1e-6, maxiter=3)
    with pytest.raises(ValueError, match="contiguous"):
        K.pcg_stencil_grid(v2, F2.T.contiguous().T, tol=1e-6, maxiter=3)
    with pytest.raises(ValueError, match="maxiter"):
        K.pcg_stencil_grid(v2, F2, tol=1e-6, maxiter=-1)
    with pytest.raises(ValueError, match="multiple of 4"):
        K.pcg_stencil_grid(v2[..., :-2].contiguous(), F2[:, :-2].contiguous(), tol=1e-6, maxiter=3)


def _n(res: int) -> int:
    """The padded node count of assemble_fin_dia at a resolution."""
    n_grid = (24 * res + 1) * (16 * res + 1)
    return -(-n_grid // 128) * 128


def test_layout_for_equals_pick_layout():
    assert K.SUBLANES_MAX_N == 182_044
    assert _n(1) == 512 and _n(21) == 170_240 and _n(22) == 186_752 and _n(32) == 394_624
    for res in range(1, 33):
        n = _n(res)
        assert K.layout_for(n) == pick_layout(n, 256)[0], res
    assert K.layout_for(K.SUBLANES_MAX_N) == "sublanes" and K.layout_for(K.SUBLANES_MAX_N + 1) == "single"
    assert pick_layout(K.SUBLANES_MAX_N, 256)[0] == "sublanes"
    assert pick_layout(K.SUBLANES_MAX_N + 1, 256)[0] == "single"
