"""Kernel K3's module (bayesianinferencedl_tpu_torch.ops.pcg_stencil,
``pcg_stencil_tile`` and the routing of ``solve_fom_stencil``) against the
JAX Pallas sublanes kernel in interpret mode and the SciPy float64 oracle, at
res1 with an m = 64 coarse space.

res1 (n = 512) is below the size where ``solve_fom_stencil`` takes K3, so
the solve tests lower that threshold to send it there. On the CPU the
wrapper runs the plain torch version; the CUDA kernel itself is held
against that plain version on the card by chip_smoke.py.

Tolerances are those of tests/test_torch_pcg_stencil.py: the JAX kernel
stops when its whole 8-sample tile has converged, the port per sample, so
the two solutions differ at the level the tolerance allows: per-sample
relative L2 difference < 5e-5 at tol 1e-6, and each within 5e-5 of the f64
direct solve."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bayesianinferencedl_tpu.fem import oracle
from bayesianinferencedl_tpu.fem.dia import StencilOperator as JStencil
from bayesianinferencedl_tpu.fem.dia import assemble_fin_dia as j_assemble
from bayesianinferencedl_tpu.ops.deflation import DeflationBasis as JDefl
from bayesianinferencedl_tpu.ops.pcg_stencil import pcg_stencil_batch_sublanes, solve_fom_stencil_pallas
from bayesianinferencedl_tpu_torch.fem.dia import StencilOperator, assemble_fin_dia
from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K
from bayesianinferencedl_tpu_torch.ops.deflation import DeflationBasis

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

BIOT = 0.1
TOL = 1e-6
B = 6  # not a multiple of the 8-sample tile: the JAX wrapper pads, K3 masks its last tile


@pytest.fixture(scope="module")
def setup(mesh_r1):
    jhost = j_assemble(mesh_r1, pad_to=128)
    jop = JStencil.from_host(jhost, biot=BIOT, dtype=jnp.float32)
    jdefl = JDefl.create(jhost, biot=BIOT, m=64, dtype=jnp.float32)
    host = assemble_fin_dia(mesh_r1, pad_to=128)
    op = StencilOperator.from_host(host, biot=BIOT, dtype=torch.float32, device="cpu")
    defl = DeflationBasis.create(host, biot=BIOT, m=64, device="cpu")
    ks = np.exp(np.random.default_rng(11).uniform(np.log(0.1), np.log(10), (B, 5))).astype(np.float32)
    h = 0.25 / mesh_r1.resolution
    ny = 16 * mesh_r1.resolution
    gi = np.rint((mesh_r1.nodes[:, 0] + 3.0) / h).astype(int)
    gj = np.rint(mesh_r1.nodes[:, 1] / h).astype(int)
    gid = gi * (ny + 1) + gj
    u_ref = [oracle.solve(mesh_r1, ks[b].astype(np.float64), BIOT) for b in range(B)]
    Binv_j = jdefl.coarse_inverses(jnp.asarray(ks), BIOT)
    return dict(jop=jop, jdefl=jdefl, op=op, defl=defl, ks=ks, gid=gid, u_ref=u_ref,
                Binv_j=Binv_j, Binv_t=torch.tensor(np.asarray(Binv_j)))


@pytest.fixture()
def via_k3(setup, monkeypatch):
    """Send solve_fom_stencil at res1 to K3's wrapper."""
    monkeypatch.setattr(K, "LANES_MAX_N", 0)
    assert K.layout_for(setup["op"].n) == "sublanes"


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _warm_starts(s):
    """The oracle solutions, perturbed by 1%."""
    rng = np.random.default_rng(5)
    x0 = np.zeros((B, s["op"].n), np.float32)
    for b in range(B):
        x0[b, s["gid"]] = s["u_ref"][b] * (1 + 1e-2 * rng.normal(size=s["u_ref"][b].shape))
    return x0


CASES = {
    "deflated_cold": dict(deflated=True, warm=False),
    "undeflated_cold": dict(deflated=False, warm=False),
    "deflated_warm": dict(deflated=True, warm=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_matches_pallas_sublanes_and_oracle(setup, via_k3, case):
    s = setup
    c = CASES[case]
    x0 = _warm_starts(s) if c["warm"] else None
    jkw = dict(deflation=s["jdefl"], coarse_inv=s["Binv_j"]) if c["deflated"] else {}
    with pltpu.force_tpu_interpret_mode():
        u_j, it_j = solve_fom_stencil_pallas(
            s["jop"], jnp.asarray(s["ks"]), tol=TOL, maxiter=800, layout="sublanes", sample_tile=8,
            x0=None if x0 is None else jnp.asarray(x0), **jkw,
        )
    tkw = dict(deflation=s["defl"], coarse_inv=s["Binv_t"]) if c["deflated"] else {}
    before = K.tile_launches
    u_t, it_t = K.solve_fom_stencil(
        s["op"], torch.from_numpy(s["ks"]), tol=TOL, maxiter=800,
        x0=None if x0 is None else torch.from_numpy(x0), **tkw,
    )
    assert K.tile_launches == before  # CPU tensors: the plain version, no launch
    assert u_t.dtype == torch.float32 and it_t.dtype == torch.int32 and u_t.shape == (B, s["op"].n)
    u_t, u_j = u_t.numpy(), np.asarray(u_j)
    for b in range(B):
        assert _rel(u_t[b], u_j[b]) < 5e-5, (b, _rel(u_t[b], u_j[b]))
        for u in (u_t, u_j):
            rel = _rel(u[b][s["gid"]], s["u_ref"][b])
            assert rel < 5e-5, (b, rel)
    # per-sample counts: whole check blocks, none past its tile's joint count
    it_t, it_j = it_t.numpy(), np.asarray(it_j)
    assert np.all(it_t % 16 == 0) and np.all(it_t > 0)
    assert np.all(it_t <= it_j)


def test_cold_start_equals_zero_start_and_deflation_halves_iterations(setup, via_k3):
    s = setup
    ks = torch.from_numpy(s["ks"])
    kw = dict(tol=TOL, maxiter=800, deflation=s["defl"], coarse_inv=s["Binv_t"])
    u_c, it_c = K.solve_fom_stencil(s["op"], ks, **kw)
    u_z, it_z = K.solve_fom_stencil(s["op"], ks, x0=torch.zeros(B, s["op"].n), **kw)
    assert torch.equal(u_c, u_z) and torch.equal(it_c, it_z)
    _, it_u = K.solve_fom_stencil(s["op"], ks, tol=TOL, maxiter=800)
    assert np.all(it_c.numpy() * 2 <= it_u.numpy())


@pytest.mark.parametrize("deflated", [True, False])
def test_cap_hits_agree_with_pallas(setup, deflated):
    """A cap that stops the undeflated solves but not the deflated ones: the
    same samples hit it in both (JAX counts per tile, the port per sample,
    so the test compares cap hits, not counts)."""
    s = setup
    cap = 48
    ks8 = np.concatenate([s["ks"], s["ks"][:2]])  # one full 8-sample tile
    jvals = jax.vmap(s["jop"].vals)(jnp.asarray(ks8))
    jkw, tkw = {}, {}
    if deflated:
        Binv = s["jdefl"].coarse_inverses(jnp.asarray(ks8), BIOT)
        jkw = dict(Wt=s["jdefl"].Wt, Binv=Binv)
        tkw = dict(Wt=s["defl"].Wt_bf16, Binv=torch.tensor(np.asarray(Binv)))
    with pltpu.force_tpu_interpret_mode():
        _, it_j = pcg_stencil_batch_sublanes(
            jvals, s["jop"].F_root, None, tol=TOL, maxiter=cap, tile=8,
            offsets=tuple(int(o) for o in s["jop"].offsets), **jkw,
        )
    vals4 = K.upper_planes(s["op"].vals(torch.from_numpy(ks8)))
    _, it_t = K.pcg_stencil_tile(vals4, s["op"].F_root, None, offsets=s["op"].offsets[4:], tol=TOL,
                                 maxiter=cap, **tkw)
    hit_j, hit_t = np.asarray(it_j) >= cap, it_t.numpy() >= cap
    np.testing.assert_array_equal(hit_t, hit_j)
    assert hit_t.all() != deflated


def test_routing_by_size():
    assert K.LANES_MAX_N == 18_618  # 11 * n * 128 * 4 bytes <= 100 MiB
    assert K.layout_for(6_400) == "lanes"  # res4, K1
    assert K.layout_for(24_960) == "sublanes"  # res8, K3
    assert K.layout_for(99_072) == "sublanes"  # res16, K3
    assert K.layout_for(K.LANES_MAX_N) == "lanes"
    assert K.layout_for(K.LANES_MAX_N + 1) == "sublanes"


def test_wrapper_checks_inputs_and_counts_only_launches(setup):
    s = setup
    op = s["op"]
    vals4 = K.upper_planes(op.vals(torch.from_numpy(s["ks"])))
    offs = op.offsets[4:]
    Wt, Binv = s["defl"].Wt_bf16, s["Binv_t"]
    before = K.tile_launches
    x, it = K.pcg_stencil_tile(vals4, op.F_root, offsets=offs, tol=TOL, maxiter=8, Wt=Wt, Binv=Binv)
    assert K.tile_launches == before and x.shape == (B, op.n) and it.tolist() == [8] * B
    with pytest.raises(TypeError):
        K.pcg_stencil_tile(vals4.double(), op.F_root.double(), offsets=offs, tol=TOL, maxiter=8)
    with pytest.raises(TypeError):
        K.pcg_stencil_tile(vals4, op.F_root, offsets=offs, tol=TOL, maxiter=8, Wt=Wt.float(), Binv=Binv)
    with pytest.raises(ValueError, match="together"):
        K.pcg_stencil_tile(vals4, op.F_root, offsets=offs, tol=TOL, maxiter=8, Wt=Wt)
    with pytest.raises(ValueError, match="multiple of 8"):  # K3 reads 8-value words even undeflated
        K.pcg_stencil_tile(vals4[:, :, :-4].contiguous(), op.F_root[:-4], offsets=offs, tol=TOL,
                           maxiter=8)
    with pytest.raises(ValueError, match="at most 128"):
        wide = torch.zeros(129, op.n, dtype=torch.bfloat16)
        K.pcg_stencil_tile(vals4, op.F_root, offsets=offs, tol=TOL, maxiter=8, Wt=wide,
                           Binv=torch.zeros(B, 129, 129))
    with pytest.raises(ValueError, match="shape"):
        K.pcg_stencil_tile(vals4, op.F_root, torch.zeros(B, op.n - 8), offsets=offs, tol=TOL, maxiter=8)
    with pytest.raises(ValueError, match="contiguous"):
        K.pcg_stencil_tile(vals4.transpose(0, 2).contiguous().transpose(0, 2), op.F_root,
                           offsets=offs, tol=TOL, maxiter=8)
