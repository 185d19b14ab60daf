"""The ELL oracle layout of the port (fem/assemble.py, fem/operators.py,
fem/oracle.py, utils/adjoint.py, the device POD and generate_snapshots, the
"ell" FiveParamFin and its routes through api and infer/oed) against the JAX
package, in float64 at res1 and res2 on the same seeded NumPy inputs.

The host assembly is bit-identical; the operator's values, products and
observables agree to 1e-12, the oracle's matrices and loads to 1e-14, the
solves to 1e-8 of the oracle, the autograd and hand-coded adjoint
derivatives to 1e-8 relative, the POD projector V V^T to 1e-10 and the
Galerkin projection to 1e-10. An ELL fin never reaches the stencil kernels:
every FOM solve goes through the plain PCG of fem/solve.py, and
build_pipeline takes the device POD and the device projection."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.fem import assemble as j_asm
from bayesianinferencedl_tpu.fem import oracle as j_oracle
from bayesianinferencedl_tpu.fem.operators import FinOperator as JOp
from bayesianinferencedl_tpu.geometry import build_fin_mesh as j_mesh
from bayesianinferencedl_tpu.infer import oed as j_oed
from bayesianinferencedl_tpu.models.five_param import FiveParamFin as JFin
from bayesianinferencedl_tpu.rom import pod as j_pod
from bayesianinferencedl_tpu.rom.galerkin import ReducedOperator as JROM
from bayesianinferencedl_tpu.rom.snapshots import generate_snapshots as j_snapshots
from bayesianinferencedl_tpu.utils import adjoint as j_adj
from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch import config as tcfg
from bayesianinferencedl_tpu_torch.fem import assemble as t_asm
from bayesianinferencedl_tpu_torch.fem import oracle as t_oracle
from bayesianinferencedl_tpu_torch.fem.operators import FinOperator
from bayesianinferencedl_tpu_torch.fem.solve import solve_fom
from bayesianinferencedl_tpu_torch.geometry import build_fin_mesh
from bayesianinferencedl_tpu_torch.infer import oed
from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
from bayesianinferencedl_tpu_torch.rom import galerkin, pod
from bayesianinferencedl_tpu_torch.rom.snapshots import generate_snapshots
from bayesianinferencedl_tpu_torch.utils import adjoint as t_adj
from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

F64 = torch.float64
BIOT = 0.1
SIGMA = 0.01
K_TEST = np.array([0.4, 1.7, 3.1, 0.9, 1.2])
KS = np.exp(np.random.default_rng(5).uniform(np.log(0.1), np.log(10.0), (12, 5)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def ops():
    """(JAX op, port op, port mesh) at res1, float64, pad_to 128."""
    host = t_asm.assemble_fin(build_fin_mesh(1))
    jop = JOp.from_host(j_asm.assemble_fin(j_mesh(1)), biot=BIOT, dtype=jnp.float64)
    return jop, FinOperator.from_host(host, biot=BIOT, dtype=F64, device="cpu"), build_fin_mesh(1)


@pytest.fixture(scope="module")
def fins():
    """(JAX, port) ELL fins and the port's stencil fin at res1, float64, tol 1e-12."""
    kw = dict(resolution=1, biot=BIOT, cg_tol=1e-12, cg_maxiter=4000)
    return (JFin.create(dtype=jnp.float64, layout="ell", **kw),
            FiveParamFin.create(dtype=F64, device="cpu", layout="ell", **kw),
            FiveParamFin.create(dtype=F64, device="cpu", **kw))


@pytest.mark.parametrize("resolution, pad_to", [(1, 128), (2, 128), (2, 8)])
def test_assemble_fin_bit_identical(resolution, pad_to):
    jh = j_asm.assemble_fin(j_mesh(resolution), pad_to=pad_to)
    th = t_asm.assemble_fin(build_fin_mesh(resolution), pad_to=pad_to)
    for f in ("cols", "comp_vals", "ext_mass", "fixed", "diag_slot", "F_root", "qoi", "qoi_root"):
        a, b = getattr(th, f), getattr(jh, f)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    assert (th.n_dof, th.resolution, th.n, th.ell_width, th.n_obs) == (
        jh.n_dof, jh.resolution, jh.n, jh.ell_width, jh.n_obs)
    assert th.n % pad_to == 0


@pytest.mark.parametrize("method", ["vals", "matvec", "apply_component", "apply_ext_mass", "diag",
                                    "observe", "materialize"])
def test_operator_matches_reference(ops, method):
    jop, top, _ = ops
    rng = np.random.default_rng(7)
    u = rng.standard_normal((3, top.n))
    ks = np.exp(rng.normal(0, 0.5, (3, 5)))
    for b in range(3):
        jk, tk = jnp.asarray(ks[b]), torch.from_numpy(ks[b])
        ju, tu = jnp.asarray(u[b]), torch.from_numpy(u[b])
        want, got = {
            "vals": (lambda: jop.vals(jk), lambda: top.vals(tk)),
            "matvec": (lambda: jop.matvec(jop.vals(jk), ju), lambda: top.matvec(top.vals(tk), tu)),
            "apply_component": (lambda: jnp.stack([jop.apply_component(i, ju) for i in range(5)]),
                                lambda: torch.stack([top.apply_component(i, tu) for i in range(5)])),
            "apply_ext_mass": (lambda: jop.apply_ext_mass(ju), lambda: top.apply_ext_mass(tu)),
            "diag": (lambda: jop.diag(jop.vals(jk)), lambda: top.diag(top.vals(tk))),
            "observe": (lambda: jop.observe(ju), lambda: top.observe(tu)),
            "materialize": (lambda: jop.materialize(jk), lambda: top.materialize(tk)),
        }[method]
        np.testing.assert_allclose(got().numpy(), np.asarray(want()), rtol=0, atol=1e-12)
    # the batched forms equal the per-sample ones
    tks, tus = torch.from_numpy(ks), torch.from_numpy(u)
    batched = {"vals": lambda: top.vals(tks), "matvec": lambda: top.matvec(top.vals(tks), tus),
               "apply_component": lambda: top.apply_component(2, tus),
               "apply_ext_mass": lambda: top.apply_ext_mass(tus),
               "diag": lambda: top.diag(top.vals(tks)), "observe": lambda: top.observe(tus)}
    if method in batched:
        single = {"vals": lambda b: top.vals(tks[b]),
                  "matvec": lambda b: top.matvec(top.vals(tks[b]), tus[b]),
                  "apply_component": lambda b: top.apply_component(2, tus[b]),
                  "apply_ext_mass": lambda b: top.apply_ext_mass(tus[b]),
                  "diag": lambda b: top.diag(top.vals(tks[b])), "observe": lambda b: top.observe(tus[b])}
        got = batched[method]()
        for b in range(3):
            np.testing.assert_allclose(got[b].numpy(), single[method](b).numpy(), rtol=0, atol=1e-13)
    if method == "materialize":  # the padding rows are the identity
        A, nd = top.materialize(torch.from_numpy(K_TEST)).numpy(), top.n_dof
        np.testing.assert_array_equal(A[nd:, nd:], np.eye(top.n - nd))
        assert top.astype(torch.float32).vals(torch.ones(5)).dtype == torch.float32


@pytest.mark.parametrize("what", ["system_matrix", "root_load", "general_load", "stiffness_components"])
def test_oracle_matches_reference(what):
    jm, tm = j_mesh(2), build_fin_mesh(2)
    rng = np.random.default_rng(3)
    f, g_root, g_ext = (rng.standard_normal(tm.n_nodes) for _ in range(3))
    if what == "system_matrix":
        pairs = [(t_oracle.system_matrix(tm, K_TEST, BIOT), j_oracle.system_matrix(jm, K_TEST, BIOT))]
    elif what == "stiffness_components":
        pairs = list(zip(t_oracle.stiffness_components(tm), j_oracle.stiffness_components(jm)))
        pairs += [(t_oracle.boundary_mass(tm, w), j_oracle.boundary_mass(jm, w)) for w in ("ext", "root")]
        pairs += [(t_oracle.volume_mass(tm), j_oracle.volume_mass(jm))]
    elif what == "root_load":
        pairs = [(t_oracle.root_load(tm), j_oracle.root_load(jm))]
    else:
        pairs = [(t_oracle.general_load(tm, f, g_root, g_ext), j_oracle.general_load(jm, f, g_root, g_ext)),
                 (t_oracle.general_load(tm, f_nodal=f), j_oracle.general_load(jm, f_nodal=f))]
    for a, b in pairs:
        a = a.toarray() if hasattr(a, "toarray") else a
        b = b.toarray() if hasattr(b, "toarray") else b
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-14)


def test_ell_solve_matches_oracle_1e8():
    """The reference's 1e-8 gate on the float64 path (tests/test_fem.py),
    on the port's own oracle, at res2; the padding rows stay 0."""
    mesh = build_fin_mesh(2)
    op = FinOperator.from_host(t_asm.assemble_fin(mesh, pad_to=8), biot=BIOT, dtype=F64, device="cpu")
    u = solve_fom(op, torch.from_numpy(K_TEST), tol=1e-12, maxiter=4000).numpy()
    u_ref = t_oracle.solve(mesh, K_TEST, BIOT)
    assert _rel(u[: mesh.n_nodes], u_ref) < 1e-8
    np.testing.assert_allclose(u[mesh.n_nodes:], 0.0, atol=1e-12)
    # and the ELL matrix is the oracle's
    A = op.materialize(torch.from_numpy(K_TEST)).numpy()[: mesh.n_nodes, : mesh.n_nodes]
    np.testing.assert_allclose(A, t_oracle.system_matrix(mesh, K_TEST, BIOT).toarray(), atol=1e-12)


@pytest.mark.parametrize("which", ["gradient", "hvp", "gn_hvp"])
def test_autograd_derivatives_match_reference(fins, which):
    jfin, tfin, _ = fins
    rng = np.random.default_rng(11)
    k = np.exp(rng.normal(0, 0.4, 5))
    v = rng.normal(size=5)
    data = np.asarray(jfin.forward(jnp.ones(5))) * 1.02
    jk, jv, jd = jnp.asarray(k), jnp.asarray(v), jnp.asarray(data)
    if which == "gradient":
        want, got = jfin.gradient(jk, jd, SIGMA), tfin.gradient(k, data, SIGMA)
    elif which == "hvp":
        want, got = jfin.hvp(jk, jv, jd, SIGMA), tfin.hvp(k, v, data, SIGMA)
    else:
        want, got = jfin.gn_hvp(jk, jv, SIGMA), tfin.gn_hvp(k, v, SIGMA)
    assert _rel(got.numpy(), want) < 1e-8


@pytest.mark.parametrize("layout", ["ell", "dia"])
@pytest.mark.parametrize("which", ["gradient", "gn_hvp"])
def test_adjoint_matches_reference_and_autograd(fins, layout, which):
    jfin, tell, tdia = fins
    tfin = tell if layout == "ell" else tdia
    k = np.array([0.7, 1.4, 2.2, 0.9, 1.1])
    v = np.array([0.3, -0.2, 0.5, 0.1, -0.4])
    data = tfin.forward_batch(torch.ones(1, 5, dtype=F64))[0].numpy() * 1.02
    if which == "gradient":
        got = t_adj.adjoint_gradient(tfin.op, k, data, SIGMA)
        auto = tfin.gradient(k, data, SIGMA)
        want = j_adj.adjoint_gradient(jfin.op, jnp.asarray(k), jnp.asarray(data), SIGMA)
        batch = t_adj.adjoint_gradient(tfin.op, np.stack([k, 1.1 * k]), np.stack([data, data]), SIGMA)
    else:
        got = t_adj.adjoint_gn_hvp(tfin.op, k, v, SIGMA)
        auto = tfin.gn_hvp(k, v, SIGMA)
        want = j_adj.adjoint_gn_hvp(jfin.op, jnp.asarray(k), jnp.asarray(v), SIGMA)
        batch = t_adj.adjoint_gn_hvp(tfin.op, np.stack([k, 1.1 * k]), np.stack([v, v]), SIGMA)
    assert _rel(got.numpy(), auto.numpy()) < 1e-8
    assert _rel(got.numpy(), want) < 1e-8  # the same QoI on either layout: the same derivative
    assert _rel(batch[0].numpy(), got.numpy()) < 1e-12


def test_snapshots_and_pod_match_reference(ops):
    jop, top, _ = ops
    S = generate_snapshots(top, torch.from_numpy(KS), tol=1e-12, maxiter=4000)
    S_chunked = generate_snapshots(top, torch.from_numpy(KS), tol=1e-12, maxiter=4000, chunk=5)
    assert torch.equal(S, S_chunked)
    S_j = np.asarray(jax.jit(lambda ks: j_snapshots(jop, ks, tol=1e-12, maxiter=4000))(jnp.asarray(KS)))
    assert _rel(S.numpy(), S_j) < 1e-10
    r = 6
    res = pod.pod_basis(S, r)
    jres = j_pod.pod_basis(jnp.asarray(S.numpy()), r)
    V, Vj = res.V.numpy(), np.asarray(jres.V)
    assert np.abs(V @ V.T - Vj @ Vj.T).max() < 1e-10
    np.testing.assert_allclose(res.singular_values.numpy(), np.asarray(jres.singular_values),
                               rtol=1e-10, atol=1e-12 * float(jres.singular_values[0]))
    np.testing.assert_allclose(res.energy.numpy(), np.asarray(jres.energy), rtol=0, atol=1e-12)
    e_t, e_j = float(pod.orthonormality_error(res.V)), float(j_pod.orthonormality_error(jres.V))
    assert e_t < 1e-10 and e_j < 1e-10  # the same gate passes on both
    # the device projection onto the same V
    rom, jrom = galerkin.ReducedOperator.project(top, res.V), JROM.project(jop, jnp.asarray(V))
    for f in ("Ahat", "Mhat", "Fhat", "Bhat"):
        a, b = getattr(rom, f).numpy(), np.asarray(getattr(jrom, f))
        assert np.abs(a - b).max() <= 1e-10 * max(1.0, np.abs(b).max()), f


@pytest.mark.parametrize("layout", ["ell", "dia"])
def test_solution_indices_match_reference(layout):
    jfin = JFin.create(resolution=2, dtype=jnp.float64, layout=layout)
    tfin = FiveParamFin.create(resolution=2, dtype=F64, device="cpu", layout=layout)
    np.testing.assert_array_equal(oed.solution_indices(tfin), j_oed.solution_indices(jfin))
    # the field at the mesh nodes is the same on either layout
    u = tfin.solve_batch(torch.from_numpy(K_TEST)[None])[0].numpy()[oed.solution_indices(tfin)]
    assert _rel(u, t_oracle.solve(tfin.mesh, K_TEST, BIOT)) < 1e-8


def _no_kernel(*a, **k):
    raise AssertionError("an ELL fin reached the stencil kernels")


def test_ell_routes_to_plain_pcg(fins, monkeypatch):
    _, tell, tdia = fins
    assert tell.deflation_basis() is None and tell.deflation_for_kernels() is None
    assert tell.assembler == "numpy" and tell.op.n_dof == tell.mesh.n_nodes
    with pytest.raises(ValueError, match="layout"):
        FiveParamFin.create(resolution=1, device="cpu", layout="csr")
    fin32 = FiveParamFin.create(resolution=1, dtype=torch.float32, device="cpu", layout="ell",
                                cg_tol=1e-6, cg_maxiter=2000)
    monkeypatch.setattr(api, "solve_fom_stencil", _no_kernel)
    thetas = torch.log(torch.from_numpy(KS[:4]))
    y = api.batched_fom_observe(fin32)(thetas.float())
    u, iters = api.make_fom_solver(fin32, tol=1e-6, maxiter=2000, with_iters=True)(KS[:4])
    assert u.dtype == torch.float32 and (iters < 2000).all()
    y64 = api.batched_fom_observe(tell)(thetas)
    assert _rel(y.numpy(), y64.numpy()) < 1e-5
    # the float32 stencil fin still takes the kernels' wrapper
    with pytest.raises(AssertionError, match="stencil kernels"):
        api.make_fom_solver(FiveParamFin.create(resolution=1, device="cpu"), tol=1e-6, maxiter=10)(KS[:1])


def test_ell_build_pipeline_takes_the_device_route(monkeypatch):
    calls = {"pod_basis": 0, "project": 0}
    real_pod, real_project = api.pod_basis, galerkin.ReducedOperator.project.__func__

    def pod_spy(S, r):
        calls["pod_basis"] += 1
        return real_pod(S, r)

    def project_spy(cls, op, V):
        calls["project"] += 1
        return real_project(cls, op, V)

    def refuse(*a, **k):
        raise AssertionError("the host float64 route on an ELL fin")

    monkeypatch.setattr(api, "solve_fom_stencil", _no_kernel)
    monkeypatch.setattr(api, "pod_basis", pod_spy)
    monkeypatch.setattr(api, "pod_basis_host", refuse)
    monkeypatch.setattr(galerkin.ReducedOperator, "project", classmethod(project_spy))
    monkeypatch.setattr(galerkin.ReducedOperator, "project_host", classmethod(refuse))
    cfg = tcfg.PipelineConfig(
        mesh=tcfg.MeshConfig(resolution=1), fem=tcfg.FEMConfig(cg_tol=1e-10, cg_maxiter=3000),
        rom=tcfg.ROMConfig(n_snapshots=32, basis_size=8),
        surrogate=tcfg.SurrogateConfig(hidden=(8, 8), n_train=32, epochs=2),
        mcmc=tcfg.MCMCConfig(noise_sigma=1e-2),
    )
    fin = FiveParamFin.create(resolution=1, dtype=F64, device="cpu", layout="ell", cg_tol=1e-10)
    log = MetricsLogger()
    pipe = api.build_pipeline(cfg, device="cpu", dtype=F64, fin=fin, metrics=log)
    assert calls == {"pod_basis": 1, "project": 1}
    s = log.summary()
    assert s["rom_built"]["f64_offline"] is False and s["fom_built"]["m"] is None
    assert s["fom_built"]["assembler"] == "numpy"
    assert pipe.rom.V.shape == (fin.op.n, 8)
    assert float(pod.orthonormality_error(pipe.rom.V)) < 1e-10
    ks = torch.from_numpy(KS[:4])
    assert _rel(pipe.rom.forward(ks).numpy(), fin.forward_batch(ks).numpy()) < 0.1
    assert s["holdout_rel_err"]["rom"] < 0.1
