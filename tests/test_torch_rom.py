"""The port's ROM layer (bayesianinferencedl_tpu_torch.rom) against the JAX
reference on the same snapshots: host-f64 POD, Galerkin projection and P0
to 1e-10; the batched fixed-iteration reduced PCG and fast_forward to 1e-10
in float64 and 1e-5 in float32 (the reference's per-k solve_pcg with
differentiable=False)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.fem import oracle
from bayesianinferencedl_tpu.fem.dia import assemble_fin_dia as j_assemble
from bayesianinferencedl_tpu.rom.galerkin import ReducedOperator as JROM
from bayesianinferencedl_tpu.rom.pod import pod_basis_host as j_pod
from bayesianinferencedl_tpu_torch.fem.dia import assemble_fin_dia
from bayesianinferencedl_tpu_torch.rom.galerkin import ReducedOperator
from bayesianinferencedl_tpu_torch.rom.pod import pod_basis_host

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

BIOT = 0.1
R = 8
ITERS = 15


@pytest.fixture(scope="module")
def setup(mesh_r1):
    jhost = j_assemble(mesh_r1, pad_to=128)
    host = assemble_fin_dia(mesh_r1, pad_to=128)
    rng = np.random.default_rng(11)
    ks = np.exp(rng.uniform(np.log(0.1), np.log(10), (24, 5)))
    n_res = mesh_r1.resolution
    h = 0.25 / n_res
    gid = (np.rint((mesh_r1.nodes[:, 0] + 3.0) / h).astype(int) * (16 * n_res + 1)
           + np.rint(mesh_r1.nodes[:, 1] / h).astype(int))
    S = np.zeros((len(ks), host.n))
    for b, k in enumerate(ks):
        S[b, gid] = oracle.solve(mesh_r1, k, BIOT)
    V, _ = pod_basis_host(torch.from_numpy(S), R)
    Vj, _ = j_pod(jnp.asarray(S), R)
    ks_test = np.exp(rng.normal(0.0, 0.6, (10, 5)))
    return dict(jhost=jhost, host=host, S=S, V=V, Vj=Vj, ks=ks_test)


def test_pod_and_projection_equal_reference(setup):
    s = setup
    np.testing.assert_allclose(s["V"], s["Vj"], rtol=0, atol=1e-10)
    rj = JROM.project_host(s["jhost"], BIOT, s["Vj"], dtype=jnp.float64)
    rt = ReducedOperator.project_host(s["host"], BIOT, s["V"], dtype=torch.float64, device="cpu")
    for f in ("Ahat", "Mhat", "Fhat", "Bhat", "V"):
        a, b = getattr(rt, f).numpy(), np.asarray(getattr(rj, f))
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10 * np.abs(b).max(), err_msg=f)
    P0t, P0j = rt.preconditioner().numpy(), np.asarray(rj.preconditioner())
    np.testing.assert_allclose(P0t, P0j, rtol=1e-10, atol=1e-10 * np.abs(P0j).max())
    # Cholesky forward and assembly, batched vs per-k
    ks = s["ks"]
    yj = np.stack([np.asarray(rj.forward(jnp.asarray(k))) for k in ks])
    np.testing.assert_allclose(rt.forward(torch.from_numpy(ks)).numpy(), yj, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize(
    "tdt,jdt,tol", [(torch.float64, jnp.float64, 1e-10), (torch.float32, jnp.float32, 1e-5)],
    ids=["f64", "f32"],
)
def test_solve_pcg_and_fast_forward_match_reference(setup, tdt, jdt, tol):
    s = setup
    rj = JROM.project_host(s["jhost"], BIOT, s["Vj"], dtype=jdt)
    rt = ReducedOperator.project_host(s["host"], BIOT, s["V"], dtype=tdt, device="cpu")
    P0j, P0t = rj.preconditioner(), rt.preconditioner()
    ks = s["ks"]
    uj = np.asarray(jax.vmap(lambda k: rj.solve_pcg(k, P0j, ITERS, differentiable=False))(
        jnp.asarray(ks, jdt)))
    ut = rt.solve_pcg(torch.tensor(ks, dtype=tdt), P0t, ITERS).numpy()
    np.testing.assert_allclose(ut, uj, rtol=tol, atol=tol * np.abs(uj).max())
    ffj = rj.fast_forward(P0j, ITERS, differentiable=False)
    yj = np.asarray(jax.vmap(ffj)(jnp.asarray(ks, jdt)))
    yt = rt.fast_forward(P0t, ITERS)(torch.tensor(ks, dtype=tdt)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=tol, atol=tol * np.abs(yj).max())
    assert yt.dtype == np.dtype(str(tdt).split(".")[-1])
