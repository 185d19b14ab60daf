"""The greedy reduced basis in the port (rom/greedy.py, the device
ReducedOperator.project / residual_norm, build_pipeline(method="greedy"),
rom --method greedy) against the JAX reference, in float64 at res1.

1. ReducedOperator.project equals JAX's projection to 1e-12 and equals the
   host float64 projection; residual_norm over a batch equals JAX's vmapped
   one to 1e-10.
2. greedy_basis on the greedy build's candidates: the selected indices
   equal, V and the snapshots within 1e-8 of JAX's, the indicators within
   1e-8, and
   orthonormalize_host's V^T V = I to 1e-12; the reference's cases (an
   orthonormal basis, falling indicators, a ROM within 10% of the FOM, and
   within 3x POD's error at equal r).
3. build_pipeline(method="greedy") equals the host QR of JAX's greedy basis
   over the same candidates, and rom --method greedy prints the reference
   CLI's keys with a relative error below 0.1."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu import cli as jcli
from bayesianinferencedl_tpu.models.five_param import FiveParamFin as JFin
from bayesianinferencedl_tpu.rom import greedy as jg
from bayesianinferencedl_tpu.rom.galerkin import ReducedOperator as JROM
from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch import cli as tcli
from bayesianinferencedl_tpu_torch import config as tcfg
from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
from bayesianinferencedl_tpu_torch.rom import greedy as tg
from bayesianinferencedl_tpu_torch.rom.galerkin import ReducedOperator
from bayesianinferencedl_tpu_torch.rom.pod import pod_basis_host
from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

F64 = torch.float64
KS = np.exp(np.random.default_rng(0).uniform(np.log(0.1), np.log(10.0), (48, 5)))
GREEDY_CFG = tcfg.PipelineConfig(
    mesh=tcfg.MeshConfig(resolution=1), fem=tcfg.FEMConfig(cg_tol=1e-12, cg_maxiter=4000),
    rom=tcfg.ROMConfig(n_snapshots=40, basis_size=8, method="greedy", greedy_candidates=24),
    surrogate=tcfg.SurrogateConfig(hidden=(8, 8), n_train=32, epochs=2),
    mcmc=tcfg.MCMCConfig(noise_sigma=1e-2),
)


@pytest.fixture(scope="module")
def fins():
    return (JFin.create(resolution=1, dtype=jnp.float64, cg_tol=1e-12, cg_maxiter=4000),
            FiveParamFin.create(resolution=1, dtype=F64, device="cpu", cg_tol=1e-12, cg_maxiter=4000))




def test_device_projection_and_residual_equal_reference(fins):
    jfin, tfin = fins
    V, _ = pod_basis_host(tfin.solve_batch(torch.tensor(KS[:24])), 10)
    rt = ReducedOperator.project(tfin.op, torch.tensor(V))
    rj = JROM.project(jfin.op, jnp.asarray(V))
    rh = ReducedOperator.project_host(tfin.host, 0.1, V, dtype=F64, device="cpu")
    for f in ("Ahat", "Mhat", "Fhat", "Bhat"):
        a = getattr(rt, f).numpy()
        np.testing.assert_allclose(a, np.asarray(getattr(rj, f)), rtol=1e-12, atol=1e-12, err_msg=f)
        np.testing.assert_allclose(a, getattr(rh, f).numpy(), rtol=1e-12, atol=1e-12, err_msg=f)
    res_t = rt.residual_norm(tfin.op, torch.tensor(KS)).numpy()
    res_j = np.asarray(jax.vmap(lambda k: rj.residual_norm(jfin.op, k))(jnp.asarray(KS)))
    np.testing.assert_allclose(res_t, res_j, rtol=1e-10)
    # the indicator is small at a snapshot in the span and large far from it
    assert res_t[:24].max() < res_t[24:].max()


@pytest.fixture(scope="module")
def candidates(fins):
    """The greedy build's candidates (the first greedy_candidates of its
    snapshot draws) and JAX's greedy basis over them, r = 8."""
    jfin, _ = fins
    ks = api.sample_log_uniform(torch.Generator().manual_seed(GREEDY_CFG.rom.seed),
                                GREEDY_CFG.rom.n_snapshots, dtype=F64)[:GREEDY_CFG.rom.greedy_candidates]
    return ks, jg.greedy_basis(jfin.op, jnp.asarray(ks.numpy()), 8, tol=1e-12, maxiter=4000)


def test_greedy_basis_replays_reference(fins, candidates):
    _, tfin = fins
    ks, jr = candidates
    tr = tg.greedy_basis(tfin.op, ks, 8, tol=1e-12, maxiter=4000)
    np.testing.assert_array_equal(tr.selected, jr.selected)
    np.testing.assert_allclose(tr.indicators, jr.indicators, rtol=1e-8)
    np.testing.assert_allclose(tr.V.numpy(), np.asarray(jr.V), atol=1e-8)
    np.testing.assert_allclose(tr.snapshots, jr.snapshots, atol=1e-8 * np.abs(jr.snapshots).max())
    Vt, Vj = tg.orthonormalize_host(tr.snapshots), jg.orthonormalize_host(jr.snapshots)
    np.testing.assert_allclose(Vt, Vj, atol=1e-8)
    np.testing.assert_allclose(Vt.T @ Vt, np.eye(Vt.shape[1]), atol=1e-12)


def test_greedy_basis(fins):
    _, tfin = fins
    res = tg.greedy_basis(tfin.op, torch.tensor(KS), 16, tol=1e-12, maxiter=4000)
    V = res.V
    assert V.shape[1] == 16
    assert float((V.T @ V - torch.eye(16, dtype=F64)).abs().max()) < 1e-8
    assert res.indicators[-1] < res.indicators[1]
    rom = ReducedOperator.project(tfin.op, V)
    k_test = torch.exp(torch.empty(8, 5, dtype=F64).uniform_(np.log(0.1), np.log(10.0),
                                                             generator=torch.Generator().manual_seed(3)))
    y_fom = tfin.op.observe(tfin.solve_batch(k_test))
    rel = float(torch.linalg.norm(rom.forward(k_test) - y_fom) / torch.linalg.norm(y_fom))
    assert rel < 0.1
    # same order of accuracy as POD at equal r (host float64 projections)
    Vg = tg.orthonormalize_host(res.snapshots)
    Vp, _ = pod_basis_host(tfin.solve_batch(torch.tensor(KS)), 16)
    rel_of = lambda V: float(torch.linalg.norm(
        ReducedOperator.project_host(tfin.host, 0.1, V, dtype=F64, device="cpu").forward(k_test) - y_fom)
        / torch.linalg.norm(y_fom))
    e_g, e_p = rel_of(Vg), rel_of(Vp)
    assert e_g < 3 * e_p and e_g < 3e-2, (e_g, e_p)


def test_build_pipeline_greedy_equals_host_qr_of_reference_basis(candidates):
    _, jr = candidates
    log = MetricsLogger()
    pipe = api.build_pipeline(GREEDY_CFG, device="cpu", dtype=F64, metrics=log)
    assert log.summary()["rom_built"]["method"] == "greedy" and pipe.rom.r == 8
    np.testing.assert_allclose(pipe.rom.V.numpy(), jg.orthonormalize_host(jr.snapshots), atol=1e-8)
    with pytest.raises(ValueError, match="'pod' or 'greedy'"):
        api.build_pipeline(tcfg.PipelineConfig(mesh=tcfg.MeshConfig(resolution=1),
                                               rom=tcfg.ROMConfig(method="svd")), device="cpu")


def test_cli_rom_greedy_beside_reference(capsys, tmp_path):
    argv = ["rom", "--resolution", "1", "--n-snapshots", "64", "--r", "8", "--method", "greedy"]
    jcli.main(argv + ["--out", str(tmp_path / "j.npz")])
    j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tcli.main(argv + ["--device", "cpu", "--out", str(tmp_path / "t.npz")])
    t = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(t) == set(j) and (t["r"], t["method"]) == (8, "greedy")
    assert 0 < t["rel_err_vs_fom"] < 0.1, (t, j)
    with np.load(tmp_path / "j.npz") as jz, np.load(tmp_path / "t.npz") as tz:
        assert tz["V"].shape == jz["V"].shape
        np.testing.assert_allclose(tz["V"].T @ tz["V"], np.eye(8), atol=1e-10)
