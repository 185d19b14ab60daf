"""Posterior prediction in the port (utils/predict.py, api.predict_temperature,
invert --predict-at / --predict-out, utils/ppc.posterior_predictive)
against the JAX reference.

1. interp_rows and predict_field equal JAX's to 1e-12 on the same points and
   draws (every statistic, the point draws and the new-reading sd), and the
   reference's oracles: P1 interpolation exact for linear fields, points
   outside the fin refused, the quadrature rule of the predictive sd.
2. predict_temperature on a converted float64 res1 pipeline: one batched
   solve through make_fom_solver; a degenerate posterior at theta_true
   gives JAX's own prediction of it to 1e-9 (the field, its mean and the
   P1 point values) with a zero spread; a point on a mesh node predicts
   that node's value.
3. posterior_predictive on JAX's noise equals JAX's (y_model, y_rep), and
   ppc_chi2_pvalue is built on it.
4. invert --sensors --predict-at --predict-out beside the reference CLI's
   keys."""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import _arrays, _cfg, cached_build_pipeline, jax_build

from bayesianinferencedl_tpu import config as jcfg
from bayesianinferencedl_tpu.api import predict_temperature as j_predict
from bayesianinferencedl_tpu.geometry.mesh import build_fin_mesh as j_mesh
from bayesianinferencedl_tpu.utils import ppc as jppc
from bayesianinferencedl_tpu.utils import predict as jpred
from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch import cli as tcli
from bayesianinferencedl_tpu_torch.convert import pipeline_from_arrays
from bayesianinferencedl_tpu_torch.geometry.mesh import build_fin_mesh
from bayesianinferencedl_tpu_torch.infer.oed import boundary_candidates, solution_indices
from bayesianinferencedl_tpu_torch.utils import ppc as tppc
from bayesianinferencedl_tpu_torch.utils import predict as tpred

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

F64 = torch.float64
PTS = np.array([[0.13, 2.41], [-2.2, 0.85], [0.0, 0.0], [0.25, 3.875], [-3.0, 2.0]])
TIGHT = dict(rtol=1e-12, atol=1e-14)


def test_interp_rows_equal_reference_and_exact_for_linear():
    mesh, jm = build_fin_mesh(2), j_mesh(2)
    ids, w = tpred.interp_rows(mesh, PTS)
    jids, jw = jpred.interp_rows(jm, PTS)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(w, jw, **TIGHT)
    a, b, c = 0.7, -0.3, 0.45
    field = a + b * mesh.nodes[:, 0] + c * mesh.nodes[:, 1]
    np.testing.assert_allclose((field[ids] * w).sum(1), a + b * PTS[:, 0] + c * PTS[:, 1], rtol=1e-12)
    np.testing.assert_allclose(w.sum(1), 1.0, rtol=1e-12)
    for bad in ([[0.0, 4.5]], [[2.0, 1.5]]):  # above the fin; between subfins
        with pytest.raises(ValueError, match="outside"):
            tpred.interp_rows(mesh, np.array(bad))


@pytest.mark.parametrize("noise", [None, 0.2])
def test_predict_field_equals_reference(noise):
    mesh = build_fin_mesh(1)
    n = mesh.n_nodes
    draws = 1.0 + 0.1 * np.random.default_rng(0).standard_normal((512, n + 7))
    idx = np.random.default_rng(1).permutation(n + 7)[:n]
    t = tpred.predict_field(torch.tensor(draws), idx, mesh, points=PTS[:3], noise_sigma=noise)
    j = jpred.predict_field(draws, idx, j_mesh(1), points=PTS[:3], noise_sigma=noise)
    for f in ("node_xy", "mean", "std", "q05", "q50", "q95", "points", "point_mean", "point_std",
              "point_q05", "point_q50", "point_q95", "point_draws", "point_pred_std"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(a, b, **TIGHT, err_msg=f)
    assert t.n_draws == j.n_draws == 512 and t.summary_rows() == j.summary_rows()
    if noise is not None:
        np.testing.assert_allclose(t.point_pred_std, np.sqrt(t.point_std**2 + noise**2), rtol=1e-12)
        assert all("pred_sd" in r for r in t.summary_rows())
    np.testing.assert_allclose(t.mean, 1.0, atol=0.02)
    assert np.all(t.q05 < t.q50) and np.all(t.q50 < t.q95)
    assert tpred.predict_field(draws, idx, mesh).summary_rows() == []


@pytest.fixture(scope="module")
def pipes():
    jpipe = jax_build(_cfg(1e-10, jcfg), jnp.float64)
    return jpipe, pipeline_from_arrays(_cfg(1e-10), _arrays(jpipe), device="cpu", dtype=F64)


def test_predict_temperature_degenerate_posterior_equals_reference(pipes, monkeypatch, tmp_path):
    jpipe, tpipe = pipes
    theta_true = np.log([1.3, 0.7, 2.0, 0.5, 1.0])
    samples = np.broadcast_to(theta_true, (8, 4, 5)).copy()
    node = 37
    pts = np.vstack([PTS[:2], tpipe.fin.mesh.nodes[node][None]])
    calls = []
    solver = api.make_fom_solver

    def counted(fin, **kw):
        solve = solver(fin, **kw)
        return lambda ks, **k2: calls.append(ks.shape) or solve(ks, **k2)

    monkeypatch.setattr(api, "make_fom_solver", counted)
    t = api.predict_temperature(tpipe, torch.tensor(samples), points=pts, n_draws=16, noise_sigma=1e-2)
    j = j_predict(jpipe, jnp.asarray(samples), points=pts, n_draws=16, noise_sigma=1e-2)
    assert calls == [(16, 5)]  # one batched solve of the thinned draws
    assert t.n_draws == j.n_draws == 16
    for f in ("mean", "q50", "point_mean", "point_q50"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=1e-9, err_msg=f)
    assert t.std.max() < 1e-12 and t.point_std.max() < 1e-12
    u = tpipe.fin.solve_batch(torch.exp(torch.tensor(theta_true))[None])[0].numpy()
    np.testing.assert_allclose(t.point_mean[-1], u[solution_indices(tpipe.fin)[node]], rtol=1e-12)
    flat = api.predict_temperature(tpipe, torch.tensor(samples.reshape(-1, 5)), n_draws=16)
    np.testing.assert_array_equal(flat.mean, t.mean)
    t.save_npz(tmp_path / "p.npz")
    with np.load(tmp_path / "p.npz") as z:
        np.testing.assert_array_equal(z["point_mean"], t.point_mean)


def test_posterior_predictive_equals_reference(pipes):
    jpipe, tpipe = pipes
    samples = np.random.default_rng(2).normal(0.0, 0.6, (6, 5, 5))
    key = jax.random.PRNGKey(4)
    fj = jpipe.batched_forward_fn("rom_nn")
    ymj, yrj = jppc.posterior_predictive(fj, jnp.asarray(samples), 1e-2, key, n_draws=16)
    noise = torch.tensor(np.asarray(jax.random.normal(key, ymj.shape, jnp.float64)))
    ymt, yrt = tppc.posterior_predictive(tpipe.batched_forward_fn("rom_nn"), torch.tensor(samples), 1e-2,
                                         n_draws=16, noise=noise)
    np.testing.assert_allclose(ymt.numpy(), np.asarray(ymj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(yrt.numpy(), np.asarray(yrj), rtol=1e-10, atol=1e-12)
    # the chi-square check draws its replicates through it
    data = ymt[0] + 0.01
    g = lambda: torch.Generator().manual_seed(3)
    ym, yr = tppc.posterior_predictive(tpipe.batched_forward_fn("rom_nn"), torch.tensor(samples), 1e-2, g(),
                                       n_draws=16)
    p = tppc.ppc_chi2_pvalue(tpipe.batched_forward_fn("rom_nn"), torch.tensor(samples), data, 1e-2, g(),
                             n_draws=16)
    t_obs = ((data - ym) ** 2).sum(-1) / 1e-4
    t_rep = ((yr - ym) ** 2).sum(-1) / 1e-4
    assert p["p_value"] == float((t_rep >= t_obs).float().mean())


def test_cli_invert_predict_and_sensors_beside_reference(capsys, monkeypatch, tmp_path):
    """invert --predict-at / --predict-out on three pointwise sensors
    (--sensors, a design file with the keys `design --out` writes), both
    CLIs on one argv."""
    from bayesianinferencedl_tpu import cli as jcli

    design = tmp_path / "design.npz"
    node_ids = boundary_candidates(SimpleNamespace(mesh=build_fin_mesh(1)))[[0, 40, 80]]
    np.savez(design, node_ids=node_ids, xy=build_fin_mesh(1).nodes[node_ids], eig_trace=np.zeros(3),
             gains=np.zeros(3), noise_sigma=1e-2, resolution=1)
    argv = ["invert", "--resolution", "1", "--n-snapshots", "32", "--r", "8", "--n-train", "64", "--epochs",
            "5", "--chains", "8", "--steps", "24", "--burn", "12", "--noise", "1e-2", "--sensors", str(design),
            "--predict-at", "0.1,2.3", "--predict-at=-2.5,0.875"]
    jcli.main(argv + ["--predict-out", str(tmp_path / "j.npz")])
    j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tcli.main(argv + ["--device", "cpu", "--predict-out", str(tmp_path / "t.npz")])
    t = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(t) == set(j) and len(t["predictions"]) == 2
    for row, jrow in zip(t["predictions"], j["predictions"]):
        assert set(row) == set(jrow) and (row["x"], row["y"]) == (jrow["x"], jrow["y"])
        assert row["q05"] <= row["mean"] <= row["q95"] and row["sd"] > 0
        assert row["pred_sd"] >= max(row["sd"], 1e-2)
    with np.load(tmp_path / "j.npz") as jz, np.load(tmp_path / "t.npz") as tz:
        assert sorted(tz.files) == sorted(jz.files) and tz["mean"].shape == jz["mean"].shape
    monkeypatch.setattr(api, "build_pipeline", cached_build_pipeline)
    with pytest.raises(ValueError, match="outside"):
        tcli.main(argv[:-5] + ["--device", "cpu", "--predict-at", "2.0,1.5"])
