"""Optimal sensor design in the port (infer/oed.py) against the JAX reference,
in float64 at res1.

1. pointwise_sensitivities (5 tangent solves a draw) within 1e-8 of JAX's
   jacrev through its implicit-diff solve, under the Gaussian prior and a
   log-uniform box prior's to_theta; solution_indices and the boundary
   candidates equal.
2. greedy_eig's picks equal and its trace and gains within 1e-10 of JAX's,
   on random sensitivities and on the fin's; eig_of_subset likewise; the
   reference's cases (the first pick optimal, the greedy set within the
   (1 - 1/e) guarantee of brute force, the trace equal to the exact EIG of
   the picked multiset, the design beating random subsets, the designed
   sensors contracting a pCN posterior more than clustered ones).
3. with_sensor_qoi replaces both qoi arrays as JAX's does, and
   build_pipeline(fin=...) and convert.pipeline_from_arrays(..., fin=...)
   carry the sensors' observables through the build and run_inversion.
4. The design command beside the reference CLI, and invert --sensors
   reading the reference's design file (the run: test_torch_predict.py)."""

import itertools
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu import cli as jcli
from bayesianinferencedl_tpu.infer import GaussianPrior as JPrior
from bayesianinferencedl_tpu.infer import oed as joed
from bayesianinferencedl_tpu.infer.priors import BoxPrior as JBox
from bayesianinferencedl_tpu.models.five_param import FiveParamFin as JFin
from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch import cli as tcli
from bayesianinferencedl_tpu_torch import config as tcfg
from bayesianinferencedl_tpu_torch.infer import oed as toed
from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit, run_pcn
from bayesianinferencedl_tpu_torch.infer.priors import BoxPrior as TBox
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior
from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
from bayesianinferencedl_tpu_torch.rom.galerkin import ReducedOperator
from bayesianinferencedl_tpu_torch.rom.pod import pod_basis_host
from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

F64 = torch.float64
SIGMA_N = 1e-2


@pytest.fixture(scope="module")
def fins():
    return (JFin.create(resolution=1, dtype=jnp.float64, cg_tol=1e-11),
            FiveParamFin.create(resolution=1, dtype=F64, device="cpu", cg_tol=1e-11))


@pytest.fixture(scope="module")
def design(fins):
    """The port's 6-sensor design at res1 on 8 prior draws, with its J."""
    _, tfin = fins
    prior = TPrior.iid(5, sigma=0.6, dtype=F64, device="cpu")
    d = toed.design_sensors(tfin, prior, n_sensors=6, noise_sigma=SIGMA_N, n_draws=8,
                            gen=torch.Generator().manual_seed(0), tol=1e-11)
    xs = prior.sample(torch.Generator().manual_seed(0), (8,))
    J = toed.pointwise_sensitivities(tfin, xs, d.candidates, to_theta=prior.to_theta, tol=1e-11)
    return prior, d, J


@pytest.mark.parametrize("kind", ["gaussian", "log_uniform"])
def test_pointwise_sensitivities_match_reference_jacrev(fins, kind):
    jfin, tfin = fins
    if kind == "gaussian":
        jp, tp = (JPrior.iid(5, sigma=0.6, dtype=jnp.float64),
                  TPrior.iid(5, sigma=0.6, dtype=F64, device="cpu"))
    else:
        jp = JBox.create(5, low=0.1, high=10.0, kind=kind, dtype=jnp.float64)
        tp = TBox.create(5, low=0.1, high=10.0, kind=kind, dtype=F64, device="cpu")
    xs = np.random.default_rng(4).normal(0.0, 0.6, (4, 5))
    cand = joed.boundary_candidates(jfin)
    np.testing.assert_array_equal(toed.boundary_candidates(tfin), cand)
    np.testing.assert_array_equal(toed.solution_indices(tfin), joed.solution_indices(jfin))
    node_ids = cand[::7]
    Jj = np.asarray(joed.pointwise_sensitivities(jfin, jnp.asarray(xs), node_ids, to_theta=jp.to_theta,
                                                 tol=1e-12, maxiter=4000))
    Jt = toed.pointwise_sensitivities(tfin, torch.tensor(xs), node_ids, to_theta=tp.to_theta, tol=1e-12,
                                      maxiter=4000).numpy()
    assert Jt.shape == Jj.shape == (4, len(node_ids), 5)
    np.testing.assert_allclose(Jt, Jj, rtol=1e-8, atol=1e-8 * np.abs(Jj).max())


def _rand_J(B=4, n=8, d=3, seed=0):
    return np.random.default_rng(seed).standard_normal((B, n, d))


@pytest.mark.parametrize("chol", [False, True])
def test_greedy_eig_and_subset_eig_equal_reference(chol):
    J = _rand_J(B=5, n=12, d=4, seed=1)
    L = np.tril(np.random.default_rng(2).normal(size=(4, 4))) + 2 * np.eye(4) if chol else None
    pj, trj, gj = joed.greedy_eig(jnp.asarray(J), 0.4, 5, prior_chol=None if L is None else jnp.asarray(L))
    pt, trt, gt = toed.greedy_eig(torch.tensor(J), 0.4, 5, prior_chol=None if L is None else torch.tensor(L))
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_allclose(trt, trj, rtol=1e-10)
    np.testing.assert_allclose(gt, gj, rtol=1e-10)
    sub = [0, 3, 3, 7]
    kw = lambda t: {} if L is None else {"prior_chol": t(L)}
    assert np.isclose(toed.eig_of_subset(torch.tensor(J), sub, 0.4, **kw(torch.tensor)),
                      joed.eig_of_subset(jnp.asarray(J), sub, 0.4, **kw(jnp.asarray)), rtol=1e-10)


def test_greedy_first_pick_is_optimal_and_near_optimal_overall():
    J = torch.tensor(_rand_J())
    sigma = 0.5
    _, trace, _ = toed.greedy_eig(J, sigma, 3)
    singles = [toed.eig_of_subset(J, [s], sigma) for s in range(J.shape[1])]
    assert np.isclose(trace[0], max(singles), rtol=1e-10)
    best3 = max(toed.eig_of_subset(J, list(S), sigma) for S in itertools.combinations(range(J.shape[1]), 3))
    assert (1 - 1 / np.e) * best3 <= trace[-1] <= best3 + 1e-9


def test_greedy_trace_equals_exact_subset_eig():
    J = torch.tensor(_rand_J(B=3, n=6, d=4, seed=2))
    picked, trace, gains = toed.greedy_eig(J, 0.3, 4)
    Jrep = J[:, torch.as_tensor(picked), :]
    assert np.isclose(trace[-1], toed.eig_of_subset(Jrep, np.arange(len(picked)), 0.3), rtol=1e-9)
    assert np.all(np.diff(trace) > 0)
    assert np.all(np.diff(gains) <= 1e-12)  # submodularity: the gains shrink


def test_fin_design_picks_equal_reference_on_the_same_sensitivities(fins, design):
    """The fin and its conductivity field are mirror-symmetric in x, so a
    node and its mirror tie exactly but for rounding, which argmax breaks
    either way on either side: the picks are compared as mirror pairs, the
    trace exactly."""
    jfin, _ = fins
    prior, d, J = design
    jprior = JPrior.iid(5, sigma=0.6, dtype=jnp.float64)
    pj, trj, gj = joed.greedy_eig(jnp.asarray(J.numpy()), SIGMA_N, 6, prior_chol=jprior.chol)
    pt, trt, _ = toed.greedy_eig(J, SIGMA_N, 6, prior_chol=prior.chol)
    pair = lambda p: [tuple(np.abs(xy)) for xy in np.asarray(jfin.mesh.nodes)[d.candidates[p]]]
    assert pair(pt) == pair(pj)
    np.testing.assert_allclose(trt, trj, rtol=1e-10)
    np.testing.assert_array_equal(d.node_ids, d.candidates[pt])
    np.testing.assert_allclose(d.eig_trace, trt, rtol=1e-12)
    np.testing.assert_array_equal(d.xy, np.asarray(jfin.mesh.nodes)[d.node_ids])


def test_design_on_fin_beats_random_subsets(design):
    prior, d, J = design
    assert np.all(np.diff(d.eig_trace) > 0) and d.xy.shape == (6, 2)
    rng = np.random.default_rng(3)
    eig_rand = [toed.eig_of_subset(J, rng.choice(len(d.candidates), 6, replace=False), SIGMA_N,
                                   prior_chol=prior.chol) for _ in range(20)]
    assert d.eig_trace[-1] > max(eig_rand), (d.eig_trace[-1], max(eig_rand))
    assert d.eig_trace[-1] > 1.1 * np.mean(eig_rand)


def test_designed_sensors_tighten_the_actual_posterior(fins, design):
    """pCN on the designed pointwise-sensor likelihood contracts the
    posterior more than on the 6 candidates clustered around the first. The
    sensors read the lifted solution of a POD-Galerkin model of the res1 FOM
    (r = 24, host float64 projection, its field within 1e-4 of the FOM's
    at the truth): a batched FOM solve in each of the 2 x 1,200 steps would
    take minutes on the CPU."""
    _, tfin = fins
    prior, d, _ = design
    cand = d.candidates
    xy = np.asarray(tfin.mesh.nodes[cand])
    clustered = cand[np.argsort(np.linalg.norm(xy - xy[0], axis=1))[:6]]
    sol_idx = toed.solution_indices(tfin)
    theta_true = prior.sample(torch.Generator().manual_seed(9))
    noise = torch.randn(6, generator=torch.Generator().manual_seed(10), dtype=F64)
    ks = torch.exp(0.6 * torch.randn(96, 5, generator=torch.Generator().manual_seed(11), dtype=F64))
    V, _ = pod_basis_host(tfin.solve_batch(ks), 24)
    rom = ReducedOperator.project_host(tfin.host, 0.1, V, dtype=F64, device="cpu")
    k_chk = torch.exp(theta_true[None])
    assert float((rom.lift(rom.solve(k_chk)) - tfin.solve_batch(k_chk)).abs().max()) < 1e-4

    def posterior_var(node_ids, seed):
        Vs = rom.V[torch.as_tensor(sol_idx[np.asarray(node_ids)])]  # (6, r)
        fwd = lambda th: rom.solve(torch.exp(th)) @ Vs.T
        data = fwd(theta_true[None])[0] + SIGMA_N * noise
        theta0 = prior.sample(torch.Generator().manual_seed(1), (64,))
        res = run_pcn(gaussian_misfit(fwd, data, SIGMA_N), prior, theta0, torch.Generator().manual_seed(seed),
                      n_steps=1200, n_burn=400, beta=0.25)
        return float(res.samples.reshape(-1, 5).var(0).sum())

    v_design, v_cluster = posterior_var(d.node_ids, 2), posterior_var(clustered, 3)
    assert v_design < v_cluster, (v_design, v_cluster)


def test_with_sensor_qoi_through_the_pipeline(fins, design):
    jfin, tfin = fins
    _, d, _ = design
    jf, tf = joed.with_sensor_qoi(jfin, d.node_ids), toed.with_sensor_qoi(tfin, d.node_ids)
    assert tf.op.n_obs == jf.op.n_obs == 6
    np.testing.assert_array_equal(tf.op.qoi.numpy(), np.asarray(jf.op.qoi))
    np.testing.assert_array_equal(tf.host.qoi, jf.host.qoi)
    assert tf.op.qoi.dtype == F64 and tfin.op.n_obs == 5  # the original fin untouched
    cfg = tcfg.PipelineConfig(
        mesh=tcfg.MeshConfig(resolution=1), fem=tcfg.FEMConfig(cg_tol=1e-11, cg_maxiter=2000),
        rom=tcfg.ROMConfig(n_snapshots=32, basis_size=12),
        surrogate=tcfg.SurrogateConfig(hidden=(16, 16), n_train=64, epochs=20),
        mcmc=tcfg.MCMCConfig(n_chains=16, n_steps=60, n_burn=20, noise_sigma=SIGMA_N),
    )
    pipe = api.build_pipeline(cfg, device="cpu", dtype=F64, fin=tf)
    assert pipe.fin is tf and pipe.dataset.y_fom.shape[-1] == 6 and pipe.rom.Bhat.shape[0] == 6
    inv = api.run_inversion(pipe)
    assert inv.data.shape == (6,) and torch.isfinite(inv.result.samples).all()
    # the reduced QoI of the pipeline is the sensors' values of the lifted solution
    u = pipe.fin.solve_batch(torch.ones(1, 5, dtype=F64))
    np.testing.assert_allclose(pipe.fin.op.observe(u)[0].numpy(),
                               u[0, toed.solution_indices(tfin)[d.node_ids]].numpy(), rtol=1e-14)
    # carried into a converted pipeline too
    from bayesianinferencedl_tpu_torch.convert import pipeline_from_arrays

    arrays = {f: getattr(pipe.rom, f).numpy() for f in ("Ahat", "Mhat", "Fhat", "Bhat", "V")}
    arrays.update({f"W{i}": W.detach().numpy() for i, (W, _) in enumerate(pipe.surrogate.params)})
    arrays.update({f"b{i}": b.detach().numpy() for i, (_, b) in enumerate(pipe.surrogate.params)})
    arrays.update({f: getattr(pipe.surrogate.norm, f).numpy() for f in ("x_mean", "x_std", "y_mean", "y_std")})
    arrays.update(P0=pipe.P0.numpy(), rom_pcg_iters=pipe.rom_pcg_iters)
    conv = pipeline_from_arrays(cfg, arrays, device="cpu", dtype=F64, fin=tf)
    th = torch.zeros(3, 5, dtype=F64)
    np.testing.assert_array_equal(conv.batched_forward_fn("fom")(th).numpy(),
                                  pipe.batched_forward_fn("fom")(th).numpy())


def _run(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_design_and_invert_sensors_beside_reference(capsys, tmp_path):
    argv = ["design", "--resolution", "1", "--sensors", "3", "--draws", "4", "--dtype", "float64"]
    j = _run(jcli.main, argv + ["--out", str(tmp_path / "j.npz")], capsys)
    t = _run(tcli.main, argv + ["--device", "cpu", "--out", str(tmp_path / "t.npz")], capsys)
    assert set(t) == set(j) and t["n_candidates"] == j["n_candidates"]
    assert len(t["node_ids"]) == len(t["eig_trace_nats"]) == 3 and np.all(np.diff(t["eig_trace_nats"]) > 0)
    with np.load(tmp_path / "j.npz") as jz, np.load(tmp_path / "t.npz") as tz:
        assert sorted(tz.files) == sorted(jz.files) and int(tz["resolution"]) == 1
    # invert --sensors reads either package's design file (the run itself:
    # test_torch_predict.py, beside the reference CLI)
    args = SimpleNamespace(sensors=str(tmp_path / "j.npz"), resolution=1, biot=0.1, dtype="float64",
                           device="cpu")
    cfg = SimpleNamespace(fem=SimpleNamespace(cg_tol=1e-10, cg_maxiter=4000))
    fin = tcli._sensor_fin(args, cfg, MetricsLogger())
    np.testing.assert_array_equal(fin.op.qoi.numpy()[:, toed.solution_indices(fin)[j["node_ids"]]], np.eye(3))
    with pytest.raises(SystemExit, match="resolution"):
        tcli._sensor_fin(SimpleNamespace(**{**vars(args), "resolution": 2}), cfg, MetricsLogger())
