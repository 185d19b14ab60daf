"""The normalizing flow in the port (infer/flow.py) against the JAX reference,
in float64, on flows carried across by convert.flow_from_arrays. Every flow
compared has non-zero coupling layers (an identity flow hides every coupling
bug): the reference's identity init, then every leaf perturbed.

1. CouplingFlow.forward and .inverse with their log-determinants over two
   leading batch dims (4 couplings, hidden 8, d = 5), the port's round trip,
   the identity init (the reference's tests/test_flow.py:71) and the dim < 2
   refusal.
2. flow_sample's theta and log q at base_scale 1 and 1.5 in a non-trivial
   frame, on JAX's base draws.
3. Replays on JAX's draws (fold_in per step; split for the minibatch rows
   and the jitter), regenerated here and injected: run_flow_vi over 20
   steps with and without the tempering ramp; fit_flow_mle over 20 steps
   with and without weights on a population of duplicated rows (the
   unique-row bandwidth) and with jitter=0. The trained leaves, the trace
   and the moment summary to 1e-10.
4. neutra_misfit against JAX's, and its identity reduction (the reference's
   :230, atol 1e-10); run_neutra_pcn over 20 steps on injected Z0, normals
   and uniforms; flow_psis_certify on injected base draws.
5. flow_fit_pipeline: the composition on JAX's draws (pretrain="none"),
   the SMC route as its three pieces (SMC, MLE, refinement) on a tiny
   population, its defaults, its RuntimeError at max_stages and its
   ValueError for an unknown pretrain."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.infer import flow as jf
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu_torch.convert import flow_from_arrays
from bayesianinferencedl_tpu_torch.infer import flow as tf
from bayesianinferencedl_tpu_torch.infer import smc as tsm
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D, NC, HID = 5, 4, 8
N_DRAW = 256  # every batch of base draws: JAX compiles each eager op once for it
TOL = dict(rtol=1e-10, atol=1e-10)


def _jax_flow(seed=0, scale=0.3, d=D, nc=NC, hidden=HID):
    """A flow off the identity: the reference's architecture with every leaf
    drawn (NumPy, scale * N(0, 1); the reference's init would zero the
    couplings' last layers)."""
    flow = jf.CouplingFlow(dim=d, n_couplings=nc, hidden=hidden)
    rng = np.random.default_rng(seed)
    leaf = lambda *shape: jnp.asarray(scale * rng.standard_normal(shape))
    couplings = []
    for layer in range(nc):
        sizes = flow._mlp(layer).sizes
        couplings.append([(leaf(a, b), leaf(b)) for a, b in zip(sizes[:-1], sizes[1:])])
    return flow, {"mu": leaf(d), "raw": leaf(d, d), "couplings": couplings}


def _arrays(p):
    return {"mu": np.asarray(p["mu"]), "raw": np.asarray(p["raw"]),
            "couplings": [[(np.asarray(W), np.asarray(b)) for W, b in c] for c in p["couplings"]]}


def _port(p, ref=None):
    return flow_from_arrays(_arrays(p), ref=ref, device="cpu", dtype=torch.float64)


def _same_leaves(flow, p):
    jl = [p["mu"], p["raw"]] + [x for c in p["couplings"] for W, b in c for x in (W, b)]
    assert len(flow.params()) == len(jl)
    for i, (a, b) in enumerate(zip(flow.params(), jl)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=f"leaf {i}", **TOL)


@functools.lru_cache(maxsize=None)
def _linear_gaussian(d=D, sigma=0.5, seed=0):
    """tests/test_flow.py's problem: both batched misfits, both priors, the
    exact posterior mean and covariance (one set of objects per problem, so
    that JAX's compiled programs are reused across the tests)."""
    rng = np.random.default_rng(seed)
    A, data = rng.standard_normal((d, d)), rng.standard_normal(d)
    Cpost = np.linalg.inv(A.T @ A / sigma**2 + np.eye(d))
    mu = Cpost @ (A.T @ data) / sigma**2
    Aj, dj, At, dt = jnp.asarray(A), jnp.asarray(data), torch.tensor(A), torch.tensor(data)
    jm = lambda th: 0.5 / sigma**2 * jnp.sum((th @ Aj.T - dj) ** 2, axis=-1)
    tm = lambda th: 0.5 / sigma**2 * torch.sum((th @ At.T - dt) ** 2, dim=-1)
    return (jm, tm, JPrior.iid(d, sigma=1.0, dtype=jnp.float64),
            TPrior.iid(d, sigma=1.0, dtype=torch.float64, device="cpu"), mu, Cpost)


def _frame(seed=3, d=D):
    """A non-trivial (mean, chol) frame, numpy."""
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 0.4, d), np.tril(0.2 * rng.standard_normal((d, d)), -1) + np.diag(
        rng.uniform(0.5, 1.5, d))


def _jres(flow, p, frame):
    m, L = (jnp.asarray(x) for x in frame)
    return jf.FlowVIResult(flow=flow, params=p, ref_mean=m, ref_chol=L, elbo_trace=jnp.zeros(1),
                           theta_mean=m, theta_cov=jnp.eye(D, dtype=jnp.float64), n_forward=0)


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float64))


def test_forward_inverse_and_logdets_match_reference():
    flow, p = _jax_flow()
    tflow = _port(p)
    Z = _normal(jax.random.PRNGKey(1), (3, 7, D))
    Yj, ldj = jax.jit(flow.forward)(p, jnp.asarray(Z))
    Yt, ldt = tflow(torch.tensor(Z))
    assert float(jnp.std(Yj - Z)) > 0.05  # the flow moves its points
    np.testing.assert_allclose(Yt.detach().numpy(), np.asarray(Yj), **TOL)
    np.testing.assert_allclose(ldt.detach().numpy(), np.asarray(ldj), **TOL)
    Zj, lij = jax.jit(flow.inverse)(p, Yj)
    Zt, lit = tflow.inverse(torch.tensor(np.asarray(Yj)))
    np.testing.assert_allclose(Zt.detach().numpy(), np.asarray(Zj), **TOL)
    np.testing.assert_allclose(lit.detach().numpy(), np.asarray(lij), **TOL)
    # the port's own round trip: the point and the log-determinant
    Z2, ld2 = tflow.inverse(Yt)
    np.testing.assert_allclose(Z2.detach().numpy(), Z, atol=1e-10)
    np.testing.assert_allclose(ld2.detach().numpy(), ldt.detach().numpy(), atol=1e-10)


def test_identity_init_round_trip_and_refusals():
    """The reference's tests/test_flow.py:71 on the port's own init: the
    identity, then every leaf perturbed and the round trip exact."""
    g = torch.Generator().manual_seed(0)
    flow = tf.CouplingFlow(4, 4, 16, generator=g, dtype=torch.float64, device="cpu")
    Z = torch.randn((64, 4), generator=g, dtype=torch.float64)
    Y, logdet = flow(Z)
    np.testing.assert_allclose(Y.detach().numpy(), Z.numpy(), atol=1e-14)
    np.testing.assert_allclose(logdet.detach().numpy(), 0.0, atol=1e-14)
    with torch.no_grad():
        for leaf in flow.params():
            leaf.add_(0.3 * torch.randn(leaf.shape, generator=g, dtype=leaf.dtype))
    Y, ld_f = flow(Z)
    assert float(torch.std(Y - Z)) > 0.01
    Z2, ld_i = flow.inverse(Y)
    np.testing.assert_allclose(Z2.detach().numpy(), Z.numpy(), atol=1e-10)
    np.testing.assert_allclose(ld_i.detach().numpy(), ld_f.detach().numpy(), atol=1e-10)
    with pytest.raises(ValueError, match="coupling layers need dim >= 2"):
        tf.CouplingFlow(1, 2, dtype=torch.float64, device="cpu")
    assert tf.CouplingFlow(1, 0, dtype=torch.float64, device="cpu").n_couplings == 0
    if not torch.cuda.is_available():  # the card by default, and no fallback
        with pytest.raises(RuntimeError, match="is_available"):
            tf.CouplingFlow(2)


@pytest.mark.parametrize("base_scale", [1.0, 1.5])
def test_flow_sample_and_log_q_match_reference(base_scale):
    flow, p = _jax_flow(seed=1)
    frame = _frame()
    jres, tres = _jres(flow, p, frame), _port(p, ref=frame)
    key = jax.random.PRNGKey(5)
    thj, lqj = jf.flow_sample(jres, key, (N_DRAW,), with_logq=True, base_scale=base_scale)
    Z = torch.tensor(base_scale * _normal(key, (N_DRAW, D)))
    tht, lqt = tf.flow_sample(tres, shape=(N_DRAW,), with_logq=True, base_scale=base_scale, Z=Z)
    np.testing.assert_allclose(tht.numpy(), np.asarray(thj), **TOL)
    np.testing.assert_allclose(lqt.numpy(), np.asarray(lqj), **TOL)
    np.testing.assert_allclose(tf.flow_sample(tres, Z=Z).numpy(), np.asarray(thj), **TOL)


@pytest.mark.parametrize("anneal", [0, 8])
def test_run_flow_vi_replays_reference(anneal):
    jm, tm, jprior, tprior, _, _ = _linear_gaussian()
    flow, p = _jax_flow(seed=2, scale=0.2)
    frame = _frame(seed=4)
    n_steps, n_mc, n_sum = 20, 16, N_DRAW
    kw = dict(n_couplings=NC, hidden=HID, n_steps=n_steps, n_mc=n_mc, lr=0.01, anneal_steps=anneal,
              n_summary=n_sum)
    key = jax.random.PRNGKey(7)
    rj = jf.run_flow_vi(jm, jprior, key, batched=True, params=p,
                        ref=tuple(jnp.asarray(x) for x in frame), **kw)
    _, k_run, k_sum = jax.random.split(key, 3)
    eps = torch.tensor(np.stack([_normal(jax.random.fold_in(k_run, t), (n_mc, D)) for t in range(n_steps)]))
    rt = tf.run_flow_vi(tm, tprior, params=_port(p), ref=tuple(torch.tensor(x) for x in frame), eps=eps,
                        summary_Z=torch.tensor(_normal(k_sum, (n_sum, D))), **kw)
    _same_leaves(rt.flow, rj.params)
    for f in ("elbo_trace", "theta_mean", "theta_cov", "ref_mean", "ref_chol"):
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)), err_msg=f, **TOL)
    assert rt.n_forward == rj.n_forward == n_mc * n_steps
    with pytest.raises(ValueError, match="n_steps > 0"):
        tf.run_flow_vi(tm, tprior, n_steps=0)


def _mle_draws(key, w, n_steps, n_batch):
    """fit_flow_mle's draws: per step fold_in(k_run, t) split into the rows
    (choice by weight, with replacement) and the jitter normals."""
    _, k_run, k_sum = jax.random.split(key, 3)
    idx, eps = [], []
    for t in range(n_steps):
        k_idx, k_jit = jax.random.split(jax.random.fold_in(k_run, t))
        idx.append(np.asarray(jax.random.choice(k_idx, w.shape[0], (n_batch,), replace=True, p=w)))
        eps.append(_normal(k_jit, (n_batch, D)))
    return torch.tensor(np.stack(idx)), torch.tensor(np.stack(eps)), k_sum


@pytest.mark.parametrize("case", ["uniform", "weighted", "no_jitter"])
def test_fit_flow_mle_replays_reference(case):
    """A population of 24 unique rows tiled 4x: the bandwidth counts 24."""
    rng = np.random.default_rng(11)
    mean, sd = rng.normal(0, 0.5, D), rng.uniform(0.05, 0.5, D)
    pts = np.tile(mean + sd * rng.standard_normal((24, D)), (4, 1))
    weights = rng.uniform(0.5, 2.0, pts.shape[0]) if case == "weighted" else None
    jitter = 0.0 if case == "no_jitter" else None
    jprior = JPrior.iid(D, sigma=0.6, dtype=jnp.float64)
    tprior = TPrior.iid(D, sigma=0.6, dtype=torch.float64, device="cpu")
    flow, p = _jax_flow(seed=3, scale=0.2)
    n_steps, n_batch, n_sum = 20, 32, N_DRAW
    kw = dict(n_couplings=NC, hidden=HID, n_steps=n_steps, n_batch=n_batch, lr=0.01, jitter=jitter,
              n_summary=n_sum)
    key = jax.random.PRNGKey(8)
    rj = jf.fit_flow_mle(jnp.asarray(pts), jprior, key, params=p,
                         weights=None if weights is None else jnp.asarray(weights), **kw)
    w = (np.full(pts.shape[0], 1.0 / pts.shape[0]) if weights is None else weights / weights.sum())
    idx, eps, k_sum = _mle_draws(key, jnp.asarray(w), n_steps, n_batch)
    rt = tf.fit_flow_mle(torch.tensor(pts), tprior, params=_port(p), idx=idx, eps=eps,
                         weights=None if weights is None else torch.tensor(weights),
                         summary_Z=torch.tensor(_normal(k_sum, (n_sum, D))), **kw)
    _same_leaves(rt.flow, rj.params)
    for f in ("elbo_trace", "theta_mean", "theta_cov"):
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)), err_msg=f, **TOL)
    assert rt.n_forward == 0


def test_neutra_misfit_matches_reference_and_reduces_to_the_misfit():
    jm, tm, jprior, tprior, _, _ = _linear_gaussian()
    flow, p = _jax_flow(seed=4)
    frame = _frame(seed=5)
    mj, bj, toj = jf.neutra_misfit(_jres(flow, p, frame), jm, jprior, batched=True)
    mt, bt, tot = tf.neutra_misfit(_port(p, ref=frame), tm, tprior)
    Z = _normal(jax.random.PRNGKey(9), (N_DRAW, D))
    np.testing.assert_allclose(mt(torch.tensor(Z)).detach().numpy(), np.asarray(mj(jnp.asarray(Z))), **TOL)
    np.testing.assert_allclose(tot(torch.tensor(Z)).detach().numpy(), np.asarray(toj(jnp.asarray(Z))), **TOL)
    assert torch.equal(bt.chol, torch.eye(D, dtype=torch.float64)) and torch.equal(bt.mean, torch.zeros(D,
                                                                                                       dtype=torch.float64))
    # the reference's :230: with the identity flow in the prior frame the
    # NeuTra potential IS the misfit at the pushed point
    ident = tf.FlowVIResult(
        flow=tf.CouplingFlow(D, NC, HID, generator=torch.Generator().manual_seed(0), dtype=torch.float64,
                             device="cpu"),
        ref_mean=tprior.mean, ref_chol=tprior.chol, elbo_trace=torch.zeros(1), theta_mean=tprior.mean,
        theta_cov=torch.eye(D, dtype=torch.float64), n_forward=0)
    mz, _, to_theta = tf.neutra_misfit(ident, tm, tprior)
    Zt = torch.tensor(Z)
    np.testing.assert_allclose(mz(Zt).detach().numpy(), tm(to_theta(Zt)).detach().numpy(), atol=1e-10)


def test_run_neutra_pcn_replays_reference():
    jm, tm, jprior, tprior, _, _ = _linear_gaussian()
    flow, p = _jax_flow(seed=5, scale=0.15)
    frame = _frame(seed=6)
    C, n_steps, n_burn, thin = 8, 20, 8, 2
    key = jax.random.PRNGKey(10)
    rj = jf.run_neutra_pcn(_jres(flow, p, frame), jm, jprior, key, n_chains=C, n_steps=n_steps,
                           n_burn=n_burn, thin=thin, batched=True)
    k0, k_run = jax.random.split(key)
    k_burn, k_main = jax.random.split(k_run)
    keys = list(jax.random.split(k_burn, n_burn)) + list(jax.random.split(k_main, n_steps - n_burn))
    nrm, uni = [], []
    for k in keys:
        k_prop, k_acc = jax.random.split(k)
        nrm.append(_normal(k_prop, (C, D)))
        uni.append(np.asarray(jax.random.uniform(k_acc, (C,), jnp.float64)))
    rt = tf.run_neutra_pcn(_port(p, ref=frame), tm, tprior, n_chains=C, n_steps=n_steps, n_burn=n_burn,
                           thin=thin, Z0=torch.tensor(_normal(k0, (C, D))),
                           normals=torch.tensor(np.stack(nrm)), uniforms=torch.tensor(np.stack(uni)))
    assert rt.samples.shape == ((n_steps - n_burn) // thin, C, D)
    np.testing.assert_allclose(rt.samples.numpy(), np.asarray(rj.samples), **TOL)
    np.testing.assert_allclose(rt.phi_trace.numpy(), np.asarray(rj.phi_trace), **TOL)
    np.testing.assert_allclose(rt.state.theta.numpy(), np.asarray(rj.state.theta), **TOL)
    np.testing.assert_allclose(rt.beta.numpy(), np.asarray(rj.beta), **TOL)
    np.testing.assert_allclose(rt.accept_rate.numpy(), np.asarray(rj.accept_rate), rtol=1e-6)


def test_flow_psis_certify_matches_reference():
    jm, tm, jprior, tprior, _, _ = _linear_gaussian()
    flow, p = _jax_flow(seed=6, scale=0.1)
    frame = _frame(seed=7)
    key, s = jax.random.PRNGKey(12), 1.3
    cj = jf.flow_psis_certify(jm, jprior, _jres(flow, p, frame), key, n_draws=N_DRAW, batched=True,
                              base_scale=s)
    ct = tf.flow_psis_certify(tm, tprior, _port(p, ref=frame), n_draws=N_DRAW, base_scale=s,
                              Z=torch.tensor(s * _normal(key, (N_DRAW, D))))
    for f in ("k_hat", "ess", "log_evidence"):
        np.testing.assert_allclose(getattr(ct, f), getattr(cj, f), err_msg=f, **TOL)
    for f in ("log_weights", "mean", "cov"):
        np.testing.assert_allclose(getattr(ct, f), np.asarray(getattr(cj, f)), err_msg=f, **TOL)
    np.testing.assert_allclose(ct.samples.numpy(), np.asarray(cj.samples), **TOL)
    assert ct.reliable == cj.reliable


def test_flow_fit_pipeline_composition_replays_reference(monkeypatch):
    """The composition on JAX's draws, pretrain="none": plain annealed
    flow-VI (10 steps) from the identity flow the reference draws from
    k_run's first split (its key schedule: k_smc, k_mle, k_run), injected.
    The SMC route's pieces are each replayed above and in test_torch_smc.py;
    its glue is held by the next two tests."""
    jm, tm, jprior, tprior, _, _ = _linear_gaussian(seed=6, sigma=1.0)
    nc, hid, n_steps, n_mc = 2, 8, 10, 8
    kw = dict(n_couplings=nc, hidden=hid, pretrain="none", n_steps=n_steps, n_mc=n_mc, lr=0.01)
    key = jax.random.PRNGKey(13)
    rj, sj = jf.flow_fit_pipeline(jm, jm, jprior, key, **kw)
    k_run = jax.random.split(key, 3)[2]
    k_init, k_steps, k_sum = jax.random.split(k_run, 3)
    init = _port(jf.CouplingFlow(dim=D, n_couplings=nc, hidden=hid).init(k_init, jnp.float64))
    vi = tf.run_flow_vi

    def replayed(m, pr, g, *, params, **k):
        assert params is None and k["anneal_steps"] is None  # the default ramp, n_steps // 2
        eps = np.stack([_normal(jax.random.fold_in(k_steps, t), (n_mc, D)) for t in range(n_steps)])
        return vi(m, pr, None, params=init, eps=torch.tensor(eps),
                  summary_Z=torch.tensor(_normal(k_sum, (4096, D))), **k)

    monkeypatch.setattr(tf, "run_flow_vi", replayed)
    rt, st = tf.flow_fit_pipeline(tm, tm, tprior, **kw)
    assert st is sj is None
    _same_leaves(rt.flow, rj.params)
    for f in ("elbo_trace", "theta_mean", "theta_cov"):
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)), err_msg=f, **TOL)
    assert rt.n_forward == rj.n_forward == n_mc * n_steps


def test_flow_fit_pipeline_composes_smc_mle_and_refinement():
    """pretrain="smc" with a refinement is run_smc, then fit_flow_mle on its
    particles, then run_flow_vi warm-started from that flow with the ramp
    off, each drawing from the one generator in that order: the pipeline
    equals the three calls made by hand, bit for bit."""
    _, tm, _, tprior, _, _ = _linear_gaussian(seed=6, sigma=1.0)
    kw = dict(n_couplings=2, hidden=8)
    res, stages = tf.flow_fit_pipeline(tm, tm, tprior, torch.Generator().manual_seed(3), pretrain_particles=128,
                                       pretrain_steps=15, n_mutations=2, max_stages=16, n_steps=6, n_mc=8,
                                       lr=0.01, **kw)
    g = torch.Generator().manual_seed(3)
    smc = tsm.run_smc(tm, tprior, g, n_particles=128, n_mutations=2, max_stages=16)
    mle = tf.fit_flow_mle(smc.particles[0], tprior, g, n_steps=15, **kw)
    ref = tf.run_flow_vi(tm, tprior, g, n_steps=6, n_mc=8, lr=0.01, anneal_steps=0, params=mle.flow, **kw)
    assert stages == int(smc.n_stages[0]) < 16
    for a, b in zip(res.flow.params(), ref.flow.params()):
        assert torch.equal(a, b)
    for f in ("elbo_trace", "theta_mean", "theta_cov"):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    assert res.n_forward == 48


@pytest.mark.parametrize("pretrain, refinement", [("smc", 0), ("none", 3000)])
def test_flow_fit_pipeline_default_steps(pretrain, refinement, monkeypatch):
    """n_steps=None: no refinement after SMC pretraining (the MLE fit is the
    result, its anneal_steps forced to 0 for any refinement), 3,000 steps of
    annealed flow-VI after pretrain="none"."""
    _, tm, _, tprior, _, _ = _linear_gaussian(seed=6, sigma=1.0)
    seen = []
    monkeypatch.setattr(tsm, "run_smc", lambda m, pr, g, **k: tsm.SMCResult(
        particles=pr.sample(g, (1, k["n_particles"])), phi=None, log_evidence=None,
        n_stages=torch.tensor([3]), lambdas=torch.ones((k["max_stages"], 1), dtype=torch.float64),
        ess_frac=None, accept_rate=None, beta=None))
    monkeypatch.setattr(tf, "run_flow_vi", lambda m, pr, g, **k: seen.append(k) or "refined")
    res, stages = tf.flow_fit_pipeline(tm, tm, tprior, torch.Generator().manual_seed(0), pretrain=pretrain,
                                       pretrain_particles=64, pretrain_steps=3, n_couplings=2, hidden=8)
    if pretrain == "smc":
        assert stages == 3 and not seen and res.elbo_trace.shape == (3,) and res.n_forward == 0
    else:
        assert stages is None and res == "refined" and seen[0]["n_steps"] == refinement
        assert seen[0]["params"] is None and seen[0]["anneal_steps"] is None


def test_flow_fit_pipeline_refusals():
    """An SMC population stopped at max_stages with lambda < 1 raises the
    reference's RuntimeError; an unknown pretrain its ValueError."""
    _, tm, _, tprior, _, _ = _linear_gaussian(sigma=1e-3)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="hit max_stages=2 at lambda="):
        tf.flow_fit_pipeline(tm, tm, tprior, g, pretrain_particles=64, n_mutations=1, max_stages=2,
                             pretrain_steps=1)
    with pytest.raises(ValueError, match="pretrain must be 'smc' or 'none', got 'eki'"):
        tf.flow_fit_pipeline(tm, tm, tprior, g, pretrain="eki")
