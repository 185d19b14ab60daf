"""Parallel tempering in the port (infer/tempering.py) against the JAX
reference, in float64 at small sizes unless a case says otherwise.

1. The ladder helpers and one replica-exchange pass against JAX's on seeded
   inputs, equal to rounding.
2. Replay: run_pt_pcn (burn-in included, with a geometric, an adaptive and
   a resumed ladder) and run_pt_da_segmented (three segments, adaptive
   ladder) are fed the draws of JAX's key schedule, regenerated here from
   the reference's splits, and must give every field of JAX's result.
3. The odd-segment, K-mismatch and unknown-inner-kernel refusals (MALA
   subchains run: test_torch_pt_mala.py).
4. The analytic cases of tests/test_tempering.py on the port's own
   torch.Generator, at that file's tolerances: the unimodal linear-Gaussian
   posterior and the bimodal mode masses, for PT-pCN and tempered DA, with
   8x the reference's chains for an eighth of its kept steps (unimodal) and
   4x for a quarter (bimodal): the same kept draws, the chains a batch and
   the loop eager.
5. The slice at res2: a JAX float32 pipeline carried over by
   convert.pipeline_from_arrays, run_pt_pcn on the real rom_nn misfit with
   replayed draws, within 1e-5 of JAX's, and both sides' log Z within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu import config as jcfg
from bayesianinferencedl_tpu.infer import tempering as jt
from bayesianinferencedl_tpu.infer.evidence import log_evidence_from_pt as j_evidence
from bayesianinferencedl_tpu.infer.pcn import gaussian_misfit as j_misfit
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu_torch import config as tcfg
from bayesianinferencedl_tpu_torch.convert import pipeline_from_arrays
from bayesianinferencedl_tpu_torch.infer import tempering as tt
from bayesianinferencedl_tpu_torch.infer.evidence import log_evidence_from_pt as t_evidence
from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit as t_misfit
from bayesianinferencedl_tpu_torch.infer.pcn import run_pcn
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior
from test_torch_slice import jax_build

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D, M, SIGMA = 3, 4, 0.5
FIELDS = ("samples", "phi_trace", "swap_rate", "beta", "theta", "lambdas", "phi_level_mean",
          "phi2_level_mean", "ss_level_mean")


def _close(t, j, tol=1e-12):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol, atol=tol)


def _same_rate(t, j):
    """Float32 rates: the same counts over the same denominators, to the one
    float32 ulp by which XLA's product with a reciprocal and torch's
    division may differ."""
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2.0**-23, atol=0)


def _problem(seed=0):
    """A mildly nonlinear batched forward tanh(theta) H^T (the misfits of
    both sides) and a correlated prior."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((M, D))
    data = rng.standard_normal(M)
    mean = np.linspace(-0.2, 0.2, D)
    L = np.tril(0.1 * np.ones((D, D))) + 0.7 * np.eye(D)
    Hj, Ht = jnp.asarray(H), torch.from_numpy(H)
    j = dict(misfit=j_misfit(lambda t: jnp.tanh(t) @ Hj.T, jnp.asarray(data), SIGMA),
             coarse=j_misfit(lambda t: jnp.tanh(t) @ Hj.T + 0.1, jnp.asarray(data), SIGMA),
             prior=JPrior(jnp.asarray(mean), jnp.asarray(L)))
    t = dict(misfit=t_misfit(lambda x: torch.tanh(x) @ Ht.T, torch.from_numpy(data), SIGMA),
             coarse=t_misfit(lambda x: torch.tanh(x) @ Ht.T + 0.1, torch.from_numpy(data), SIGMA),
             prior=TPrior(torch.from_numpy(mean), torch.from_numpy(L)))
    return j, t


def _run_keys(key, n_steps, n_burn):
    """The per-step keys of a JAX PT run: k_burn's split for burn-in, then
    k_main's."""
    k_burn, k_main = jax.random.split(key)
    keys = list(jax.random.split(k_burn, n_burn)) if n_burn > 0 else []
    return keys + list(jax.random.split(k_main, n_steps - n_burn))


def _pt_draws(key, n_steps, n_burn, K, G, d, dtype=jnp.float64):
    """The draws of JAX's run_pt_pcn(key): per step the proposal normals,
    the acceptance uniforms and the swap uniforms."""
    out = ([], [], [])
    for k in _run_keys(key, n_steps, n_burn):
        k_prop, k_acc, k_swap = jax.random.split(k, 3)
        out[0].append(np.asarray(jax.random.normal(k_prop, (K, G, d), dtype)))
        out[1].append(np.asarray(jax.random.uniform(k_acc, (K, G), dtype)))
        out[2].append(np.asarray(jax.random.uniform(k_swap, (K, G), dtype)))
    return tuple(torch.from_numpy(np.stack(a)) for a in out)


def _pt_da_draws(key, n_steps, n_burn, subchain, K, G):
    """The draws of JAX's run_pt_da(key): per outer step the subchain's
    normals and uniforms, the outer uniforms and the swap uniforms."""
    nrm, uni, outer, swap = [], [], [], []
    for k in _run_keys(key, n_steps, n_burn):
        k_sub, k_acc, k_swap = jax.random.split(k, 3)
        pairs = [jax.random.split(ki) for ki in jax.random.split(k_sub, subchain)]
        nrm.append(np.stack([np.asarray(jax.random.normal(a, (K, G, D), jnp.float64)) for a, _ in pairs]))
        uni.append(np.stack([np.asarray(jax.random.uniform(b, (K, G), jnp.float64)) for _, b in pairs]))
        outer.append(np.asarray(jax.random.uniform(k_acc, (K, G), jnp.float64)))
        swap.append(np.asarray(jax.random.uniform(k_swap, (K, G), jnp.float64)))
    return tuple(torch.from_numpy(np.stack(a)) for a in (nrm, uni, outer, swap))


# --- 1. the ladder and the exchange -----------------------------------------


@pytest.mark.parametrize("n_temps,lambda_min", [(1, 0.05), (4, 0.05), (6, 0.01)])
def test_ladder_helpers_match_reference(n_temps, lambda_min):
    G = 5
    _close(tt.geometric_ladder(n_temps, lambda_min, torch.float64),
           jt.geometric_ladder(n_temps, lambda_min, jnp.float64))
    lam_t, gap_t = tt._ladder_init(None, n_temps, lambda_min, G, torch.float64, "cpu")
    lam_j, gap_j = jt._ladder_init(None, n_temps, lambda_min, G, jnp.float64)
    _close(lam_t, lam_j)
    _close(gap_t, gap_j)
    assert lam_t.shape == (n_temps, G) and float(lam_t[-1, 0]) == 1.0
    if n_temps == 1:
        return
    # an explicit (K, G) ladder, e.g. a result's lambdas
    rng = np.random.default_rng(n_temps)
    gaps = rng.normal(-1.0, 0.5, (n_temps - 1, G))
    _close(tt._lam_from_gaps(torch.from_numpy(gaps)), jt._lam_from_gaps(jnp.asarray(gaps)))
    lam = np.array(jt._lam_from_gaps(jnp.asarray(gaps)))
    assert np.all(np.diff(lam, axis=0) > 0) and np.all(lam[-1] == 1.0)
    _close(tt._ladder_init(torch.from_numpy(lam), n_temps, lambda_min, G, torch.float64, "cpu")[1],
           jt._ladder_init(jnp.asarray(lam), n_temps, lambda_min, G, jnp.float64)[1])
    # one update inside burn-in and one after, with gaps past both caps
    gaps[0, :2] = (-12.0, 3.0)
    alpha = rng.uniform(0.0, 1.0, (n_temps, G))
    active = (np.arange(n_temps) % 2 == 0).astype(np.float64)[:, None]
    for t in (3, 9):
        upd_t = tt._ladder_update(torch.from_numpy(gaps), (torch.from_numpy(alpha), torch.from_numpy(active)),
                                  t, t + 10.0, 5)
        upd_j = jt._ladder_update(jnp.asarray(gaps), (jnp.asarray(alpha), jnp.asarray(active)),
                                  jnp.asarray(float(t)), jnp.asarray(t + 10.0), 5, jnp.dtype("float64"))
        _close(upd_t, upd_j)


@pytest.mark.parametrize("K", [2, 5])
@pytest.mark.parametrize("t_global", [6.0, 7.0])
def test_replica_exchange_matches_reference(K, t_global):
    G = 64
    rng = np.random.default_rng(K)
    lam = np.sort(rng.uniform(0.05, 1.0, (K, G)), axis=0)
    lam[-1] = 1.0
    phi = rng.exponential(5.0, (K, G))
    theta = rng.normal(size=(K, G, D))
    n_swap = rng.uniform(0.0, 3.0, (K - 1,))
    key = jax.random.PRNGKey(K)
    u_sw = np.asarray(jax.random.uniform(key, (K, G), jnp.float64))
    (tj, pj), nj, (aj, actj) = jt._replica_exchange(
        jnp.asarray(4.0), jnp.asarray(t_global), jnp.asarray(lam), jnp.asarray(phi),
        (jnp.asarray(theta), jnp.asarray(phi)), key, 2, jnp.asarray(n_swap))
    plans = [tt._exchange_plan(K, p, "cpu") for p in (0, 1)]
    (th, pt), nt, (at, actt) = tt._replica_exchange(
        t_global, torch.from_numpy(lam), torch.from_numpy(phi),
        (torch.from_numpy(theta), torch.from_numpy(phi)), torch.from_numpy(u_sw),
        torch.from_numpy(n_swap), True, plans)
    np.testing.assert_array_equal(th.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    _close(nt, nj)
    _close(at, aj)
    _close(actt, actj)
    # some pairs swapped, where the parity has one (K = 2 at odd parity has none)
    assert np.array_equal(th.numpy(), theta) == (K == 2 and t_global % 2 == 1)


# --- 2. replayed runs ---------------------------------------------------------


@pytest.mark.parametrize("mode", ["geometric", "adaptive", "resume"])
def test_run_pt_pcn_replays_reference(mode):
    j, t = _problem()
    K, G, n_steps, n_burn = 4, 8, 40, 15
    rng = np.random.default_rng(3)
    theta0 = rng.normal(0.0, 0.7, (G, D))
    kw = dict(n_steps=n_steps, n_burn=n_burn, beta=0.4, n_temps=K, lambda_min=0.05,
              adapt_ladder=mode != "geometric")
    beta = 0.4
    if mode == "resume":  # per-level states, per-chain betas and a (K, G) ladder
        theta0 = rng.normal(0.0, 0.7, (K, G, D))
        beta = rng.uniform(0.1, 0.6, (K, G))
        lam = np.sort(rng.uniform(0.1, 1.0, (K, G)), axis=0)
        lam[-1] = 1.0
        kw.update(beta=beta, ladder=lam, adapt_t0=5.0)
    key = jax.random.PRNGKey(11)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    rj = jt.run_pt_pcn(j["misfit"], j["prior"], jnp.asarray(theta0), key, batched=True, **jkw)
    nrm, uni, sw = _pt_draws(key, n_steps, n_burn, K, G, D)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    rt = tt.run_pt_pcn(t["misfit"], t["prior"], torch.from_numpy(theta0), normals=nrm, uniforms=uni,
                       swap_uniforms=sw, **tkw)
    assert rt.samples.shape == (n_steps - n_burn, G, D)
    for f in FIELDS:
        _close(getattr(rt, f), getattr(rj, f))
    _same_rate(rt.accept_rate, rj.accept_rate)
    assert 0 < float(rt.swap_rate.min()) and float(rt.swap_rate.max()) < 1
    if mode == "adaptive":
        assert not np.allclose(rt.lambdas.numpy(), tt.geometric_ladder(K, 0.05, torch.float64)[:, None])


def test_run_pt_da_segmented_replays_reference_over_three_segments():
    j, t = _problem()
    K, G, S, n_steps, n_burn, segment = 3, 8, 3, 10, 5, 4  # segments 4 (burn-in), 4 (1), 2 (0)
    theta0 = np.random.default_rng(4).normal(0.0, 0.7, (G, D))
    key = jax.random.PRNGKey(9)
    kw = dict(n_steps=n_steps, n_burn=n_burn, beta=0.4, subchain=S, n_temps=K, lambda_min=0.1,
              segment=segment, adapt_ladder=True)
    rj = jt.run_pt_da_segmented(j["misfit"], j["coarse"], j["prior"], jnp.asarray(theta0), key,
                                batched=True, **kw)
    parts, done, k = [], 0, key
    while done < n_steps:
        this = min(segment, n_steps - done)
        k, sub = jax.random.split(k)
        parts.append(_pt_da_draws(sub, this, min(max(n_burn - done, 0), this), S, K, G))
        done += this
    nrm, uni, outer, sw = (torch.cat([p[i] for p in parts]) for i in range(4))
    rt = tt.run_pt_da_segmented(t["misfit"], t["coarse"], t["prior"], torch.from_numpy(theta0),
                                normals=nrm, uniforms=uni, outer_uniforms=outer, swap_uniforms=sw, **kw)
    assert rt.samples.shape == (n_steps - n_burn, G, D)
    for f in FIELDS:
        _close(getattr(rt, f), getattr(rj, f))
    _same_rate(rt.accept_rate, rj.accept_rate)
    _same_rate(rt.inner_accept_rate, rj.inner_accept_rate)
    assert rt.n_fine_evals == rj.n_fine_evals == n_steps + 3
    assert 0 < float(rt.accept_rate.mean()) < 1  # the biased coarse model makes the correction bite


# --- 3. refusals --------------------------------------------------------------


def test_refusals():
    _, t = _problem()
    theta = torch.zeros((3, 4, D), dtype=torch.float64)
    with pytest.raises(ValueError, match="even"):
        tt.run_pt_da_segmented(t["misfit"], t["coarse"], t["prior"], theta[0], n_steps=4, segment=3)
    with pytest.raises(ValueError, match="n_temps=4"):
        tt.run_pt_pcn(t["misfit"], t["prior"], theta, n_steps=2, n_temps=4)
    with pytest.raises(ValueError, match="n_temps=2"):
        tt.run_pt_da(t["misfit"], t["coarse"], t["prior"], theta, n_steps=2, n_temps=2)
    with pytest.raises(ValueError, match="unknown DA inner kernel"):
        tt.run_pt_da(t["misfit"], t["coarse"], t["prior"], theta[0], n_steps=2, n_temps=3, inner="hmc")


# --- 4. analytic cases on the port's own generator ---------------------------


def _linear_gaussian():
    d, m, sigma, prior_sigma = 3, 4, 0.5, 1.0
    rng = np.random.default_rng(0)
    H = rng.standard_normal((m, d))
    data = rng.standard_normal(m)
    prior = TPrior.iid(d, mean=0.0, sigma=prior_sigma, dtype=torch.float64, device="cpu")
    Cpost = np.linalg.inv(H.T @ H / sigma**2 + np.eye(d) / prior_sigma**2)
    mu = Cpost @ H.T @ data / sigma**2
    Ht = torch.from_numpy(H)
    return t_misfit(lambda x: x @ Ht.T, torch.from_numpy(data), sigma), prior, mu, Cpost


def _bimodal_setup():
    """Posterior ~ exp(-Phi) N(0, 1) with two wells at +-a of unequal depth
    (depth 0: the equal-depth coarse model); mass and mean by quadrature."""
    a, s, depth = 1.6, 0.12, 0.5

    def misfit(depth):
        def phi(t):
            q1 = (t[..., 0] - a) ** 2 / (2 * s**2)
            q2 = (t[..., 0] + a) ** 2 / (2 * s**2) + depth
            return -torch.logsumexp(torch.stack([-q1, -q2], -1), -1)
        return phi

    g = np.linspace(-4, 4, 20001)
    logp = np.logaddexp(-(g - a) ** 2 / (2 * s**2), -(g + a) ** 2 / (2 * s**2) - depth) - 0.5 * g**2
    w = np.exp(logp - logp.max())
    w /= w.sum()
    return misfit(depth), misfit(0.0), float(w[g > 0].sum()), float(w @ g)


def _hops(samples) -> float:
    s = samples.numpy()[..., 0]
    return float((np.sign(s[1:]) != np.sign(s[:-1])).mean())


def test_pt_matches_analytic_posterior_unimodal():
    misfit, prior, mu, Cpost = _linear_gaussian()
    gen = torch.Generator().manual_seed(0)
    res = tt.run_pt_pcn(misfit, prior, prior.sample(gen, (512,)), gen, n_steps=875, n_burn=250,
                        beta=0.4, n_temps=4, lambda_min=0.1)
    samples = res.samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(samples.mean(0), mu, atol=0.05)
    np.testing.assert_allclose(np.cov(samples.T), Cpost, atol=0.06)
    assert float(res.swap_rate.min()) > 0.2  # the ladder exchanges


def test_pt_recovers_bimodal_masses_where_pcn_fails():
    misfit, _, mass_right, mean = _bimodal_setup()
    prior = TPrior.iid(1, mean=0.0, sigma=1.0, dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(2)
    theta0 = prior.sample(gen, (256,))
    res = tt.run_pt_pcn(misfit, prior, theta0, gen, n_steps=2000, n_burn=500, beta=0.3, n_temps=5,
                        lambda_min=0.02)
    s = res.samples.reshape(-1).numpy()
    assert abs(float((s > 0).mean()) - mass_right) < 0.05
    assert abs(s.mean() - mean) < 0.1
    # single-temperature pCN on the same budget: chains freeze in their well
    res_1t = run_pcn(misfit, prior, theta0, gen, n_steps=2000, n_burn=500, beta=0.3)
    assert _hops(res_1t.samples) < 1e-3
    assert _hops(res.samples) > 1e-3  # PT's cold chains hop


def test_pt_da_identity_coarse_matches_analytic():
    """coarse == fine: every correction accepts and tempered DA is PT, so
    the cold level must match the analytic posterior."""
    misfit, prior, mu, Cpost = _linear_gaussian()
    gen = torch.Generator().manual_seed(0)
    res = tt.run_pt_da(misfit, misfit, prior, prior.sample(gen, (512,)), gen, n_steps=375,
                       n_burn=125, beta=0.4, subchain=4, n_temps=3, lambda_min=0.1)
    np.testing.assert_allclose(res.accept_rate.numpy(), 1.0)
    samples = res.samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(samples.mean(0), mu, atol=0.05)
    np.testing.assert_allclose(np.cov(samples.T), Cpost, atol=0.07)
    assert float(res.swap_rate.min()) > 0.2


def test_pt_da_exact_bimodal_masses_despite_biased_coarse():
    """The coarse model has the wells without the depth asymmetry (mass
    ~0.5 each): tempering supplies the hops, the fine correction the
    masses."""
    misfit_f, misfit_c, mass_right, mean = _bimodal_setup()
    prior = TPrior.iid(1, mean=0.0, sigma=1.0, dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(2)
    res = tt.run_pt_da(misfit_f, misfit_c, prior, prior.sample(gen, (256,)), gen, n_steps=1000,
                       n_burn=250, beta=0.3, subchain=4, n_temps=5, lambda_min=0.02)
    s = res.samples.reshape(-1).numpy()
    assert abs(float((s > 0).mean()) - mass_right) < 0.05
    assert abs(s.mean() - mean) < 0.1
    assert abs(0.5 - mass_right) > 0.1
    assert _hops(res.samples) > 1e-3
    assert 0.15 < float(res.accept_rate.mean()) < 0.9999


# --- 5. the slice at res2 ----------------------------------------------------


def _cfg(cfg):
    return cfg.PipelineConfig(
        mesh=cfg.MeshConfig(resolution=2),
        fem=cfg.FEMConfig(biot=0.1, cg_tol=1e-7, cg_maxiter=1500),
        rom=cfg.ROMConfig(n_snapshots=32, basis_size=8),
        surrogate=cfg.SurrogateConfig(hidden=(16, 16), n_train=64, epochs=20),
        mcmc=cfg.MCMCConfig(noise_sigma=1e-2),
    )


def test_pt_pcn_on_converted_res2_rom_nn_matches_reference():
    jpipe = jax_build(_cfg(jcfg), jnp.float32)
    rom, sur = jpipe.rom, jpipe.surrogate
    arrays = {f: np.asarray(getattr(rom, f)) for f in ("Ahat", "Mhat", "Fhat", "Bhat", "V")}
    arrays["P0"], arrays["rom_pcg_iters"] = np.asarray(jpipe.P0), np.asarray(jpipe.rom_pcg_iters)
    for i, (W, b) in enumerate(sur.params):
        arrays[f"W{i}"], arrays[f"b{i}"] = np.asarray(W), np.asarray(b)
    arrays.update({f: np.asarray(getattr(sur.norm, f)) for f in ("x_mean", "x_std", "y_mean", "y_std")})
    tpipe = pipeline_from_arrays(_cfg(tcfg), arrays, device="cpu", dtype=torch.float32)

    K, G, n_steps, n_burn = 4, 8, 30, 10
    rng = np.random.default_rng(5)
    fwd_j = jpipe.batched_forward_fn("rom_nn")
    data = np.asarray(fwd_j(jnp.asarray(rng.normal(0, 0.6, (1, 5)), jnp.float32)))[0]
    data = (data + 1e-2 * rng.normal(size=data.shape)).astype(np.float32)
    theta0 = rng.normal(0.0, 0.6, (G, 5)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    misfit_j = j_misfit(fwd_j, jnp.asarray(data), 1e-2)
    rj = jt.run_pt_pcn(misfit_j, jpipe.prior, jnp.asarray(theta0), key, n_steps=n_steps,
                       n_burn=n_burn, beta=0.25, n_temps=K, batched=True, adapt_ladder=True)
    nrm, uni, sw = _pt_draws(key, n_steps, n_burn, K, G, 5, jnp.float32)
    misfit_t = t_misfit(tpipe.batched_forward_fn("rom_nn"), torch.from_numpy(data), 1e-2)
    rt = tt.run_pt_pcn(misfit_t, tpipe.prior, torch.from_numpy(theta0), n_steps=n_steps, n_burn=n_burn,
                       beta=0.25, n_temps=K, adapt_ladder=True, normals=nrm, uniforms=uni,
                       swap_uniforms=sw)
    assert rt.samples.dtype == torch.float32
    for f in FIELDS:
        a, b = getattr(rt, f).numpy(), np.asarray(getattr(rj, f))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * max(np.abs(b).max(), 1e-30))
    np.testing.assert_array_equal(rt.accept_rate.numpy() * (n_steps - n_burn),
                                  np.round(np.asarray(rj.accept_rate) * (n_steps - n_burn)))
    # log Z on both sides, the prior batch's normals shared
    k_ev = jax.random.PRNGKey(17)
    ej = j_evidence(rj, misfit_j, jpipe.prior, k_ev, batched=True)
    z = np.asarray(jax.random.normal(k_ev, (4096, 5), jnp.float32))
    et = t_evidence(rt, misfit_t, tpipe.prior, normals=torch.from_numpy(z))
    assert np.isfinite(et.log_z) and np.isfinite(et.log_z_std)
    assert abs(et.log_z - ej.log_z) < 1e-4, (et.log_z, ej.log_z)
    assert abs(et.log_z_std - ej.log_z_std) < 1e-4
