"""Simulation-based calibration in the port (infer/sbc.py, api.run_sbc_check,
the sbc command) against the JAX reference.

1. Replay: run_sbc under each sampler (pcn, mala, hmc, pt_pcn), fed the
   truths, the noise, the chains' starts and the sampler's draws of JAX's
   key schedule, gives JAX's ranks, counts and p-values exactly (float64,
   J = 8 datasets x C = 7 chains).
2. The reference's cases (tests/test_sbc.py) under a torch.Generator: the
   exact samplers pass (pcn, mala, hmc, pt_pcn on the bimodal control), a
   mis-simulated noise is rejected, the blind spot of stranded chains
   passes, and the validation errors.
3. run_sbc_check on a converted res1 pipeline and the sbc command beside
   the reference CLI on one argv."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import _arrays, _cfg, cached_build_pipeline, jax_build

from bayesianinferencedl_tpu import cli as jcli
from bayesianinferencedl_tpu import config as jcfg
from bayesianinferencedl_tpu.infer import sbc as jsbc
from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch import cli as tcli
from bayesianinferencedl_tpu_torch.convert import pipeline_from_arrays
from bayesianinferencedl_tpu_torch.infer import sbc as tsbc
from bayesianinferencedl_tpu_torch.infer.pcn import run_pcn
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D, M = 2, 3
A = np.random.default_rng(0).normal(size=(M, D))
F64 = torch.float64


def _priors(d=D, dtype=F64):
    return (JPrior.iid(d, sigma=1.0, dtype=jnp.float64 if dtype == F64 else jnp.float32),
            TPrior.iid(d, sigma=1.0, dtype=dtype, device="cpu"))


def _keys(key, n_steps, n_burn):
    k_burn, k_main = jax.random.split(key)
    return jnp.concatenate([jax.random.split(k_burn, n_burn), jax.random.split(k_main, n_steps - n_burn)])


def _sampler_draws(sampler, key, n_steps, n_burn, B, d, n_temps):
    """The sampler's draws of JAX's run_* at key, every step (burn-in first):
    pcn and mala split (proposal, accept), hmc (momenta, jitter, accept),
    pt_pcn (proposal, accept, swap) over (K, G)."""
    f64 = jnp.float64

    def step(k):
        if sampler == "hmc":
            k_mom, k_jit, k_acc = jax.random.split(k, 3)
            return dict(normals=jax.random.normal(k_mom, (B, d), f64),
                        jitters=jax.random.uniform(k_jit, (B,), f64, minval=-1.0, maxval=1.0),
                        uniforms=jax.random.uniform(k_acc, (B,), f64))
        if sampler == "pt_pcn":
            k_prop, k_acc, k_swap = jax.random.split(k, 3)
            return dict(normals=jax.random.normal(k_prop, (n_temps, B, d), f64),
                        uniforms=jax.random.uniform(k_acc, (n_temps, B), f64),
                        swap_uniforms=jax.random.uniform(k_swap, (n_temps, B), f64))
        k_prop, k_acc = jax.random.split(k)
        return dict(normals=jax.random.normal(k_prop, (B, d), f64), uniforms=jax.random.uniform(k_acc, (B,), f64))

    out = jax.jit(jax.vmap(step))(_keys(key, n_steps, n_burn))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("sampler,kw", [("pcn", {}), ("mala", {"step": 0.3}),
                                        ("hmc", {"step": 0.2, "n_leap": 3}),
                                        ("pt_pcn", {"n_temps": 3, "lambda_min": 0.1})])
def test_run_sbc_replays_reference_ranks(sampler, kw):
    jp, tp = _priors()
    J, C, n_steps, n_burn, sigma = 8, 7, 16, 8, 0.5
    key = jax.random.PRNGKey(5)
    Aj, At = jnp.asarray(A), torch.tensor(A)
    rj = jsbc.run_sbc(lambda th: th @ Aj.T, jp, sigma, key, n_datasets=J, n_chains=C, n_steps=n_steps,
                      n_burn=n_burn, sampler=sampler, **kw)
    k_theta, k_noise, k_init, k_run = jax.random.split(key, 4)
    theta_star = torch.tensor(np.asarray(jp.sample(k_theta, (J,))))
    noise = torch.tensor(np.asarray(jax.random.normal(k_noise, (J, M), jnp.float64)))
    theta0 = torch.tensor(np.asarray(jp.sample(k_init, (J * C,))))
    draws = _sampler_draws(sampler, k_run, n_steps, n_burn, J * C, D, kw.get("n_temps", 5))
    rt = tsbc.run_sbc(lambda th: th @ At.T, tp, sigma, n_datasets=J, n_chains=C, n_steps=n_steps,
                      n_burn=n_burn, sampler=sampler, theta_star=theta_star, noise=noise, theta0=theta0,
                      draws=draws, **kw)
    assert rt.n_draws == rj.n_draws == C and rt.ranks.dtype == torch.int32
    np.testing.assert_array_equal(rt.ranks.numpy(), np.asarray(rj.ranks))
    np.testing.assert_array_equal(rt.counts.numpy(), np.asarray(rj.counts))
    np.testing.assert_allclose(rt.p_values.numpy(), np.asarray(rj.p_values), rtol=1e-12)
    np.testing.assert_allclose(rt.accept_rate.numpy(), np.asarray(rj.accept_rate), rtol=1e-6)
    assert len(np.unique(rt.ranks.numpy())) > 2  # the ranks spread


def _sbc(forward, prior, sigma, seed, **kw):
    return tsbc.run_sbc(forward, prior, sigma, torch.Generator().manual_seed(seed), **kw)


def _lin(th):
    return th @ torch.tensor(A, dtype=th.dtype).T


def test_sbc_accepts_exact_sampler():
    _, prior = _priors(dtype=torch.float32)
    res = _sbc(_lin, prior, 0.5, 1, n_datasets=128, n_chains=31, n_steps=800, n_burn=500)
    assert res.ranks.shape == (128, D)
    assert int(res.ranks.min()) >= 0 and int(res.ranks.max()) <= 31
    assert float(res.p_values.min()) > 1e-3, res.p_values
    assert float(res.accept_rate.mean()) > 0.05  # the chains moved


@pytest.mark.parametrize("sampler,kw", [("mala", {"step": 0.3}), ("hmc", {"step": 0.2, "n_leap": 4})])
def test_sbc_accepts_gradient_kernels(sampler, kw):
    _, prior = _priors(dtype=torch.float32)
    res = _sbc(_lin, prior, 0.5, 3, n_datasets=128, n_chains=31, n_steps=500, n_burn=300, sampler=sampler,
               **kw)
    assert float(res.p_values.min()) > 1e-3, (sampler, res.p_values)
    assert float(res.accept_rate.mean()) > 0.2


def test_sbc_rejects_miscalibrated_noise():
    """Data simulated at 2.5x the noise the likelihood assumes: the ranks
    pile at the extremes and SBC rejects."""
    _, prior = _priors(dtype=torch.float32)
    sigma = 0.5
    extra = 2.29 * sigma * torch.randn(128, M, generator=torch.Generator().manual_seed(7))
    calls = [0]

    def fwd(theta):
        out = _lin(theta)
        if calls[0] == 0:  # the first call simulates the datasets
            calls[0] = 1
            return out + extra  # sqrt(1 + 2.29^2) sigma = 2.5 sigma in all
        return out

    res = _sbc(fwd, prior, sigma, 2, n_datasets=128, n_chains=31, n_steps=800, n_burn=500)
    assert float(res.p_values.max()) < 1e-3, res.p_values


def test_rank_uniformity_pvalue_validates_bins():
    with pytest.raises(ValueError):
        tsbc.rank_uniformity_pvalue(np.zeros((10, 2), np.int32), n_draws=31, n_bins=7)
    ranks = np.tile(np.arange(32, dtype=np.int32)[:, None], (1, 2))
    p, counts = tsbc.rank_uniformity_pvalue(ranks, n_draws=31, n_bins=8)
    assert np.all(counts == 4) and np.all(p == 1.0)
    pj, cj = jsbc.rank_uniformity_pvalue(ranks[::3], n_draws=31, n_bins=8)
    pt, ct = tsbc.rank_uniformity_pvalue(ranks[::3], n_draws=31, n_bins=8)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(pt, pj)


def test_sbc_validates_chain_bin_compat():
    _, prior = _priors()
    with pytest.raises(ValueError, match="divisible"):
        _sbc(_lin, prior, 0.5, 0, n_datasets=8, n_chains=30, n_bins=8)
    with pytest.raises(ValueError, match="sampler"):
        _sbc(_lin, prior, 0.5, 0, n_datasets=8, n_chains=31, sampler="nuts")


def _sign_ambiguous(th):  # (B, 1) -> (B, 2): theta^2 leaves the sign to the weak 0.1 theta row
    return torch.cat([th**2, 0.1 * th], -1)


def test_sbc_pt_kernel_bimodal():
    _, prior = _priors(d=1, dtype=torch.float32)
    res = _sbc(_sign_ambiguous, prior, 0.05, 0, n_datasets=192, n_chains=31, n_steps=800, n_burn=500,
               sampler="pt_pcn", n_temps=5, lambda_min=0.02)
    assert float(res.p_values.min()) > 1e-3, res.p_values
    assert float(res.accept_rate.mean()) > 0.1


def test_sbc_data_averaged_blind_spot():
    """Chains stranded in their prior basin still pass SBC: their occupancy
    is the prior's, so the rank marginal stays uniform."""
    _, prior = _priors(d=1, dtype=torch.float32)
    y = torch.tensor([1.0, 0.1])

    def misfit(th):
        r = _sign_ambiguous(th) - y
        return 0.5 / 0.05**2 * torch.sum(r * r, -1)

    theta0 = prior.sample(torch.Generator().manual_seed(1), (512,))
    pres = run_pcn(misfit, prior, theta0, torch.Generator().manual_seed(2), n_steps=800, n_burn=500)
    fin = pres.samples[-1][:, 0]
    assert float(((fin < 0) != (theta0[:, 0] < 0)).float().mean()) < 0.2  # stranded
    res = _sbc(_sign_ambiguous, prior, 0.05, 0, n_datasets=192, n_chains=31, n_steps=800, n_burn=500)
    assert float(res.p_values.min()) > 0.01, res.p_values


def test_run_sbc_check_on_a_converted_pipeline(monkeypatch):
    jpipe = jax_build(_cfg(1e-10, jcfg), jnp.float64)
    tpipe = pipeline_from_arrays(_cfg(1e-10), _arrays(jpipe), device="cpu", dtype=F64)
    seen = {}
    plain = api.run_sbc

    def spy(fwd, prior, sigma, gen, **kw):
        seen["fwd"], seen["sigma"], seen["kw"] = fwd, sigma, kw
        return plain(fwd, prior, sigma, gen, **kw)

    monkeypatch.setattr(api, "run_sbc", spy)
    res = api.run_sbc_check(tpipe, "rom_nn", n_datasets=8, n_chains=7, n_steps=30, n_burn=15, seed=3)
    assert res.ranks.shape == (8, 5) and seen["sigma"] == 1e-2 and seen["kw"]["n_chains"] == 7
    # the forward it calibrates is the pipeline's rom_nn one (JAX's: test_torch_slice.py)
    th = torch.tensor(np.random.default_rng(0).normal(0, 0.6, (4, 5)))
    assert torch.equal(seen["fwd"](th), tpipe.working_forward_fn("rom_nn")(th))
    again = api.run_sbc_check(tpipe, "rom_nn", n_datasets=8, n_chains=7, n_steps=30, n_burn=15, seed=3)
    assert torch.equal(again.ranks, res.ranks)  # the seed fixes the run


def test_cli_sbc_beside_reference(capsys, monkeypatch):
    argv = ["sbc", "--resolution", "1", "--n-snapshots", "32", "--r", "8", "--n-train", "64", "--epochs",
            "5", "--datasets", "8", "--sbc-chains", "7", "--steps", "30", "--burn", "15"]
    jcli.main(argv)
    j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(api, "build_pipeline", cached_build_pipeline)
    tcli.main(argv + ["--device", "cpu"])
    t = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(t) == set(j)
    assert (t["n_datasets"], t["n_posterior_draws"], t["sampler"]) == (8, 7, "pcn")
    assert np.array(t["rank_counts"]).shape == np.array(j["rank_counts"]).shape == (5, 8)
    assert np.array(t["rank_counts"]).sum(1).tolist() == [8] * 5 and 0 < t["accept_rate"] < 1
