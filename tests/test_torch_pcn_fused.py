"""The fused pCN sampler (K2) of the port against the JAX package.

On the CPU ``run_pcn_fused`` runs its plain torch version. It is held
1. against the JAX Pallas kernel in interpret mode. The interpreter's
   hardware PRNG returns all-zero bits, so every uniform there is
   0 * 2^-24 + 2^-25; the port is fed uniforms of that value;
2. against the port's own ``run_pcn`` in float64 on the same draws (normals
   by Box-Muller from the same uniforms, the accept uniform from column 7);
3. and its wrapper raises where the reference asserts.
The Philox stream the kernel draws from is held against the generator's
published known-answer vectors. Sizes: res1, r = 8, (16, 16) MLP, 32 chains.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bayesianinferencedl_tpu import config as jcfg
from bayesianinferencedl_tpu.experimental.pcn_fused import run_pcn_fused as j_run_pcn_fused
from bayesianinferencedl_tpu_torch import config as tcfg
from bayesianinferencedl_tpu_torch.convert import pipeline_from_arrays
from bayesianinferencedl_tpu_torch.experimental import pcn_fused as K2
from bayesianinferencedl_tpu_torch.infer import pcn as tp
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.rom.galerkin import ReducedOperator
from test_torch_slice import jax_build

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

C, D, NOISE = 32, 5, 1e-2
ZERO_BITS_UNIFORM = 2.0**-25  # the interpreter's all-zero bits through the reference's map


def _cfg(cfg):
    return cfg.PipelineConfig(
        mesh=cfg.MeshConfig(resolution=1),
        fem=cfg.FEMConfig(biot=0.1, cg_tol=1e-10, cg_maxiter=1500),
        rom=cfg.ROMConfig(n_snapshots=32, basis_size=8),
        surrogate=cfg.SurrogateConfig(hidden=(16, 16), n_train=64, epochs=20),
        mcmc=cfg.MCMCConfig(noise_sigma=NOISE),
    )


def _arrays(jpipe) -> dict:
    rom, sur = jpipe.rom, jpipe.surrogate
    out = {f: np.asarray(getattr(rom, f)) for f in ("Ahat", "Mhat", "Fhat", "Bhat", "V")}
    out["P0"] = np.asarray(jpipe.P0)
    for i, (W, b) in enumerate(sur.params):
        out[f"W{i}"], out[f"b{i}"] = np.asarray(W), np.asarray(b)
    out.update({f: np.asarray(getattr(sur.norm, f)) for f in ("x_mean", "x_std", "y_mean", "y_std")})
    out["rom_pcg_iters"] = np.asarray(jpipe.rom_pcg_iters)
    return out


@pytest.fixture(scope="module")
def pipes():
    """One JAX pipeline in float64, carried into the port in float32 and
    float64, and the data and initial states of every test."""
    jpipe = jax_build(_cfg(jcfg), jnp.float64)
    arrays = _arrays(jpipe)
    rng = np.random.default_rng(0)
    theta_true = rng.normal(0.0, 0.6, (1, D))
    data = np.asarray(jpipe.batched_forward_fn("rom_nn")(jnp.asarray(theta_true)))[0]
    data = data + NOISE * rng.normal(size=data.shape)
    theta0 = rng.normal(0.0, 0.6, (C, D))
    tpipes = {dt: pipeline_from_arrays(_cfg(tcfg), arrays, device="cpu", dtype=dt)
              for dt in (torch.float32, torch.float64)}
    return jpipe, tpipes, data, theta0


def _port_args(tpipe, data, theta0):
    dt = tpipe.P0.dtype
    return (tpipe.rom, tpipe.P0, tpipe.surrogate.params, tpipe.surrogate.norm, tpipe.prior,
            torch.tensor(data, dtype=dt), NOISE, torch.tensor(theta0, dtype=dt))


@pytest.mark.parametrize("n_burn", [0, 12])
def test_plain_matches_pallas_kernel_in_interpret_mode(pipes, n_burn):
    jpipe, tpipes, data, theta0 = pipes
    n_steps, cg_iters, beta = 24, 15, 0.3
    with pltpu.force_tpu_interpret_mode():
        rj = j_run_pcn_fused(
            jpipe.rom, jpipe.P0, jpipe.surrogate.params, jpipe.surrogate.norm, jpipe.prior,
            jnp.asarray(data), NOISE, jnp.asarray(theta0), jnp.int32(3),
            n_steps=n_steps, n_burn=n_burn, beta=beta, cg_iters=cg_iters,
        )
    u = torch.full((n_steps, C, K2.STATE_COLS), ZERO_BITS_UNIFORM, dtype=torch.float32)
    rt = K2.run_pcn_fused(*_port_args(tpipes[torch.float32], data, theta0), 3, n_steps=n_steps,
                          n_burn=n_burn, beta=beta, cg_iters=cg_iters, uniforms=(u, u))
    assert rt.trace.shape == (n_steps, C, K2.STATE_COLS) and rt.trace.dtype == torch.float32
    acc_j, acc_t = np.asarray(rj.accept_rate), rt.accept_rate.numpy()
    assert 0 < float(rt.trace[:, :, 7].mean()) < 1  # the constant draws accept and reject
    # both sides are float32 with other summation orders (XLA's dots against
    # torch's): states agree to float32 rounding carried through 15 CG
    # iterations and the accept decisions agree exactly
    np.testing.assert_array_equal(acc_t, acc_j)
    np.testing.assert_allclose(rt.samples.numpy(), np.asarray(rj.samples), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rt.phi_trace.numpy(), np.asarray(rj.phi_trace), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rt.beta.numpy(), np.asarray(rj.beta), rtol=1e-6)
    # the kept rows of the port's trace are its samples, phi and accepts
    kept = rt.trace[n_burn:]
    np.testing.assert_array_equal(kept[:, :, :D].numpy(), rt.samples.numpy())
    np.testing.assert_array_equal(kept[:, :, 7].mean(0).numpy(), acc_t)


def test_plain_matches_run_pcn_in_float64(pipes):
    _, tpipes, data, theta0 = pipes
    tpipe = tpipes[torch.float64]
    n_steps, n_burn = 60, 20
    rng = np.random.default_rng(7)
    u1, u2 = (torch.tensor(rng.uniform(size=(n_steps, C, K2.STATE_COLS))) for _ in range(2))
    rf = K2.run_pcn_fused(*_port_args(tpipe, data, theta0), 11, n_steps=n_steps, n_burn=n_burn,
                          beta=0.25, cg_iters=tpipe.rom_pcg_iters, uniforms=(u1, u2),
                          return_uniforms=True)
    assert rf.uniforms[0] is u1 and rf.uniforms[1] is u2
    # the reference's 2 pi is a float32 constant
    two_pi = float(np.float32(2.0 * np.pi))
    normals = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)
    misfit = tp.gaussian_misfit(tpipe.batched_forward_fn("rom_nn"), torch.tensor(data), NOISE)
    rp = tp.run_pcn(misfit, tpipe.prior, torch.tensor(theta0), n_steps=n_steps, n_burn=n_burn,
                    beta=0.25, normals=normals[:, :, :D], uniforms=u2[:, :, 7])
    assert 0.05 < float(rp.accept_rate.mean()) < 0.95
    for a, b in ((rf.samples, rp.samples), (rf.phi_trace, rp.phi_trace), (rf.beta, rp.beta)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-10)
    # run_pcn reports its acceptance rate in float32 (as the reference's
    # does): the same accept counts give the same float32 rates exactly
    np.testing.assert_array_equal(rf.accept_rate.to(torch.float32).numpy(), rp.accept_rate.numpy())


def test_seeded_draws_are_philox_and_replay(pipes):
    _, tpipes, data, theta0 = pipes
    args = _port_args(tpipes[torch.float32], data, theta0)
    kw = dict(n_steps=8, n_burn=4, cg_iters=15)
    ra = K2.run_pcn_fused(*args, 5, return_uniforms=True, **kw)
    u1, u2 = ra.uniforms
    assert u1.shape == (8, C, K2.STATE_COLS) and 0 < float(u1.min()) and float(u2.max()) <= 1
    np.testing.assert_array_equal(torch.cat(K2.philox_uniforms(5, 3, C), 1).numpy(),
                                  torch.cat([u1[3], u2[3]], 1).numpy())
    rb = K2.run_pcn_fused(*args, 5, uniforms=(u1, u2), **kw)
    np.testing.assert_array_equal(rb.trace.numpy(), ra.trace.numpy())
    rc = K2.run_pcn_fused(*args, 6, **kw)
    assert not torch.equal(rc.trace, ra.trace)


@pytest.mark.parametrize("ctr, key, expect", [
    ((0, 0, 0, 0), 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, 0xFFFFFFFFFFFFFFFF, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), 0x299F31D0A4093822,
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, expect):
    words = K2.philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
    assert tuple(int(w) for w in words) == expect


def _bad_args(kind, tpipe, data, theta0):
    rom, P0, params, norm, prior, y, noise, th0 = _port_args(tpipe, data, theta0)
    if kind == "three_hidden_layers":
        (W1, b1), (W2, b2), last = params
        params = [(W1, b1), (W2, b2), (W2, b2), last]
    elif kind == "d_above_5":
        th0 = torch.cat([th0, th0[:, :1]], 1)
    elif kind == "more_than_8_observables":
        Bhat = torch.cat([rom.Bhat, rom.Bhat], 0)  # 10 observables
        rom = ReducedOperator(Ahat=rom.Ahat, Mhat=rom.Mhat, Fhat=rom.Fhat, Bhat=Bhat, V=rom.V,
                              biot=rom.biot)
    elif kind == "non_iid_prior":
        prior = GaussianPrior(mean=prior.mean, chol=torch.diag(torch.linspace(0.5, 0.7, D,
                                                                              dtype=P0.dtype)))
    elif kind == "r_above_64":
        r = 65
        rom = ReducedOperator(Ahat=torch.zeros((5, r, r), dtype=P0.dtype), Mhat=torch.zeros((r, r)),
                              Fhat=torch.zeros(r), Bhat=torch.zeros((5, r)), V=rom.V, biot=rom.biot)
    return rom, P0, params, norm, prior, y, noise, th0


@pytest.mark.parametrize("kind", ["three_hidden_layers", "d_above_5", "more_than_8_observables",
                                  "non_iid_prior", "r_above_64"])
def test_wrapper_raises_outside_its_limits(pipes, kind):
    _, tpipes, data, theta0 = pipes
    args = _bad_args(kind, tpipes[torch.float64], data, theta0)
    with pytest.raises(ValueError):
        K2.run_pcn_fused(*args, 0, n_steps=2, cg_iters=2)
