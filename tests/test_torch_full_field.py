"""The full-field slice (api_full_field.py) against the JAX package on the
CPU.

1. One JAX build at res1 in float64 (16 features, r 6, k basis 16, 32
   snapshots, 64 training rows, 40 surrogate steps, FOM tol 1e-12), made
   under the test run's shared JAX compilation cache (test_torch_slice),
   carried across by ``convert.full_field_from_arrays`` (its W and b
   redrawn exactly as the reference's RandomField.create draws them): the
   port's forward_fn and batched_forward_fn (plain and differentiable) on
   fom, rom and rom_nn equal JAX's to 1e-10; pCN on rom_nn, da_pcn on fom
   and lis_pcn on rom_nn, fed the draws of JAX's key schedule, reproduce
   JAX's samples to 1e-9, and build_lis on rom_nn equals JAX's.
The port's own build end to end and its CLI: test_torch_full_field_port.py.
Sizes: res1, few chains and steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_slice  # noqa: F401  (the run's shared JAX compilation cache)
from bayesianinferencedl_tpu.api_full_field import build_full_field_pipeline as j_build
from bayesianinferencedl_tpu.infer import delayed_acceptance as jda
from bayesianinferencedl_tpu.infer import lis as jl
from bayesianinferencedl_tpu.infer import pcn as jp
from bayesianinferencedl_tpu_torch.convert import full_field_from_arrays
from bayesianinferencedl_tpu_torch.infer import delayed_acceptance as tda
from bayesianinferencedl_tpu_torch.infer import lis as tl
from bayesianinferencedl_tpu_torch.infer import pcn as tp

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

M, SEED, NOISE = 16, 0, 1e-2


@pytest.fixture(scope="module")
def pair():
    jpipe = j_build(resolution=1, dtype=jnp.float64, n_features=M, n_snapshots=32, basis_size=6,
                    k_basis_size=16, n_train=64, surrogate_hidden=(16, 16), surrogate_steps=40,
                    cg_tol=1e-12, cg_maxiter=3000, seed=SEED)
    kw, kb = jax.random.split(jax.random.PRNGKey(SEED))  # as RandomField.create draws W and b
    arrays = {"features": np.asarray(jpipe.field.features),
              "rff_W": np.asarray(jax.random.normal(kw, (2, M)) / jpipe.ell),
              "rff_b": np.asarray(jax.random.uniform(kb, (M,), maxval=2 * jnp.pi)),
              "G": np.asarray(jpipe.op.G), "P0": np.asarray(jpipe.P0),
              "rom_pcg_iters": jpipe.rom_pcg_iters}
    arrays.update({f: np.asarray(getattr(jpipe.rom, f)) for f in ("W", "Ahat", "Mhat", "Fhat", "Bhat", "V")})
    for i, (W, b) in enumerate(jpipe.surrogate.params):
        arrays[f"W{i}"], arrays[f"b{i}"] = np.asarray(W), np.asarray(b)
    arrays.update({f: np.asarray(getattr(jpipe.surrogate.norm, f))
                   for f in ("x_mean", "x_std", "y_mean", "y_std")})
    pipe = full_field_from_arrays(arrays, resolution=1, ell=jpipe.ell, sigma=jpipe.field.sigma,
                                  seed=SEED, cg_tol=1e-12, cg_maxiter=3000, device="cpu",
                                  dtype=torch.float64)
    return jpipe, pipe


def test_carried_field_recomputes_the_features(pair):
    """W and b carried with the features give the features back (the mid
    rung of MLDA evaluates them on another mesh)."""
    from bayesianinferencedl_tpu_torch.models.full_field import RandomField

    jpipe, pipe = pair
    f = pipe.field
    g = RandomField.from_weights(pipe.mesh, pipe.op.n, f.W, f.b, sigma=f.sigma, dtype=torch.float64,
                                 device="cpu", node_ids=pipe.node_mesh_ids()[1])
    np.testing.assert_allclose(g.features.numpy(), f.features.numpy(), rtol=0, atol=1e-15)


@pytest.mark.parametrize("likelihood", ["fom", "rom", "rom_nn"])
def test_forwards_match_jax(pair, likelihood):
    jpipe, pipe = pair
    zs = np.random.default_rng(1).normal(size=(4, M))
    y_j = np.asarray(jax.vmap(jpipe.forward_fn(likelihood))(jnp.asarray(zs)))
    y_jb = np.asarray(jpipe.batched_forward_fn(likelihood)(jnp.asarray(zs)))
    z = torch.from_numpy(zs)
    for y in (pipe.batched_forward_fn(likelihood)(z),
              pipe.batched_forward_fn(likelihood, differentiable=True)(z),
              torch.stack([pipe.forward_fn(likelihood)(zz) for zz in z])):
        np.testing.assert_allclose(y.detach().numpy(), y_j, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(y_jb, y_j, rtol=1e-10, atol=1e-13)


def _data(jpipe):
    z_true = np.random.default_rng(3).normal(size=M)
    y = np.asarray(jpipe.forward_fn("fom")(jnp.asarray(z_true)))
    return y + NOISE * np.random.default_rng(4).normal(size=y.shape)


def _pcn_draws(key, shape):
    k_prop, k_acc = jax.random.split(key)
    return (np.asarray(jax.random.normal(k_prop, shape, jnp.float64)),
            np.asarray(jax.random.uniform(k_acc, shape[:-1], jnp.float64)))


def test_pcn_on_rom_nn_replays_jax(pair):
    jpipe, pipe = pair
    C, n_steps, n_burn = 8, 24, 8
    data = _data(jpipe)
    theta0 = np.random.default_rng(5).normal(size=(C, M))
    key = jax.random.PRNGKey(11)
    mj = jp.gaussian_misfit(jpipe.batched_forward_fn("rom_nn"), jnp.asarray(data), NOISE)
    rj = jp.run_pcn(mj, jpipe.prior, jnp.asarray(theta0), key, n_steps=n_steps, n_burn=n_burn,
                    beta=0.3, batched=True)
    k_burn, k_main = jax.random.split(key)
    keys = list(jax.random.split(k_burn, n_burn)) + list(jax.random.split(k_main, n_steps - n_burn))
    nrm, uni = zip(*(_pcn_draws(k, (C, M)) for k in keys))
    mt = tp.gaussian_misfit(pipe.batched_forward_fn("rom_nn"), torch.from_numpy(data), NOISE)
    rt = tp.run_pcn(mt, pipe.prior, torch.from_numpy(theta0), n_steps=n_steps, n_burn=n_burn,
                    beta=0.3, normals=torch.tensor(np.stack(nrm)), uniforms=torch.tensor(np.stack(uni)))
    np.testing.assert_allclose(rt.samples.numpy(), np.asarray(rj.samples), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(rt.accept_rate.numpy(), np.asarray(rj.accept_rate), rtol=0, atol=1e-12)


def test_da_pcn_on_fom_replays_jax(pair):
    jpipe, pipe = pair
    C, n_steps, n_burn, S = 6, 4, 2, 3
    data = _data(jpipe)
    theta0 = np.random.default_rng(6).normal(size=(C, M))
    key = jax.random.PRNGKey(12)
    rj = jda.run_da_pcn(jp.gaussian_misfit(jpipe.batched_forward_fn("fom"), jnp.asarray(data), NOISE),
                        jp.gaussian_misfit(jpipe.batched_forward_fn("rom_nn"), jnp.asarray(data), NOISE),
                        jpipe.prior, jnp.asarray(theta0), key, n_steps=n_steps, n_burn=n_burn, beta=0.3,
                        subchain=S, batched_fine=True, batched_coarse=True)
    k_burn, k_main = jax.random.split(key)
    keys = list(jax.random.split(k_burn, n_burn)) + list(jax.random.split(k_main, n_steps - n_burn))
    nrm, uni, out = [], [], []
    for k in keys:
        k_sub, k_acc = jax.random.split(k)
        d = [_pcn_draws(ks, (C, M)) for ks in jax.random.split(k_sub, S)]
        nrm.append(np.stack([a for a, _ in d]))
        uni.append(np.stack([b for _, b in d]))
        out.append(np.asarray(jax.random.uniform(k_acc, (C,), jnp.float64)))
    dt = torch.from_numpy(data)
    rt = tda.run_da_pcn(tp.gaussian_misfit(pipe.batched_forward_fn("fom"), dt, NOISE),
                        tp.gaussian_misfit(pipe.batched_forward_fn("rom_nn"), dt, NOISE), pipe.prior,
                        torch.from_numpy(theta0), n_steps=n_steps, n_burn=n_burn, beta=0.3, subchain=S,
                        normals=torch.tensor(np.stack(nrm)), uniforms=torch.tensor(np.stack(uni)),
                        outer_uniforms=torch.tensor(np.stack(out)))
    np.testing.assert_allclose(rt.samples.numpy(), np.asarray(rj.samples), rtol=1e-9, atol=1e-9)
    # a float32 count ratio either side
    np.testing.assert_allclose(rt.inner_accept_rate.numpy(), np.asarray(rj.inner_accept_rate),
                               rtol=0, atol=1e-6)


def test_lis_on_rom_nn_replays_jax(pair):
    jpipe, pipe = pair
    C, n_steps, n_burn = 8, 8, 3
    data = _data(jpipe)
    pts = np.random.default_rng(7).normal(0, 0.5, size=(2, M))
    lis_j = jl.build_lis(jpipe.forward_fn("rom_nn"), jpipe.prior, jnp.asarray(pts), NOISE)
    lis_t = tl.build_lis(pipe.batched_forward_fn("rom_nn", differentiable=True), pipe.prior,
                         torch.from_numpy(pts), NOISE)
    assert lis_t.rank == lis_j.rank
    np.testing.assert_allclose(lis_t.lam.numpy(), np.asarray(lis_j.lam), rtol=1e-8)
    # the chains on JAX's subspace, so that only the sampler is compared
    lis = tl.LIS(V=torch.tensor(np.asarray(lis_j.V)), lam=torch.tensor(np.asarray(lis_j.lam)))
    theta0 = np.random.default_rng(8).normal(size=(C, M))
    key = jax.random.PRNGKey(13)
    mj = jp.gaussian_misfit(jpipe.forward_fn("rom_nn"), jnp.asarray(data), NOISE)
    rj = jl.run_lis_pcn(mj, jpipe.prior, lis_j, jnp.asarray(theta0), key, n_steps=n_steps, n_burn=n_burn)
    k_burn, k_main = jax.random.split(key)
    keys = list(jax.random.split(k_burn, n_burn)) + list(jax.random.split(k_main, n_steps - n_burn))
    nrm, uni = zip(*(_pcn_draws(k, (C, M)) for k in keys))
    mt = tp.gaussian_misfit(pipe.batched_forward_fn("rom_nn"), torch.from_numpy(data), NOISE)
    rt = tl.run_lis_pcn(mt, pipe.prior, lis, torch.from_numpy(theta0), n_steps=n_steps, n_burn=n_burn,
                        normals=torch.tensor(np.stack(nrm)), uniforms=torch.tensor(np.stack(uni)))
    np.testing.assert_allclose(rt.samples.numpy(), np.asarray(rj.samples), rtol=1e-9, atol=1e-9)
