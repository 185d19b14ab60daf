"""The differentiable reduced solve of the port (rom/galerkin.py
``solve_pcg_diff``, reached through ``Pipeline.batched_forward_fn(...,
differentiable=True)``) against the JAX reference's custom_linear_solve, on
JAX pipelines carried over by convert.pipeline_from_arrays:

- the rom_nn misfit's gradient and Hessian against jax.grad and jax.hessian,
  to 1e-5 relative on a float32 res2 pipeline and to 1e-10 on a float64 res1
  one; the values equal the hot-loop route's;
- the Gauss-Newton Laplace factors on that route (the Jacobian by reverse
  rows) against JAX's (jacfwd), at the same tolerances;
- tests/test_map_laplace.py's MAP-on-ROM case on the float64 pipeline."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu import config as jcfg
from bayesianinferencedl_tpu.infer import map as jm
from bayesianinferencedl_tpu.infer.pcn import gaussian_misfit as j_misfit
from bayesianinferencedl_tpu_torch import config as tcfg
from bayesianinferencedl_tpu_torch.convert import pipeline_from_arrays
from bayesianinferencedl_tpu_torch.infer import map as tm
from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit as t_misfit
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior
from test_torch_slice import _arrays, jax_build

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs


def _cfg(cfg, res, tol):
    """The build configs other port test files use (test_torch_slice's float64
    res1, test_torch_approx_api's float32 res2), so their JAX builds are
    shared (``test_torch_slice.jax_build``)."""
    return cfg.PipelineConfig(
        mesh=cfg.MeshConfig(resolution=res),
        fem=cfg.FEMConfig(biot=0.1, cg_tol=tol, cg_maxiter=1500),
        rom=cfg.ROMConfig(n_snapshots=32, basis_size=8),
        surrogate=cfg.SurrogateConfig(hidden=(16, 16), n_train=64, epochs=20),
        mcmc=cfg.MCMCConfig(noise_sigma=1e-2),
    )


def _converted(res, jdtype, tdtype, tol):
    jpipe = jax_build(_cfg(jcfg, res, tol), jdtype)
    return jpipe, pipeline_from_arrays(_cfg(tcfg, res, tol), _arrays(jpipe), device="cpu", dtype=tdtype)


@pytest.fixture(scope="module")
def converted_f64():
    return _converted(1, jnp.float64, torch.float64, 1e-10)


@pytest.mark.parametrize("case", ["float32 res2", "float64 res1"])
def test_differentiable_reduced_solve_matches_custom_linear_solve(case, request):
    if case == "float32 res2":
        jdtype, tol = jnp.float32, 1e-5
        jpipe, tpipe = _converted(2, jdtype, torch.float32, 1e-7)
    else:
        jdtype, tol = jnp.float64, 1e-10
        jpipe, tpipe = request.getfixturevalue("converted_f64")
    rng = np.random.default_rng(11)
    np_dt = np.float32 if jdtype == jnp.float32 else np.float64
    theta = rng.normal(0.0, 0.5, 5).astype(np_dt)
    data = np.asarray(jpipe.forward_fn("rom_nn")(jnp.asarray(rng.normal(0, 0.5, 5), jdtype)))
    data = (data + 1e-2 * rng.normal(size=data.shape)).astype(np_dt)
    # JAX: the per-theta forward through custom_linear_solve (each derivative
    # one compiled program, not a dispatch of every primitive)
    mj = j_misfit(jpipe.forward_fn("rom_nn"), jnp.asarray(data), 1e-2)
    gj = np.asarray(jax.jit(jax.grad(mj))(jnp.asarray(theta)))
    Hj = np.asarray(jax.jit(jax.hessian(mj))(jnp.asarray(theta)))
    fwd_t = tpipe.batched_forward_fn("rom_nn", differentiable=True)
    mt = t_misfit(fwd_t, torch.from_numpy(data), 1e-2)
    th = torch.from_numpy(theta)[None].requires_grad_()
    (gt,) = torch.autograd.grad(mt(th).sum(), th, create_graph=True)
    Ht = torch.stack([torch.autograd.grad(gt[0, i], th, retain_graph=True)[0][0] for i in range(5)])
    np.testing.assert_allclose(gt.detach().numpy()[0], gj, rtol=tol, atol=tol * np.abs(gj).max())
    np.testing.assert_allclose(Ht.numpy(), Hj, rtol=tol, atol=tol * np.abs(Hj).max())
    # the values equal the non-differentiable hot-loop route's
    ths = torch.from_numpy(rng.normal(0.0, 0.5, (6, 5)).astype(np_dt))
    np.testing.assert_array_equal(fwd_t(ths).detach(), tpipe.batched_forward_fn("rom_nn")(ths))
    # the Laplace factors on this route (Gauss-Newton: the Jacobian by
    # reverse rows against JAX's jacfwd), at theta
    lj = jm.laplace_approximation(jpipe.forward_fn("rom_nn"), jnp.asarray(data), 1e-2, jpipe.prior,
                                  jnp.asarray(theta))
    lt = tm.laplace_approximation(fwd_t, torch.from_numpy(data), 1e-2, tpipe.prior, torch.from_numpy(theta))
    for f in ("cov", "chol"):
        a, b = getattr(lt, f).numpy(), np.asarray(getattr(lj, f))
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())



def test_map_on_converted_rom_recovers_truth(converted_f64):
    """The MAP on the converted float64 ROM forward recovers the parameters
    behind clean data (the reference's MAP-on-ROM case, at noise 1e-3).
    BFGS reaches ||g|| ~ 1e-7 by its 40th iteration and then only
    backtracks, so 60 iterations stand for the reference's 500."""
    _, tpipe = converted_f64
    theta_true = torch.log(torch.tensor([1.2, 0.6, 2.0, 0.8, 1.5], dtype=torch.float64))
    fwd = tpipe.batched_forward_fn("rom", differentiable=True)
    data = fwd(theta_true[None])[0].detach()
    prior = TPrior.iid(5, mean=0.0, sigma=1.0, dtype=torch.float64, device="cpu")
    theta_map, _ = tm.find_map(t_misfit(fwd, data, 1e-3), prior, torch.zeros(5, dtype=torch.float64),
                               maxiter=60)
    np.testing.assert_allclose(theta_map.numpy(), theta_true.numpy(), atol=0.05)
