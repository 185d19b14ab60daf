"""The port's stencil FEM (bayesianinferencedl_tpu_torch.fem) against the JAX
reference: host assembly exactly, and the torch StencilOperator's vals,
matvec and observe in float64 to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.fem import dia as jdia
from bayesianinferencedl_tpu_torch.fem import dia as tdia

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

FIELDS = ("offsets", "comp_vals", "ext_mass", "fixed", "F_root", "qoi", "qoi_root")


@pytest.fixture(scope="module", params=[1, 2], ids=["res1", "res2"])
def hosts(request, mesh_r1, mesh_r2):
    mesh = {1: mesh_r1, 2: mesh_r2}[request.param]
    return jdia.assemble_fin_dia(mesh, pad_to=128), tdia.assemble_fin_dia(mesh, pad_to=128)


def test_assembly_equals_reference(hosts):
    jh, th = hosts
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(th, f), getattr(jh, f), err_msg=f)
    assert (th.n_grid, th.resolution, th.n) == (jh.n_grid, jh.resolution, jh.n)


def test_operator_matches_reference_f64(hosts):
    jh, th = hosts
    jop = jdia.StencilOperator.from_host(jh, biot=0.1, dtype=jnp.float64)
    top = tdia.StencilOperator.from_host(th, biot=0.1, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(7)
    ks = np.exp(rng.uniform(np.log(0.1), np.log(10), (3, 5)))
    us = rng.normal(size=(3, th.n))
    tv = top.vals(torch.from_numpy(ks))  # batched (3, n, 7)
    for b in range(3):
        jv = np.asarray(jop.vals(jnp.asarray(ks[b], jnp.float64)))
        np.testing.assert_allclose(tv[b].numpy(), jv, rtol=1e-12, atol=1e-12)
        jmv = np.asarray(jop.matvec(jnp.asarray(jv), jnp.asarray(us[b], jnp.float64)))
        tmv = top.matvec(tv[b], torch.from_numpy(us[b])).numpy()
        np.testing.assert_allclose(tmv, jmv, rtol=1e-12, atol=1e-12)
        jo = np.asarray(jop.observe(jnp.asarray(us[b], jnp.float64)))
        np.testing.assert_allclose(top.observe(torch.from_numpy(us[b])).numpy(), jo,
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(top.diag(tv[b]).numpy(), np.asarray(jop.diag(jnp.asarray(jv))))
    # the batched matvec equals the per-sample one
    tmv_b = top.matvec(tv, torch.from_numpy(us)).numpy()
    for b in range(3):
        np.testing.assert_allclose(tmv_b[b], top.matvec(tv[b], torch.from_numpy(us[b])).numpy(),
                                   rtol=1e-14, atol=1e-14)
    assert top.resolution == jop.resolution and top.n_obs == jop.n_obs
