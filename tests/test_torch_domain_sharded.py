"""The port's domain-decomposed FOM solve (parallel/domain.py) on the CPU: one
gloo world of 4 ranks (two interior, so both halo directions run), started
once for the file, splits the res1 grid's X axis (torch_parallel_ranks.
domain_checks). Held against the reference's solve_fom_domain_sharded on a
4-device mesh (1e-8, iteration counts within 1), the port's SciPy oracle
(1e-8) and, for the nodal operator, the single-device solve."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_ranks import domain_checks

from bayesianinferencedl_tpu_torch.parallel.mesh import launch

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

K_TEST = np.array([0.4, 1.7, 3.1, 0.9, 1.2])


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    d = tmp_path_factory.mktemp("domain")
    launch(domain_checks, 4, str(d), device="cpu")
    with np.load(d / "domain.npz") as z:
        return dict(z)


@pytest.fixture(scope="module")
def jax_op(mesh_r1):
    from bayesianinferencedl_tpu.fem.dia import StencilOperator, assemble_fin_dia

    host = assemble_fin_dia(mesh_r1, pad_to=128)
    return host, StencilOperator.from_host(host, biot=0.1, dtype=jnp.float64)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("tol", (1e-12, 1e-7))
def test_domain_solve_matches_reference(got, jax_op, tol):
    from bayesianinferencedl_tpu.parallel import device_mesh
    from bayesianinferencedl_tpu.parallel.domain import solve_fom_domain_sharded

    _, op = jax_op
    u_j, it_j = solve_fom_domain_sharded(device_mesh(4), op, jnp.asarray(K_TEST), tol=tol, maxiter=4000)
    u, it = (got["u"], got["iters"]) if tol == 1e-12 else (got["u7"], got["iters7"])
    assert abs(int(it) - int(it_j)) <= 1, (int(it), int(it_j))
    assert _rel(u, np.asarray(u_j)) < (1e-8 if tol == 1e-12 else 1e-5)


def test_domain_solve_matches_scipy_oracle(got):
    from bayesianinferencedl_tpu_torch.fem.oracle import solve
    from bayesianinferencedl_tpu_torch.geometry import build_fin_mesh
    from bayesianinferencedl_tpu_torch.infer.oed import mesh_node_grid_ids

    mesh = build_fin_mesh(1)
    u_ref = solve(mesh, K_TEST, 0.1)
    assert _rel(got["u"][mesh_node_grid_ids(mesh)], u_ref) < 1e-8


def test_domain_solve_nonaffine_matches_single_device(got, mesh_r1):
    from bayesianinferencedl_tpu.fem.dia import StencilOperator, assemble_fin_dia
    from bayesianinferencedl_tpu.fem.dia_nonaffine import NodalStencilOperator, assemble_nodal_coeff
    from bayesianinferencedl_tpu.fem.solve import solve_fom

    host = assemble_fin_dia(mesh_r1, pad_to=128)
    op = NodalStencilOperator(base=StencilOperator.from_host(host, biot=0.1, dtype=jnp.float64),
                              G=jnp.asarray(assemble_nodal_coeff(mesh_r1, host)))
    u_ref = np.asarray(jax.jit(lambda k: solve_fom(op, k, tol=1e-12, maxiter=4000))(jnp.asarray(got["kn"])))
    assert _rel(got["un"], u_ref) < 1e-9
    assert int(got["iters_n"]) > 0


def test_domain_solve_is_the_same_on_every_rank(got):
    assert bool(got["same_on_every_rank"])
