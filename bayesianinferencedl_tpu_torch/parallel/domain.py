"""Domain-decomposed FOM solve: the stencil operator's grid split over the
ranks of a mesh (spatial model parallelism).

The grid's X axis is padded to a multiple of 8 x the world size and split
into equal blocks of rows, one per rank. Each rank assembles its own rows
of the diagonal planes (for the affine operator from its rows of the
component planes and the five replicated k), and each matvec exchanges one
halo row with each neighbour (``mesh.halo_rows``, point-to-point), since
the stencil's X offsets are +-1. The Y offsets are rolls within a row:
their wrap-around meets only zero stencil values. The Jacobi-PCG's inner
products are all-reduced over the ranks. Like the reference's, this is
plain array code, not a kernel (``fem/solve.py`` is its single-device
counterpart); it is the path for grids larger than one card holds.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import DeviceMesh

from bayesianinferencedl_tpu_torch.ops.pcg_stencil import DIAG_SLOT, OFFSETS_2D
from bayesianinferencedl_tpu_torch.parallel.mesh import gather_rows, halo_rows, rank_of, size_of, sum_all


def _halo_matvec(mesh: DeviceMesh, vals: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The 7-point stencil matvec on the rank's (Xl, Y) block; vals (7, Xl,
    Y) the rank's planes in ``OFFSETS_2D`` order."""
    above, below = halo_rows(mesh, u)
    padded = torch.cat([above, u, below], 0)  # (Xl + 2, Y)
    Xl = u.shape[0]
    acc = torch.zeros_like(u)
    for s, (dx, dy) in enumerate(OFFSETS_2D):
        rows = padded[1 + dx:1 + dx + Xl]
        if dy:
            rows = torch.roll(rows, -dy, dims=1)
        acc = acc + vals[s] * rows
    return acc


def _pcg_sharded(mesh: DeviceMesh, vals: torch.Tensor, F: torch.Tensor, tol: float, maxiter: int):
    """Jacobi-PCG on the split grid: every rank runs the same iterations,
    its inner products all-reduced (r.z and r.r in one reduction). Returns
    (the rank's block of x, iterations)."""
    diag = vals[DIAG_SLOT]
    inv_diag = torch.where(diag != 0, 1.0 / torch.where(diag != 0, diag, torch.ones_like(diag)), 0.0)
    dot2 = lambda a, b, c, d: sum_all(mesh, torch.stack([torch.sum(a * b), torch.sum(c * d)]))
    b_nrm2 = max(float(sum_all(mesh, torch.sum(F * F))), torch.finfo(F.dtype).tiny)
    tol2 = tol * tol * b_nrm2
    x = torch.zeros_like(F)
    r = F - _halo_matvec(mesh, vals, x)
    z = inv_diag * r
    p = z
    rz, rr = dot2(r, z, r, r)
    it = 0
    while it < maxiter and float(rr) > tol2:  # one read-back an iteration
        Ap = _halo_matvec(mesh, vals, p)
        pAp = sum_all(mesh, torch.sum(p * Ap))
        alpha = torch.where(pAp > 0, rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new, rr = dot2(r, z, r, r)
        beta = torch.where(rz > 0, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it


def solve_fom_domain_sharded(mesh: DeviceMesh, op, k, *, tol: float = 1e-7, maxiter: int = 4000):
    """Solve A(k) u = F with the grid split over the mesh's ranks.

    op: ``fem.dia.StencilOperator`` (k the five conductivities; each rank
    assembles its own rows) or the nodal ``fem.dia_nonaffine.NodalStencilOperator``
    (k the nodal field; its planes need neighbouring k, so they are
    assembled whole and each rank keeps its rows). Returns (u (n,), the
    iteration count as an int32 tensor), the same on every rank."""
    n_rk, r = size_of(mesh), rank_of(mesh)
    x0, y0 = op.grid_shape0
    _, Y = op.grid_shape
    Xp = math.ceil(x0 / (8 * n_rk)) * 8 * n_rk
    Xl = Xp // n_rk
    k = torch.as_tensor(k, dtype=op.dtype, device=op.device)

    def local_planes(a):  # (n, 7[, c]) node-major -> the rank's (7[, c], Xl, Y)
        a = a[:op.n_grid]
        a = a.movedim(0, -1).reshape(*a.shape[1:], x0, y0)
        a = torch.nn.functional.pad(a, (0, Y - y0, 0, Xp - x0))
        return a[..., r * Xl:(r + 1) * Xl, :]

    F_l = local_planes(op.F_root[:, None])[0]
    if hasattr(op, "comp_vals"):
        comp = local_planes(op.comp_vals)  # (7, 5, Xl, Y)
        vals = (torch.sum(comp * k[None, :, None, None], dim=1) + op.biot * local_planes(op.ext_mass)
                + local_planes(op.fixed))
    else:
        vals = local_planes(op.vals(k))
    x_l, iters = _pcg_sharded(mesh, vals, F_l, tol, maxiter)
    u2d = gather_rows(mesh, x_l, 0)
    u = u2d[:x0, :y0].reshape(-1)
    return (torch.nn.functional.pad(u, (0, op.n - op.n_grid)),
            torch.tensor(iters, dtype=torch.int32, device=op.device))
