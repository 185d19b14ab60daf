"""Batched Jacobi-PCG FOM solve, differentiable in k and F.

The counterpart of the JAX package's ``fem/solve.py``, in plain torch: the
JAX code is XLA, not a kernel, so this is its port on the card as on the
CPU.

- ``pcg`` runs over a leading batch dimension and freezes each sample once
  it has converged, which is what a vmapped ``lax.while_loop`` does: every
  sample sees exactly its own run.
- ``solve_fom`` is a ``torch.autograd.Function`` whose backward is one
  adjoint solve with the same PCG (A(k) is symmetric), the convention of
  ``lax.custom_linear_solve(symmetric=True)``: it never backpropagates
  through the iterations. The backward is written with differentiable ops
  and calls the Function again, so a second backward gives Hessian-vector
  products. It serves the affine operator (k of shape (..., 5)).
- ``solve_vals`` is the same solve on assembled planes vals (..., n, 7),
  with the adjoint at the level of the planes:
  dL/dvals[i, s] = -lam_i u[i + off_s]. Autograd carries it on through
  whatever assembled the planes, so the nodal operator
  (``fem/dia_nonaffine.py``), whose planes are a stencil of the nodal field
  k, is differentiable in k through it. ``solve_fom`` takes that route for
  an operator that is not affine.
- ``refine_steps`` adds iterative-refinement passes to every solve (the
  adjoint's too): the residual F - A x in float64, the correction solved
  in the working dtype and added in float64, as the JAX package does.

The f64 route of ``api.make_fom_solver`` and ``FiveParamFin.solve`` run
here; the batched f32 sweeps go through the stencil kernels
(``ops/pcg_stencil.py``).
"""

from __future__ import annotations

import torch


def pcg(matvec, b: torch.Tensor, diag: torch.Tensor, *, tol: float = 1e-10, maxiter: int = 2000,
        x0: torch.Tensor | None = None):
    """Jacobi-preconditioned CG for SPD systems over a batch (..., n).

    Stops each sample at ||r|| <= tol ||b|| or at maxiter iterations.
    Returns (x (..., n), iters (...) int32, relres (...)). matvec maps
    (..., n) to (..., n); diag broadcasts against b."""
    dt = b.dtype
    inv_diag = torch.where(diag != 0, 1.0 / torch.where(diag != 0, diag, torch.ones_like(diag)), 0.0)
    inv_diag = inv_diag.to(dt)
    x = torch.zeros_like(b) if x0 is None else x0 + torch.zeros_like(b)
    r = b - matvec(x)
    z = inv_diag * r
    p = z
    rz = torch.sum(r * z, -1)
    b_nrm2 = torch.clamp(torch.sum(b * b, -1), min=torch.finfo(dt).tiny)
    tol2 = torch.tensor(tol, dtype=dt, device=b.device) ** 2 * b_nrm2
    iters = torch.zeros(rz.shape, dtype=torch.int32, device=b.device)
    for _ in range(maxiter):
        active = torch.sum(r * r, -1) > tol2
        if not bool(active.any()):
            break
        Ap = matvec(p)
        pAp = torch.sum(p * Ap, -1)
        alpha = torch.where(pAp > 0, rz / torch.where(pAp > 0, pAp, 1.0), 0.0)
        a = active[..., None]
        x = torch.where(a, x + alpha[..., None] * p, x)
        r = torch.where(a, r - alpha[..., None] * Ap, r)
        z = inv_diag * r
        rz_new = torch.sum(r * z, -1)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0), 0.0)
        p = torch.where(a, z + beta[..., None] * p, p)
        rz = torch.where(active, rz_new, rz)
        iters = iters + active.to(torch.int32)
    relres = torch.sqrt(torch.sum(r * r, -1) / b_nrm2)
    return x, iters, relres


def pcg_fom(op, k: torch.Tensor, F: torch.Tensor, *, tol: float, maxiter: int,
            x0: torch.Tensor | None = None):
    """``pcg`` on the flat stencil operator A(k) of ``op``: k (..., 5) (or
    the nodal field (..., n) of a nodal operator), F broadcasting to
    (..., n), x0 optional warm starts. Returns (x, iters, relres); not
    differentiable (``solve_fom`` is)."""
    return pcg_vals(op, op.vals(k), F, tol=tol, maxiter=maxiter, x0=x0)


def pcg_vals(op, vals: torch.Tensor, F: torch.Tensor, *, tol: float, maxiter: int,
             x0: torch.Tensor | None = None, refine_steps: int = 0):
    """``pcg`` on assembled planes vals (..., n, 7), then ``refine_steps``
    refinement passes with the residual in float64. Returns (x, iters,
    relres) of the first solve."""
    vals = vals.detach()
    diag = op.diag(vals)
    x, iters, relres = pcg(lambda v: op.matvec(vals, v), F, diag, tol=tol, maxiter=maxiter, x0=x0)
    if refine_steps:
        vals64 = vals.to(torch.float64)
        for _ in range(refine_steps):
            r = F.to(torch.float64) - op.matvec(vals64, x.to(torch.float64))
            dx, _, _ = pcg(lambda v: op.matvec(vals, v), r.to(F.dtype), diag, tol=tol,
                           maxiter=maxiter)
            x = (x.to(torch.float64) + dx.to(torch.float64)).to(F.dtype)
    return x, iters, relres


class _Solve(torch.autograd.Function):
    """x = A(k)^-1 F with an adjoint-solve backward (see module docstring)."""

    @staticmethod
    def forward(ctx, k, F, op, tol, maxiter, refine_steps=0):
        x, _, _ = pcg_vals(op, op.vals(k), F, tol=tol, maxiter=maxiter, refine_steps=refine_steps)
        ctx.save_for_backward(k, x)
        ctx.op, ctx.tol, ctx.maxiter, ctx.refine_steps = op, tol, maxiter, refine_steps
        return x

    @staticmethod
    def backward(ctx, g):
        k, x = ctx.saved_tensors
        op = ctx.op
        # A symmetric: the adjoint system is A(k) lam = g
        lam = _Solve.apply(k, g, op, ctx.tol, ctx.maxiter, ctx.refine_steps)
        grad_k = None
        if ctx.needs_input_grad[0]:
            # dx = -A^-1 (dA/dk_i) x dk_i: grad_k_i = -lam . (A_i x)
            comps = op.comp_vals.shape[2]
            grad_k = -torch.stack(
                [torch.sum(lam * op.matvec(op.comp_vals[:, :, i], x), -1) for i in range(comps)], -1
            )
        return grad_k, lam, None, None, None, None


def _shifted(op, u: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., n, 7): u[i + off_s] at [i, s], zero off the grid,
    the factor of vals[i, s] in ``op.matvec``."""
    m = op.max_offset
    u_pad = torch.nn.functional.pad(u, (m, m))
    return torch.stack([u_pad[..., m + off: m + off + op.n] for off in op.offsets], -1)


class _SolveVals(torch.autograd.Function):
    """x = A(vals)^-1 F with the planes-level adjoint (module docstring)."""

    @staticmethod
    def forward(ctx, vals, F, op, tol, maxiter, refine_steps):
        x, _, _ = pcg_vals(op, vals, F, tol=tol, maxiter=maxiter, refine_steps=refine_steps)
        ctx.save_for_backward(vals, x)
        ctx.op, ctx.args = op, (tol, maxiter, refine_steps)
        return x

    @staticmethod
    def backward(ctx, g):
        vals, x = ctx.saved_tensors
        op = ctx.op
        lam = _SolveVals.apply(vals, g, op, *ctx.args)  # A symmetric
        grad_vals = None
        if ctx.needs_input_grad[0]:
            grad_vals = -lam[..., :, None] * _shifted(op, x)
        return grad_vals, lam, None, None, None, None


def solve_vals(op, vals: torch.Tensor, F: torch.Tensor | None = None, *, tol: float = 1e-8,
               maxiter: int = 2000, refine_steps: int = 0) -> torch.Tensor:
    """Solve A(vals) u = F for planes vals (..., n, 7), differentiable in
    vals and F; F defaults to ``op.F_root``."""
    F = op.F_root if F is None else torch.as_tensor(F, dtype=op.dtype, device=op.device)
    F = F.expand(*vals.shape[:-2], op.n)
    return _SolveVals.apply(vals, F, op, tol, maxiter, refine_steps)


def solve_fom(op, k: torch.Tensor, F: torch.Tensor | None = None, *, tol: float = 1e-8,
              maxiter: int = 2000, refine_steps: int = 0) -> torch.Tensor:
    """Solve A(k) u = F for k (5,) or (B, 5), differentiable in k and F.
    F defaults to the root load ``op.F_root``; a batch of k broadcasts it.
    A nodal operator takes k (n,) or (B, n), through ``solve_vals``."""
    k = torch.as_tensor(k, dtype=op.dtype, device=op.device)
    if getattr(op, "nodal", False):
        return solve_vals(op, op.vals(k), F, tol=tol, maxiter=maxiter, refine_steps=refine_steps)
    F = op.F_root if F is None else torch.as_tensor(F, dtype=op.dtype, device=op.device)
    F = F.expand(*k.shape[:-1], op.n)
    return _Solve.apply(k, F, op, tol, maxiter, refine_steps)


def forward(op, k: torch.Tensor, **kw) -> torch.Tensor:
    """G_FOM: k -> QoI observables y = B u(k)."""
    return op.observe(solve_fom(op, k, **kw))


def solve_fom_batch(op, ks: torch.Tensor, **kw) -> torch.Tensor:
    """FOM solves over a batch (B, 5) -> (B, n); the batch is the leading
    dimension of ``solve_fom``."""
    return solve_fom(op, ks, **kw)
