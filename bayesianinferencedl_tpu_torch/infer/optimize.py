"""The reference's own BFGS minimiser, for MAP estimation, over a batch of
starts.

Dense-inverse BFGS with Armijo backtracking, as in the JAX package, whose
``minimize_bfgs`` vmaps a ``lax.while_loop`` (with an inner backtracking
``while_loop``) over the starts. Here the starts are one batch run by one
masked loop, which is what the vmapped loops compute: every start keeps its
own iteration count and its own line-search count, a start that has
finished is frozen while the others iterate, and a start whose line search
has ended keeps its step while the others halve theirs. The dimension is
tiny (5), so the d x d inverse-Hessian update is the right tool.

``fun`` is batched: (S, d) -> (S,), one row per start, rows independent.
Its gradients come from autograd.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul


class BFGSResult(NamedTuple):
    x: torch.Tensor  # (S, d), or (d,) for a (d,) start
    fun: torch.Tensor  # (S,)
    grad_norm: torch.Tensor  # (S,)
    n_iter: torch.Tensor  # (S,) int32
    converged: torch.Tensor  # (S,) bool


def value_and_grad(fun: Callable, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(fun(x), d fun / dx) for a batched fun: (S, d) -> (S,); row s of the
    gradient is start s's, since the rows are independent. The forward and
    the backward run in full fp32."""
    with torch.enable_grad(), fp32_matmul():
        x = x.detach().requires_grad_()
        f = fun(x)
        (g,) = torch.autograd.grad(torch.sum(f), x)
    return f.detach(), g


def minimize_bfgs(
    fun: Callable,
    x0: torch.Tensor,
    *,
    maxiter: int = 200,
    gtol: float = 1e-8,
    max_ls: int = 25,
) -> BFGSResult:
    """Minimise a batched ``fun`` from the starts x0 (S, d), or from one
    start (d,) (then every field drops the start axis). Each start stops
    at ||g|| <= gtol or after maxiter iterations. The guards are the
    reference's: the NaN-safe Armijo test (a non-finite trial value is "not
    sufficient", so backtracking goes on), steepest descent where the BFGS
    direction is not a descent direction, a step taken only where f is
    finite and does not increase, the (s.y / y.y) I scaling before the first
    update, and an update only under the curvature guard
    s.y > 1e-12 ||s|| ||y|| + tiny."""
    single = x0.dim() == 1
    x = x0[None] if single else x0
    S, d = x.shape
    dtype, dev = x.dtype, x.device
    tiny = torch.finfo(dtype).tiny
    c1 = 1e-4
    f, g = value_and_grad(fun, x)
    eye = torch.eye(d, dtype=dtype, device=dev)
    H = eye.expand(S, d, d)
    it = torch.zeros(S, dtype=torch.int32, device=dev)

    def outer(a, b):
        return a[:, :, None] * b[:, None, :]

    while True:
        active = (it < maxiter) & (torch.linalg.vector_norm(g, dim=-1) > gtol)
        if not bool(active.any()):
            break
        with fp32_matmul():
            p = -(H @ g[:, :, None])[:, :, 0]
        gp = torch.sum(g * p, -1)
        # fall back to steepest descent if p is not a descent direction
        bad = gp >= 0
        p = torch.where(bad[:, None], -g, p)
        gp = torch.where(bad, -torch.sum(g * g, -1), gp)

        # Armijo backtracking, each start on its own count; NaN/inf counts
        # as "not sufficient" (exp() in log-conductivity models overflows)
        def searching(alpha, f_try, ls):
            return (ls < max_ls) & ~(f_try <= f + c1 * alpha * gp)

        alpha = torch.ones(S, dtype=dtype, device=dev)
        with torch.no_grad():
            f_try = fun(x + alpha[:, None] * p)
        ls = torch.zeros(S, dtype=torch.int32, device=dev)
        busy = searching(alpha, f_try, ls)
        while bool(busy.any()):
            alpha = torch.where(busy, alpha * 0.5, alpha)
            with torch.no_grad():
                f_half = fun(x + alpha[:, None] * p)
            f_try = torch.where(busy, f_half, f_try)
            ls = ls + busy.to(torch.int32)
            busy = searching(alpha, f_try, ls)

        x_new = x + alpha[:, None] * p
        f_new, g_new = value_and_grad(fun, x_new)
        # keep the old iterate if the search failed to decrease f (the
        # gradient-norm condition ends things if truly stuck)
        accept = torch.isfinite(f_new) & (f_new <= f)
        sv = x_new - x
        y = g_new - g
        sy = torch.sum(sv * y, -1)
        finite = torch.isfinite(y).all(-1) & torch.isfinite(sv).all(-1)
        ok = accept & finite & (
            sy > 1e-12 * torch.linalg.vector_norm(sv, dim=-1) * torch.linalg.vector_norm(y, dim=-1)
            + tiny)
        # classic first-update scaling: H <- (s.y / y.y) I before the update
        first = it == 0
        yy = torch.sum(y * y, -1)
        scale = sy / torch.where(yy > 0, yy, 1.0)
        H_base = torch.where((first & ok)[:, None, None], scale[:, None, None] * eye, H)
        rho = torch.where(ok, 1.0 / torch.where(ok, sy, 1.0), 0.0)
        A = eye - rho[:, None, None] * outer(sv, y)
        with fp32_matmul():
            H_new = A @ H_base @ A.transpose(1, 2) + rho[:, None, None] * outer(sv, sv)
        H_new = torch.where(ok[:, None, None], H_new, H)

        take = active & accept  # frozen starts keep everything
        x = torch.where(take[:, None], x_new, x)
        f = torch.where(take, f_new, f)
        g = torch.where(take[:, None], g_new, g)
        H = torch.where(active[:, None, None], H_new, H)
        it = it + active.to(torch.int32)

    gn = torch.linalg.vector_norm(g, dim=-1)
    out = BFGSResult(x=x, fun=f, grad_norm=gn, n_iter=it, converged=gn <= gtol)
    return BFGSResult(*(a[0] for a in out)) if single else out
