"""Hand-coded adjoint gradient and Gauss-Newton HVP: the test oracle.

The production derivatives are autograd through ``fem/solve.py``'s
adjoint-solve backward; this module derives the adjoint explicitly, so the
two can be held against each other (on the card as on the CPU). Either
operator layout works: both give ``apply_component``.

Math: J(k) = 1/(2 s^2) ||B u(k) - d||^2 with A(k) u = F.
  adjoint solve:   A(k) p = -B^T (B u - d) / s^2      (A symmetric)
  gradient:        dJ/dk_i = p^T A_i u
  GN HVP:          v -> J_G^T J_G v / s^2 with J_G v = -B A^{-1} (A_v u),
                   A_v = sum_i v_i A_i  (an incremental forward/adjoint pair)

k may carry leading batch dimensions, (..., 5).
"""

from __future__ import annotations

import torch

from bayesianinferencedl_tpu_torch.fem.solve import solve_fom
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul


def _components(op, u: torch.Tensor) -> list[torch.Tensor]:
    return [op.apply_component(i, u) for i in range(op.comp_vals.shape[2])]


@torch.no_grad()
def adjoint_gradient(op, k, data, noise_sigma, *, tol=1e-12, maxiter=4000) -> torch.Tensor:
    """Explicit adjoint-method gradient of the data misfit with respect to k (..., 5)."""
    k = torch.as_tensor(k, dtype=op.dtype, device=op.device)
    data = torch.as_tensor(data, dtype=op.dtype, device=op.device)
    u = solve_fom(op, k, tol=tol, maxiter=maxiter)
    misfit = (op.observe(u) - data) / noise_sigma**2
    with fp32_matmul():
        rhs = -(misfit @ op.qoi)
    p = solve_fom(op, k, F=rhs, tol=tol, maxiter=maxiter)
    return torch.stack([torch.sum(p * Au, -1) for Au in _components(op, u)], -1)


@torch.no_grad()
def adjoint_gn_hvp(op, k, v, noise_sigma, *, tol=1e-12, maxiter=4000) -> torch.Tensor:
    """Explicit Gauss-Newton Hessian-vector product: one incremental forward
    solve and one incremental adjoint solve."""
    k = torch.as_tensor(k, dtype=op.dtype, device=op.device)
    v = torch.as_tensor(v, dtype=op.dtype, device=op.device)
    u = solve_fom(op, k, tol=tol, maxiter=maxiter)
    Au = _components(op, u)
    # incremental forward: A du = -A_v u
    Av_u = sum(v[..., i, None] * Aiu for i, Aiu in enumerate(Au))
    du = solve_fom(op, k, F=-Av_u, tol=tol, maxiter=maxiter)
    Jv = op.observe(du)  # dG/dk . v
    # (J^T y)_i = -(A_i u)^T A^-1 B^T y, with y = J v / s^2
    with fp32_matmul():
        rhs_w = (Jv / noise_sigma**2) @ op.qoi
    w = solve_fom(op, k, F=rhs_w, tol=tol, maxiter=maxiter)
    return torch.stack([-torch.sum(Aiu * w, -1) for Aiu in Au], -1)
