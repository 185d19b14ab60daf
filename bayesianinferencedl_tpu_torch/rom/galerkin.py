"""Galerkin-projected reduced operator and batched online solves.

The affine structure A(k) = sum_i k_i A_i + Bi M_ext projects exactly:
Ahat(k) = sum_i k_i (V^T A_i V) + Bi (V^T M_ext V). The projection runs once
offline in host float64; the online solves take a (C, 5) batch of
conductivities, one row per chain.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.utils.device import resolve_device
from bayesianinferencedl_tpu_torch.utils.precision import (
    TierOperand,
    check_tier,
    fp32_matmul,
    tier_matmul,
    tier_operand,
)


@dataclass(frozen=True)
class ReducedOperator:
    """Reduced affine operator. Shapes: Ahat (5, r, r), Mhat (r, r),
    Fhat (r,), Bhat (n_obs, r), V (n, r)."""

    Ahat: torch.Tensor
    Mhat: torch.Tensor
    Fhat: torch.Tensor
    Bhat: torch.Tensor
    V: torch.Tensor
    biot: float

    @property
    def r(self) -> int:
        return self.Ahat.shape[-1]

    @classmethod
    def project_host(cls, host, biot: float, V, dtype=torch.float32, device="cuda") -> "ReducedOperator":
        """Exact float64 projection on the host (``host`` is a FinFEMDiaHost),
        cast to the online dtype and device (the card unless the caller asks
        for "cpu")."""
        device = resolve_device(device)
        comps, M_ext = host.to_scipy_components()
        V = np.asarray(V, np.float64)
        Ahat = np.stack([V.T @ (A @ V) for A in comps])
        Mhat = V.T @ (M_ext @ V)
        Fhat = V.T @ np.asarray(host.F_root, np.float64)
        Bhat = np.asarray(host.qoi, np.float64) @ V
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return cls(Ahat=t(Ahat), Mhat=t(Mhat), Fhat=t(Fhat), Bhat=t(Bhat), V=t(V), biot=float(biot))

    def _k(self, ks) -> torch.Tensor:
        return torch.as_tensor(ks, dtype=self.Ahat.dtype, device=self.Ahat.device)

    def assemble(self, ks: torch.Tensor) -> torch.Tensor:
        """(C, 5) -> (C, r, r) reduced system matrices, by an elementwise
        contraction over the five components."""
        ks = self._k(ks)
        A = ks[:, 0, None, None] * self.Ahat[0]
        for i in range(1, self.Ahat.shape[0]):
            A = A + ks[:, i, None, None] * self.Ahat[i]
        return A + self.biot * self.Mhat

    def solve(self, ks: torch.Tensor) -> torch.Tensor:
        """Reduced solves by batched Cholesky: (C, 5) -> (C, r)."""
        L = torch.linalg.cholesky(self.assemble(ks))
        b = self.Fhat.expand(L.shape[0], -1)[:, :, None]
        return torch.cholesky_solve(b, L)[:, :, 0]

    def forward(self, ks: torch.Tensor) -> torch.Tensor:
        """G_ROM: (C, 5) -> (C, n_obs), the QoI of the lifted reduced
        solution, y_r = (B V) u_r."""
        x = self.solve(ks)
        with fp32_matmul():
            return x @ self.Bhat.T

    def preconditioner(self, k_ref=None) -> torch.Tensor:
        """Dense P0 = Ahat(k_ref)^{-1} (default k_ref = 1), the fixed
        preconditioner of :meth:`solve_pcg`, computed in host f64 and
        returned in the online dtype."""
        Ahat = self.Ahat.detach().cpu().numpy().astype(np.float64)
        Mhat = self.Mhat.detach().cpu().numpy().astype(np.float64)
        k_ref = np.ones(Ahat.shape[0]) if k_ref is None else np.asarray(k_ref, np.float64)
        A = np.tensordot(k_ref, Ahat, axes=1) + self.biot * Mhat
        return torch.as_tensor(np.linalg.inv(A), dtype=self.Ahat.dtype, device=self.Ahat.device)

    def _pcg_operands(self, ks: torch.Tensor, precision: str = "highest"):
        """The reduced operator at ks (C, 5) as the PCG applies it at the
        online tier ``precision`` (``utils.precision``): (amat, AT) with
        amat(p) = A(k) p for the whole batch, one (C, r) @ (r, 6r) tier
        product against AT = [Ahat_1^T .. Ahat_5^T | Mhat^T] plus a float32
        sum weighted by w (C, 6) = [k | biot]. The reference issues the same
        work as three products at its tier (p with k, the (5, r, r)
        contraction, Mhat p); here only the product with the operator takes
        the tier and the k-weighting stays float32."""
        C, r = ks.shape[0], self.r
        stack = torch.cat([self.Ahat, self.Mhat[None]], 0)  # (6, r, r)
        AT = tier_operand(stack.transpose(1, 2).permute(1, 0, 2).reshape(r, -1), precision)  # (r, 6r)
        w = torch.cat([ks, torch.full_like(ks[:, :1], self.biot)], 1)[:, :, None]  # (C, 6, 1)

        def amat(p):
            return torch.sum(w * tier_matmul(p, AT).view(C, -1, r), 1)

        return amat, AT

    def solve_pcg(self, ks: torch.Tensor, P0: torch.Tensor, n_iters: int = 25,
                  precision: str = "highest") -> torch.Tensor:
        """Reduced solves by preconditioned CG with a FIXED iteration count:
        (C, 5) -> (C, r). No factorisation: A(k) p for the whole batch is one
        (C, r) @ (r, 6r) matmul against [Ahat_1^T .. Ahat_5^T | Mhat^T] plus
        a weighted sum, and the preconditioner is one (C, r) @ (r, r)
        matmul; both products run at the tier ``precision`` ("highest",
        "high" or "fast", ``utils.precision.tier_matmul``), the inner
        products in float32. Not differentiable through the solve:
        ``solve_pcg_diff`` is."""
        ks = self._k(ks)
        amat, _ = self._pcg_operands(ks, precision)
        with fp32_matmul():
            return _fixed_pcg(amat, tier_operand(P0.T, precision), self.Fhat.expand(ks.shape[0], self.r),
                              n_iters)

    def solve_pcg_diff(self, ks: torch.Tensor, P0: torch.Tensor, n_iters: int = 25,
                       precision: str = "highest") -> torch.Tensor:
        """``solve_pcg``, differentiable in ks by implicit differentiation
        (``_ReducedSolve``): the same forward values, and every derivative,
        of any order, a further run of the same fixed-iteration PCG at the
        same tier."""
        ks = self._k(ks)
        return _ReducedSolve.apply(ks, self.Fhat.expand(ks.shape[0], self.r), self, P0, n_iters,
                                   precision)

    def fast_forward(self, P0: torch.Tensor, n_iters: int = 25, precision: str = "highest", *,
                     differentiable: bool = False):
        """(C, 5) -> (C, n_obs) via :meth:`solve_pcg` at the tier
        ``precision``; the likelihood kernel of the chain hot loop. The
        observation product with Bhat stays full fp32 at every tier, as the
        reference pins it. differentiable=True goes through
        :meth:`solve_pcg_diff` (the gradient samplers, the MAP and the
        Laplace Jacobian)."""
        check_tier(precision)
        solve = self.solve_pcg_diff if differentiable else self.solve_pcg

        def f(ks):
            x = solve(ks, P0, n_iters, precision)
            with fp32_matmul():
                return x @ self.Bhat.T

        return f


def _fixed_pcg(amat, P0T: TierOperand, b: torch.Tensor, n_iters: int) -> torch.Tensor:
    """x ~ A^-1 b for a batch b (C, r) by preconditioned CG with the fixed
    preconditioner P0 (given as P0^T prepared for ``tier_matmul``),
    warm-started at P0 b, ``n_iters`` iterations; the loop of the
    reference's ``pcg_solve``, with its zero guards."""

    x = tier_matmul(b, P0T)  # warm start: P0 b is already close
    res = b - amat(x)
    z = tier_matmul(res, P0T)
    p = z
    rz = torch.sum(res * z, -1)
    for _ in range(n_iters):
        Ap = amat(p)
        pAp = torch.sum(p * Ap, -1)
        alpha = (rz / torch.where(pAp != 0, pAp, 1.0))[:, None]
        x = x + alpha * p
        res = res - alpha * Ap
        z = tier_matmul(res, P0T)
        rz_new = torch.sum(res * z, -1)
        p = z + (rz_new / torch.where(rz != 0, rz, 1.0))[:, None] * p
        rz = rz_new
    return x


class _ReducedSolve(torch.autograd.Function):
    """x = A(k)^-1 b by ``_fixed_pcg``, differentiable in k and b the way
    ``lax.custom_linear_solve(symmetric=True)`` is: the backward solves
    A(k) lam = g with the same PCG at the same tier (A is symmetric) and
    returns grad_b = lam and grad_k_i = -lam . (Ahat_i x), Ahat_i x a product
    at that tier too; it never backpropagates through the
    iterations, whose reverse pass gives other gradients, and 0/0 once the
    residuals go denormal. The backward is written in differentiable ops
    and calls the Function again, so a second backward works (the full
    Hessian of ``infer.map.laplace_approximation``)."""

    @staticmethod
    def forward(ctx, ks, b, rom, P0, n_iters, precision):
        amat, _ = rom._pcg_operands(ks, precision)
        with fp32_matmul():
            x = _fixed_pcg(amat, tier_operand(P0.T, precision), b, n_iters)
        ctx.save_for_backward(ks, x)
        ctx.rom, ctx.P0, ctx.n_iters, ctx.precision = rom, P0, n_iters, precision
        return x

    @staticmethod
    def backward(ctx, g):
        ks, x = ctx.saved_tensors
        rom = ctx.rom
        lam = _ReducedSolve.apply(ks, g, rom, ctx.P0, ctx.n_iters, ctx.precision)
        grad_k = None
        if ctx.needs_input_grad[0]:
            _, AT = rom._pcg_operands(ks, ctx.precision)
            C, r = x.shape
            with fp32_matmul():
                Ax = tier_matmul(x, AT).view(C, -1, r)[:, : ks.shape[1]]  # (C, 5, r): Ahat_i x
            grad_k = -torch.sum(lam[:, None, :] * Ax, -1)
        return grad_k, lam, None, None, None, None
