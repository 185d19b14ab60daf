"""Affinized reduced-order model for the full-field (nodal-k) problem.

A(k_nodal) is linear in the nodal conductivity, so projecting k onto an
m_k-dimensional POD basis W of conductivity snapshots makes the operator
affine again, exactly whenever k lies in span(W):

    k ~ W c,   A(k) = sum_q c_q A(w_q),   Ahat(k) = sum_q c_q (V^T A(w_q) V)

The offline stage computes the (m_k, r, r) stack of projected components in
float64 on the host (the NumPy code of the JAX package's
``rom/nonaffine.py``); online, a reduced solve is the (n x m_k) coefficient
projection c = W^T k and then the five-parameter ROM's machinery with m_k
components (``rom.galerkin.ReducedOperator``: the Cholesky solve, the
fixed-iteration PCG at the online precision tiers and its implicit
derivative).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.rom.galerkin import ReducedOperator
from bayesianinferencedl_tpu_torch.utils.device import resolve_device
from bayesianinferencedl_tpu_torch.utils.precision import check_tier, fp32_matmul


def _nodal_vals_host(G: np.ndarray, offsets: np.ndarray, k: np.ndarray) -> np.ndarray:
    """float64 host mirror of NodalStencilOperator.vals (stiffness part)."""
    n, nd, _ = G.shape
    m = int(np.max(np.abs(offsets)))
    k_pad = np.pad(k, (m, m))
    vals = np.zeros((n, nd))
    for d, off in enumerate(offsets):
        vals += G[:, :, d] * k_pad[m + off: m + off + n][:, None]
    return vals


def _stencil_apply_host(vals: np.ndarray, offsets: np.ndarray, U: np.ndarray) -> np.ndarray:
    """float64 host stencil SpMV on a block of vectors U (n, r)."""
    n = vals.shape[0]
    m = int(np.max(np.abs(offsets)))
    U_pad = np.pad(U, ((m, m), (0, 0)))
    out = np.zeros_like(U)
    for s, off in enumerate(offsets):
        out += vals[:, s: s + 1] * U_pad[m + off: m + off + n]
    return out


def _host(t) -> np.ndarray:
    return np.asarray(torch.as_tensor(t).detach().cpu(), np.float64)


def _project_f64(op, G_host: np.ndarray, V: np.ndarray, W: np.ndarray):
    """float64 host projection shared by ``project_host`` and the greedy
    basis: (Ahat (m_k, r, r), Mhat (r, r), Fhat (r,), Bhat (n_obs, r))."""
    offsets = np.asarray(op.offsets)
    m_k = W.shape[1]
    Ahat = np.zeros((m_k, V.shape[1], V.shape[1]))
    for q in range(m_k):
        vals_q = _nodal_vals_host(G_host, offsets, W[:, q])
        Ahat[q] = V.T @ _stencil_apply_host(vals_q, offsets, V)
    MV = _stencil_apply_host(_host(op.ext_mass), offsets, V)
    return Ahat, V.T @ MV, V.T @ _host(op.F_root), _host(op.qoi) @ V


def greedy_basis_nonaffine(op, G_host: np.ndarray, ks: np.ndarray, S: np.ndarray, W: np.ndarray,
                           r: int, *, seed_index: int = 0):
    """Greedy state-basis selection for the affinized full-field ROM, over
    candidate fields ks (N, n) whose FOM solutions S (N, n) are already
    solved (the POD path solves them all anyway), so greedy here selects
    and never solves: each iteration projects onto the current basis (host
    f64), sweeps the full-space residual-norm indicator over every
    candidate, and admits the worst-approximated candidate's solution,
    QR-re-orthonormalised. W (n, m_k), the conductivity basis, stays fixed.

    Returns (V (n, r) float64 orthonormal, selected indices, indicator
    trace)."""
    offsets = np.asarray(op.offsets)
    biot = float(op.biot)
    ks64 = np.asarray(ks, np.float64)
    S64 = np.asarray(S, np.float64)
    N = ks64.shape[0]
    W64 = np.asarray(W, np.float64)
    F = _host(op.F_root)
    ext = _host(op.ext_mass)
    # the candidates' operator values (stiffness + Robin mass) are V-independent
    vals_all = np.stack([_nodal_vals_host(G_host, offsets, ks64[i]) + biot * ext for i in range(N)])
    C_all = ks64 @ W64  # (N, m_k) affinization coefficients

    sel = [int(seed_index)]
    indicators = [float(np.linalg.norm(F))]  # the r = 0 residual is F itself
    while len(sel) < r:
        V, _ = np.linalg.qr(S64[np.asarray(sel)].T)
        Ahat, Mhat, Fhat, _ = _project_f64(op, G_host, V, W64)
        A = np.tensordot(C_all, Ahat, axes=1) + biot * Mhat  # (N, r_i, r_i)
        u_r = np.linalg.solve(A, np.broadcast_to(Fhat, (N, Fhat.shape[0]))[..., None])[..., 0]
        lifted = u_r @ V.T  # (N, n)
        ind = np.empty(N)
        for i in range(N):
            Ax = _stencil_apply_host(vals_all[i], offsets, lifted[i][:, None])[:, 0]
            ind[i] = np.linalg.norm(F - Ax)
        # never re-select: a noise-floored indicator could re-pick a
        # candidate already in span(V) and degenerate the basis
        ind[np.asarray(sel)] = -np.inf
        j = int(np.argmax(ind))
        if ind[j] < 1e-12 * indicators[0]:
            break  # every candidate represented: the basis is saturated
        sel.append(j)
        indicators.append(float(ind[j]))
    V, _ = np.linalg.qr(S64[np.asarray(sel)].T)
    return V, np.asarray(sel), np.asarray(indicators)


@dataclass(frozen=True)
class AffinizedReducedOperator:
    """Reduced operator of the full-field problem by k-POD affinization.

    W (n, m_k): the conductivity POD basis; Ahat (m_k, r, r); the rest as
    in ``rom.galerkin.ReducedOperator``. Every online method takes a batch
    of nodal fields k (C, n)."""

    W: torch.Tensor
    Ahat: torch.Tensor
    Mhat: torch.Tensor
    Fhat: torch.Tensor
    Bhat: torch.Tensor
    V: torch.Tensor
    biot: float

    @property
    def r(self) -> int:
        return self.Ahat.shape[-1]

    @property
    def m_k(self) -> int:
        return self.Ahat.shape[0]

    @property
    def reduced(self) -> ReducedOperator:
        """The m_k-component affine ROM the coefficients c = W^T k drive."""
        return ReducedOperator(Ahat=self.Ahat, Mhat=self.Mhat, Fhat=self.Fhat, Bhat=self.Bhat,
                               V=self.V, biot=self.biot)

    @classmethod
    def project_host(cls, op, G_host: np.ndarray, V, W, dtype=torch.float32,
                     device="cuda") -> "AffinizedReducedOperator":
        """Exact float64 offline projection (op: the NodalStencilOperator),
        cast to the online dtype on ``device`` (the card unless the caller
        asks for "cpu")."""
        dev = resolve_device(device)
        V = np.asarray(V, np.float64)
        W = np.asarray(W, np.float64)
        Ahat, Mhat, Fhat, Bhat = _project_f64(op, G_host, V, W)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        return cls(W=t(W), Ahat=t(Ahat), Mhat=t(Mhat), Fhat=t(Fhat), Bhat=t(Bhat), V=t(V),
                   biot=float(op.biot))

    # --- online --------------------------------------------------------------
    def coeffs(self, k_nodal: torch.Tensor) -> torch.Tensor:
        """c = W^T k, (..., n) -> (..., m_k), in full fp32."""
        k = torch.as_tensor(k_nodal, dtype=self.W.dtype, device=self.W.device)
        with fp32_matmul():
            return k @ self.W

    def assemble(self, c: torch.Tensor) -> torch.Tensor:
        """(C, m_k) coefficients -> (C, r, r) reduced system matrices."""
        return self.reduced.assemble(c)

    def solve(self, k_nodal: torch.Tensor) -> torch.Tensor:
        """Reduced solves by batched Cholesky: (C, n) -> (C, r)."""
        return self.reduced.solve(self.coeffs(k_nodal))

    def forward(self, k_nodal: torch.Tensor) -> torch.Tensor:
        """G_ROM: nodal conductivities (C, n) -> QoI observables (C, n_obs)."""
        return self.reduced.forward(self.coeffs(k_nodal))

    def forward_batch(self, ks: torch.Tensor) -> torch.Tensor:
        return self.forward(ks)

    def preconditioner(self, c_ref) -> torch.Tensor:
        """P0 = Ahat(c_ref)^{-1} in host f64, in the online dtype."""
        return self.reduced.preconditioner(_host(c_ref))

    def fast_forward(self, P0: torch.Tensor, n_iters: int = 25, precision: str = "highest", *,
                     differentiable: bool = False):
        """(C, n) nodal conductivities -> (C, n_obs) by the fixed-iteration
        preconditioned CG of ``ReducedOperator.solve_pcg`` at the online
        tier ``precision`` on the coefficients; differentiable=True through
        its implicit derivative (``solve_pcg_diff``)."""
        check_tier(precision)
        ff = self.reduced.fast_forward(P0, n_iters, precision, differentiable=differentiable)
        return lambda k_nodal: ff(self.coeffs(k_nodal))

    def residual_norm(self, op, k_nodal: torch.Tensor) -> torch.Tensor:
        """||F - A(k) V u_r(k)|| over a batch (C, n) -> (C,): the full-space
        error indicator."""
        red = self.reduced
        lifted = red.lift(self.solve(k_nodal))
        return torch.linalg.norm(op.F_root - op.apply(k_nodal, lifted), dim=-1)
