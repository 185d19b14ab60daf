"""Geometric multigrid-preconditioned flexible CG for the stencil FOM.

Jacobi-PCG iteration counts grow like 1/h^2 with mesh refinement. The
structured fin grid supports textbook geometric multigrid: every coarsening
step res -> res/2 is again a fin grid whose operator is assembled exactly
(the same closed-form P1 elements at the coarser resolution, no Galerkin
triple products), the transfers are vertex-centred full weighting and
bilinear interpolation on the (X0, Y0) planes, and the smoother is weighted
Jacobi. The coarsest level is solved by a fixed number of plain CG
iterations, which makes the preconditioner mildly nonlinear, hence the outer
iteration is flexible CG (the Polak-Ribiere beta).

Plain torch on (B, X0, Y0) plane batches, as the JAX package's version is
plain XLA outside any Pallas kernel. Off-domain grid cells carry identity
rows whose residuals vanish after one smoothing step, so the transfers need
no domain mask (multigrid is only the preconditioner; the outer FCG carries
correctness). Each sample stops at its own tolerance and is frozen while the
others iterate, as a vmapped ``lax.while_loop`` does, so its count is its
solo count.

Experimental: the batched solver on every path is the stencil kernels of
``ops/pcg_stencil.py``. Its crossover against them on an H100 (iterations,
times, solves/s at res8, res16 and res32) is the table "MG-FCG vs the
kernels on the H100" in PERF.md, measured by ``chip_smoke.py`` phase 18.

    mg = MGHierarchy.create(8, biot=0.1, dtype=torch.float32, device="cuda")
    u, iters = mg.solve(ks, tol=1e-7, maxiter=150)  # ks (B, 5) -> (B, X0, Y0), (B,)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bayesianinferencedl_tpu_torch.fem.dia import assemble_fin_dia
from bayesianinferencedl_tpu_torch.geometry.mesh import build_fin_mesh
from bayesianinferencedl_tpu_torch.ops.pcg_stencil import DIAG_SLOT, OFFSETS_2D
from bayesianinferencedl_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MGLevel:
    """One grid level: affine stencil planes on the logical (X0, Y0) grid.

    comp (5, 7, X0, Y0), ext (7, X0, Y0), fixed (7, X0, Y0), F (X0, Y0)."""

    comp: torch.Tensor
    ext: torch.Tensor
    fixed: torch.Tensor
    F: torch.Tensor
    shape: Tuple[int, int]

    def vals(self, k: torch.Tensor, biot: float) -> torch.Tensor:
        """(B, 5) conductivities -> (B, 7, X0, Y0) planes of A(k)."""
        k = torch.as_tensor(k, dtype=self.comp.dtype, device=self.comp.device)
        kk = k[:, :, None, None, None]
        acc = kk[:, 0] * self.comp[0]
        for i in range(1, self.comp.shape[0]):
            acc = acc + kk[:, i] * self.comp[i]
        return acc + biot * self.ext + self.fixed


def _planes_from_host(host, dtype, device) -> MGLevel:
    """The level of a stencil host (``fem/dia.assemble_fin_dia``) as planes."""
    y0 = int(host.offsets[-2])  # the ny + 1 offset, Y0
    x0 = host.n_grid // y0

    def to_planes(a):  # (n, 7[, c]) -> (7[, c], X0, Y0)
        a = a[: host.n_grid]
        return torch.as_tensor(np.moveaxis(a.reshape(x0, y0, *a.shape[1:]), (0, 1), (-2, -1)),
                               dtype=dtype, device=device)

    return MGLevel(
        comp=to_planes(host.comp_vals).transpose(0, 1).contiguous(),  # (5, 7, X0, Y0)
        ext=to_planes(host.ext_mass),
        fixed=to_planes(host.fixed),
        F=torch.as_tensor(host.F_root[: host.n_grid].reshape(x0, y0), dtype=dtype, device=device),
        shape=(x0, y0),
    )


def stencil_apply(vals: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """7-point stencil matvec on (B, X0, Y0) planes (zero-padded boundary):
    vals (B, 7, X0, Y0)."""
    X, Y = u.shape[-2:]
    up = F.pad(u, (1, 1, 1, 1))
    acc = torch.zeros_like(u)
    for s, (dx, dy) in enumerate(OFFSETS_2D):
        acc = acc + vals[:, s] * up[:, 1 + dx: 1 + dx + X, 1 + dy: 1 + dy + Y]
    return acc


def restrict(r: torch.Tensor) -> torch.Tensor:
    """Vertex-centred full weighting: fine (B, 2Xc-1, 2Yc-1) -> coarse (B, Xc, Yc)."""
    X, Y = r.shape[-2:]
    rp = F.pad(r, (1, 1, 1, 1))
    acc = None
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            # separable full weighting: w(0) = 1/2, w(+-1) = 1/4 per axis
            wgt = (0.5 if dx == 0 else 0.25) * (0.5 if dy == 0 else 0.25)
            term = wgt * rp[:, 1 + dx: 1 + dx + X: 2, 1 + dy: 1 + dy + Y: 2]
            acc = term if acc is None else acc + term
    return acc


def prolong(e: torch.Tensor, fine_shape: Tuple[int, int]) -> torch.Tensor:
    """Bilinear interpolation: coarse (B, Xc, Yc) -> fine (B, 2Xc-1, 2Yc-1)."""
    B, Xc, Yc = e.shape
    rows = e.new_zeros((B, 2 * Xc - 1, Yc))
    rows[:, ::2] = e
    rows[:, 1::2] = 0.5 * (e[:, :-1] + e[:, 1:])
    out = e.new_zeros((B, 2 * Xc - 1, 2 * Yc - 1))
    out[:, :, ::2] = rows
    out[:, :, 1::2] = 0.5 * (rows[:, :, :-1] + rows[:, :, 1:])
    return out


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-sample inner product of (B, X, Y) planes -> (B, 1, 1)."""
    return torch.sum(a * b, (-2, -1), keepdim=True)


@dataclasses.dataclass(frozen=True)
class MGHierarchy:
    levels: Tuple[MGLevel, ...]  # fine -> coarse
    biot: float
    nu_pre: int = 2
    nu_post: int = 2
    coarse_iters: int = 40
    omega: float = 0.8

    @classmethod
    def create(cls, resolution: int, biot: float, dtype=torch.float32, device="cuda",
               **kw) -> "MGHierarchy":
        """Levels at resolution, resolution/2, ..., down to an odd one or 1,
        on ``device`` (the card unless the caller asks for "cpu")."""
        device = resolve_device(device)
        levels = []
        res = resolution
        while True:
            host = assemble_fin_dia(build_fin_mesh(res), pad_to=8)
            levels.append(_planes_from_host(host, dtype, device))
            if res % 2 != 0 or res == 1:
                break
            res //= 2
        return cls(levels=tuple(levels), biot=float(biot), **kw)

    # --- components ---------------------------------------------------------
    def _smooth(self, vals, inv_diag, b, x, nu):
        for _ in range(nu):
            x = x + self.omega * inv_diag * (b - stencil_apply(vals, x))
        return x

    def _coarse_solve(self, vals, inv_diag, b):
        """Fixed-iteration Jacobi-PCG on the coarsest grid."""
        x = torch.zeros_like(b)
        r = b
        p = inv_diag * r
        rz = _dot(r, p)
        for _ in range(self.coarse_iters):
            Ap = stencil_apply(vals, p)
            pAp = _dot(p, Ap)
            alpha = rz / torch.where(pAp != 0, pAp, 1.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = inv_diag * r
            rz_n = _dot(r, z)
            beta = rz_n / torch.where(rz != 0, rz, 1.0)
            p = z + beta * p
            rz = rz_n
        return x

    def v_cycle(self, vals_per_level, b):
        """One V-cycle application M^-1 b on the finest grid, b (B, X0, Y0)."""

        def vc(lev: int, b):
            vals = vals_per_level[lev]
            diag = vals[:, DIAG_SLOT]
            inv_diag = torch.where(diag != 0, 1.0 / torch.where(diag != 0, diag, 1.0), 0.0)
            if lev == len(self.levels) - 1:
                return self._coarse_solve(vals, inv_diag, b)
            x = self._smooth(vals, inv_diag, b, torch.zeros_like(b), self.nu_pre)
            r = b - stencil_apply(vals, x)
            ec = vc(lev + 1, restrict(r))
            x = x + prolong(ec, self.levels[lev].shape)
            return self._smooth(vals, inv_diag, b, x, self.nu_post)

        return vc(0, b)

    # --- outer flexible CG ----------------------------------------------------
    def solve(self, ks: torch.Tensor, *, tol: float = 1e-7, maxiter: int = 60):
        """MG-preconditioned flexible CG solve of A(k) u = F on the fine grid
        for each row of ks (B, 5). Returns (u (B, X0, Y0), iters (B,) int32);
        each sample stops at ||r|| <= tol ||F|| or at maxiter."""
        ks = torch.as_tensor(ks, dtype=self.levels[0].F.dtype, device=self.levels[0].F.device)
        vals_all = [lev.vals(ks, self.biot) for lev in self.levels]
        vals = vals_all[0]
        b = self.levels[0].F.expand(ks.shape[0], *self.levels[0].shape)

        b_nrm2 = torch.clamp(_dot(b, b), min=torch.finfo(b.dtype).tiny)
        tol2 = torch.tensor(tol, dtype=b.dtype, device=b.device) ** 2 * b_nrm2

        x = torch.zeros_like(b)
        r = b
        z = self.v_cycle(vals_all, r)
        p = z
        rz = _dot(r, z)
        iters = torch.zeros(ks.shape[0], dtype=torch.int32, device=b.device)
        for _ in range(maxiter):
            active = _dot(r, r) > tol2  # (B, 1, 1)
            if not bool(active.any()):
                break
            Ap = stencil_apply(vals, p)
            pAp = _dot(p, Ap)
            alpha = torch.where(pAp != 0, rz / torch.where(pAp != 0, pAp, 1.0), 0.0)
            x_new = x + alpha * p
            r_new = r - alpha * Ap
            z = self.v_cycle(vals_all, r_new)
            # Polak-Ribiere (flexible) beta: tolerates the nonlinear coarse
            # CG inside the preconditioner
            rz_new = _dot(r_new, z)
            beta = torch.where(rz != 0, _dot(z, r_new - r) / torch.where(rz != 0, rz, 1.0), 0.0)
            p_new = z + beta * p
            # a converged sample keeps its state, as under a vmapped while_loop
            x = torch.where(active, x_new, x)
            r = torch.where(active, r_new, r)
            p = torch.where(active, p_new, p)
            rz = torch.where(active, rz_new, rz)
            iters = iters + active.reshape(-1).to(torch.int32)
        return x, iters
