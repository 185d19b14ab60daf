"""The 5-parameter thermal fin: piecewise-constant conductivity (one k_i per
subfin pair + post), affine stencil assembly, FOM forward and QoI, and the
derivatives of the data misfit.

Two solves, as in the JAX package:

- ``solve`` (and ``misfit``, ``gradient``, ``hvp``, ``gn_hvp``) is the
  differentiable plain-torch PCG of ``fem/solve.py``, with adjoint-solve
  gradients;
- ``solve_batch``/``forward_batch``/``forward`` are batched sweeps through
  the stencil kernels (``ops.pcg_stencil.solve_fom_stencil``): K1 or K3r with
  the two-level deflation preconditioner, or K4r / K4c on the largest meshes,
  where no deflation basis is built.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from bayesianinferencedl_tpu_torch.geometry.mesh import FinMesh, build_fin_mesh
from bayesianinferencedl_tpu_torch.fem.dia import FinFEMDiaHost, StencilOperator, assemble_fin_dia
from bayesianinferencedl_tpu_torch.ops.deflation import DeflationBasis
from bayesianinferencedl_tpu_torch.fem.solve import pcg_fom, solve_fom
from bayesianinferencedl_tpu_torch.ops.pcg_stencil import layout_for, solve_fom_stencil
from bayesianinferencedl_tpu_torch.utils.device import resolve_device


@dataclass
class FiveParamFin:
    """Thermal fin with 5 piecewise-constant conductivities (stencil layout)."""

    mesh: FinMesh
    host: FinFEMDiaHost
    op: StencilOperator
    cg_tol: float = 1e-10
    cg_maxiter: int = 3000
    _deflation: Optional[DeflationBasis] = field(default=None, repr=False)

    @classmethod
    def create(
        cls,
        resolution: int = 4,
        biot: float = 0.1,
        dtype=torch.float32,
        device="cuda",
        cg_tol: float = 1e-10,
        cg_maxiter: int = 3000,
    ) -> "FiveParamFin":
        """The fin on ``device``: the card unless the caller asks for "cpu";
        without a card "cuda" raises."""
        device = resolve_device(device)
        mesh = build_fin_mesh(resolution)
        host = assemble_fin_dia(mesh)
        op = StencilOperator.from_host(host, biot=biot, dtype=dtype, device=device)
        return cls(mesh=mesh, host=host, op=op, cg_tol=cg_tol, cg_maxiter=cg_maxiter)

    def deflation_basis(self) -> DeflationBasis:
        """The two-level deflation basis (m = 128 modes), built once
        (host f64 eigensolve) and cached on the fin."""
        if self._deflation is None:
            self._deflation = DeflationBasis.create(
                self.host, biot=self.op.biot, dtype=self.op.dtype, device=self.op.device
            )
        return self._deflation

    def deflation_for_kernels(self) -> Optional[DeflationBasis]:
        """The basis the batched kernels apply: None on K4's "single" layout,
        which neither applies nor builds one."""
        return None if layout_for(self.op.n) == "single" else self.deflation_basis()

    def solve_batch(self, ks: torch.Tensor) -> torch.Tensor:
        """(B, 5) conductivities -> (B, n) full-order solution fields: the
        stencil kernels in float32, the plain PCG of ``fem/solve.py`` in
        float64 (the split of ``api.make_fom_solver``)."""
        if self.op.dtype != torch.float32:
            ks = torch.as_tensor(ks, dtype=self.op.dtype, device=self.op.device)
            u, _, _ = pcg_fom(self.op, ks, self.op.F_root.expand(ks.shape[0], -1), tol=self.cg_tol,
                              maxiter=self.cg_maxiter)
            return u
        u, _ = solve_fom_stencil(
            self.op, ks, tol=self.cg_tol, maxiter=self.cg_maxiter,
            deflation=self.deflation_for_kernels(),
        )
        return u

    def solve(self, k: torch.Tensor, F: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-order solution field u(k), differentiable in k and F (the
        plain PCG of ``fem/solve.py``); k (5,) or (B, 5)."""
        return solve_fom(self.op, k, F, tol=self.cg_tol, maxiter=self.cg_maxiter)

    def qoi(self, u: torch.Tensor) -> torch.Tensor:
        """Subfin-average observables."""
        return self.op.observe(u)

    def forward_batch(self, ks: torch.Tensor) -> torch.Tensor:
        """G_FOM: (B, 5) -> (B, n_obs)."""
        return self.qoi(self.solve_batch(ks))

    def forward(self, k: torch.Tensor) -> torch.Tensor:
        """G_FOM: (5,) -> (n_obs,)."""
        return self.forward_batch(torch.as_tensor(k)[None])[0]

    # --- inverse-problem derivatives (adjoint solves, fem/solve.py) --------
    def misfit(self, k: torch.Tensor, data: torch.Tensor, noise_sigma: float) -> torch.Tensor:
        r = self.qoi(self.solve(k)) - torch.as_tensor(data, dtype=self.op.dtype, device=self.op.device)
        return 0.5 * torch.sum(r * r) / noise_sigma**2

    def _k(self, k) -> torch.Tensor:
        return torch.as_tensor(k, dtype=self.op.dtype, device=self.op.device).detach().requires_grad_()

    def gradient(self, k: torch.Tensor, data: torch.Tensor, noise_sigma: float) -> torch.Tensor:
        """d misfit / dk: one forward and one adjoint solve."""
        k = self._k(k)
        return torch.autograd.grad(self.misfit(k, data, noise_sigma), k)[0]

    def hvp(self, k: torch.Tensor, v: torch.Tensor, data: torch.Tensor, noise_sigma: float) -> torch.Tensor:
        """Full Hessian-vector product H v: the derivative of g(k) . v, by a
        second backward through the adjoint solves."""
        k = self._k(k)
        g = torch.autograd.grad(self.misfit(k, data, noise_sigma), k, create_graph=True)[0]
        v = torch.as_tensor(v, dtype=g.dtype, device=g.device)
        return torch.autograd.grad(torch.sum(g * v), k)[0]

    def gn_hvp(self, k: torch.Tensor, v: torch.Tensor, noise_sigma: float) -> torch.Tensor:
        """Gauss-Newton HVP J^T J v / sigma^2 with J = dG/dk; J v is the
        derivative of J^T w in w (w a free dummy), so every product is an
        adjoint-style solve and no iteration is unrolled."""
        k = self._k(k)
        y = self.qoi(self.solve(k))
        w = torch.zeros_like(y, requires_grad=True)
        jtw = torch.autograd.grad(y, k, w, create_graph=True)[0]
        v = torch.as_tensor(v, dtype=jtw.dtype, device=jtw.device)
        jv = torch.autograd.grad(jtw, w, v, create_graph=True)[0]
        return torch.autograd.grad(y, k, jv)[0] / noise_sigma**2
