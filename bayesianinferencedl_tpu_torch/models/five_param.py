"""The 5-parameter thermal fin: piecewise-constant conductivity (one k_i per
subfin pair + post), affine stencil assembly, FOM forward and QoI.

Every FOM solve here goes through K1 or K3
(``ops.pcg_stencil.solve_fom_stencil``) with the two-level deflation
preconditioner; the differentiable solve of the JAX package
(``fem/solve.py``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from bayesianinferencedl_tpu_torch.geometry.mesh import FinMesh, build_fin_mesh
from bayesianinferencedl_tpu_torch.fem.dia import FinFEMDiaHost, StencilOperator, assemble_fin_dia
from bayesianinferencedl_tpu_torch.ops.deflation import DeflationBasis
from bayesianinferencedl_tpu_torch.ops.pcg_stencil import solve_fom_stencil
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

    def solve_batch(self, ks: torch.Tensor) -> torch.Tensor:
        """(B, 5) conductivities -> (B, n) full-order solution fields."""
        u, _ = solve_fom_stencil(
            self.op, ks, tol=self.cg_tol, maxiter=self.cg_maxiter,
            deflation=self.deflation_basis(),
        )
        return u

    def qoi(self, u: torch.Tensor) -> torch.Tensor:
        """Subfin-average observables."""
        return self.op.observe(u)

    def forward_batch(self, ks: torch.Tensor) -> torch.Tensor:
        """G_FOM: (B, 5) -> (B, n_obs)."""
        return self.qoi(self.solve_batch(ks))

    def forward(self, k: torch.Tensor) -> torch.Tensor:
        """G_FOM: (5,) -> (n_obs,)."""
        return self.forward_batch(torch.as_tensor(k)[None])[0]
