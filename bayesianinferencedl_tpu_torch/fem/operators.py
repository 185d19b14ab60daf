"""The ELL-layout affine fin operator on a device (torch tensors).

Holds the padded ELL arrays of ``fem/assemble.py``. Assembling A(k) is a
contraction over the five affine components, and a matvec is a gather, a
multiply and a row sum: ``(vals * u[..., cols]).sum(-1)``. Plain torch,
as in the JAX package, where the same gather is XLA outside any Pallas
kernel; the stencil kernels of ``ops/pcg_stencil.py`` carry every stencil
fin, and an ELL fin goes through the plain PCG of ``fem/solve.py`` in any
dtype.

``FinOperator`` keeps the protocol of ``fem/dia.StencilOperator`` (vals,
matvec, apply, apply_component, apply_ext_mass, diag, observe, comp_vals,
F_root, qoi, biot, n, n_dof, n_obs, dtype, device), so ``fem/solve.py``,
``ReducedOperator.project`` and ``rom/greedy.py`` take it unchanged. Every
method batches over leading dimensions of k and u.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.fem.assemble import FinFEMHost
from bayesianinferencedl_tpu_torch.utils.device import resolve_device
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul


@dataclasses.dataclass(frozen=True)
class FinOperator:
    """ELL-layout affine operator A(k) = sum_i k_i A_i + Bi * M_ext.

    Shapes: n rows (padded to ``pad_to``), L ELL slots, 5 components, n_obs
    QoI rows."""

    cols: torch.Tensor  # (n, L) int64
    comp_vals: torch.Tensor  # (n, L, 5)
    ext_mass: torch.Tensor  # (n, L)
    fixed: torch.Tensor  # (n, L)
    diag_slot: torch.Tensor  # (n,) int64
    F_root: torch.Tensor  # (n,)
    qoi: torch.Tensor  # (n_obs, n)
    qoi_root: torch.Tensor  # (n,)
    biot: float
    n_dof: int

    @classmethod
    def from_host(cls, host: FinFEMHost, biot: float, dtype=torch.float32,
                  device="cuda") -> "FinOperator":
        """The operator on ``device``: the card unless the caller asks for "cpu"."""
        device = resolve_device(device)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        idx = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
        return cls(
            cols=idx(host.cols),
            comp_vals=t(host.comp_vals),
            ext_mass=t(host.ext_mass),
            fixed=t(host.fixed),
            diag_slot=idx(host.diag_slot),
            F_root=t(host.F_root),
            qoi=t(host.qoi),
            qoi_root=t(host.qoi_root),
            biot=float(biot),
            n_dof=int(host.n_dof),
        )

    @property
    def n(self) -> int:
        return self.cols.shape[0]

    @property
    def n_obs(self) -> int:
        return self.qoi.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.comp_vals.dtype

    @property
    def device(self) -> torch.device:
        return self.comp_vals.device

    def vals(self, k: torch.Tensor) -> torch.Tensor:
        """(..., 5) conductivities -> (..., n, L) ELL values of A(k).

        An elementwise multiply-sum over the five components, never a matmul,
        so the assembled operator is exact in the working dtype whatever the
        matmul precision settings are."""
        k = torch.as_tensor(k, dtype=self.dtype, device=self.device)
        kk = k[..., None, None, :]
        acc = kk[..., 0] * self.comp_vals[:, :, 0]
        for i in range(1, self.comp_vals.shape[2]):
            acc = acc + kk[..., i] * self.comp_vals[:, :, i]
        return acc + self.biot * self.ext_mass + self.fixed

    def matvec(self, vals: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """SpMV with assembled ELL values: vals (..., n, L), u (..., n) ->
        (..., n), a gather, a multiply and a row sum."""
        return torch.sum(vals * u[..., self.cols], -1)

    def apply(self, k: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """u -> A(k) u."""
        return self.matvec(self.vals(k), u)

    def apply_component(self, i: int, u: torch.Tensor) -> torch.Tensor:
        """u -> A_i u, the i-th region's unit-conductivity component (the
        Galerkin projection and the hand-coded adjoint)."""
        return self.matvec(self.comp_vals[:, :, i], u)

    def apply_ext_mass(self, u: torch.Tensor) -> torch.Tensor:
        """u -> (M_ext + I_pad) u."""
        return self.matvec(self.ext_mass + self.fixed, u)

    def diag(self, vals: torch.Tensor) -> torch.Tensor:
        """(..., n, L) values -> (..., n) diagonal of A (the Jacobi
        preconditioner)."""
        rows = torch.arange(self.n, device=vals.device)
        return vals[..., rows, self.diag_slot]

    def observe(self, u: torch.Tensor) -> torch.Tensor:
        """QoI map y = B u, (..., n) -> (..., n_obs), in full fp32."""
        with fp32_matmul():
            return torch.matmul(u, self.qoi.T)

    def materialize(self, k: torch.Tensor) -> torch.Tensor:
        """Dense A(k) for k (5,) (tests and small meshes only)."""
        vals = self.vals(k)
        rows = torch.arange(self.n, device=self.device)[:, None].expand_as(self.cols)
        A = torch.zeros((self.n, self.n), dtype=self.dtype, device=self.device)
        return A.index_put_((rows, self.cols), vals, accumulate=True)

    def astype(self, dtype) -> "FinOperator":
        return dataclasses.replace(
            self,
            comp_vals=self.comp_vals.to(dtype),
            ext_mass=self.ext_mass.to(dtype),
            fixed=self.fixed.to(dtype),
            F_root=self.F_root.to(dtype),
            qoi=self.qoi.to(dtype),
            qoi_root=self.qoi_root.to(dtype),
        )
