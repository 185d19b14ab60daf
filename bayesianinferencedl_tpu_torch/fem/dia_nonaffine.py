"""Non-affine (nodal-conductivity) stencil operator in the DIA layout.

On the structured fin grid A(k_nodal) has the same seven diagonals as the
affine operator, and because P1 stiffness is linear in the element
conductivity (the mean of its 3 nodal values), the map k_nodal -> diagonal
values is itself a 7-point stencil:

    vals[i, s] = sum_d  G[i, s, d] * k[i + offset_d]

with a host-assembled coefficient tensor G (n, 7, 7). So the full-field FOM
shares everything with the affine path: the same SpMV, the same Jacobi-PCG
and the same stencil kernels (K3r), which consume assembled planes. The
host assembly of G is the NumPy code of the JAX package's
``fem/dia_nonaffine.py``; ``NodalStencilOperator`` is its torch
counterpart, on batches of k of shape (B, n).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.fem import p1
from bayesianinferencedl_tpu_torch.fem.dia import FinFEMDiaHost, StencilOperator
from bayesianinferencedl_tpu_torch.geometry.mesh import FinMesh


def assemble_nodal_coeff(mesh: FinMesh, host: FinFEMDiaHost) -> np.ndarray:
    """Host assembly of G (n, 7, 7) in float64:
    G[row, slot_ab, slot_ac] += Ke[a, b] / 3 for every element vertex triple,
    where slot_ab indexes the matrix entry (row=v_a, col=v_b) and slot_ac the
    nodal-k contribution k[v_c] (elements average k over their 3 vertices)."""
    n_res = mesh.resolution
    h = 0.25 / n_res
    ny = 16 * n_res
    gi = np.rint((mesh.nodes[:, 0] + 3.0) / h).astype(np.int64)
    gj = np.rint(mesh.nodes[:, 1] / h).astype(np.int64)
    gid = gi * (ny + 1) + gj

    offsets = host.offsets
    off_slot = {int(o): s for s, o in enumerate(offsets)}
    slot_of = np.vectorize(off_slot.__getitem__, otypes=[np.int64])

    Ke, _ = p1.element_stiffness(mesh.nodes, mesh.triangles)
    tri_g = gid[mesh.triangles]  # (nt, 3)

    G = np.zeros((host.n, len(offsets), len(offsets)))
    for a in range(3):
        rows = tri_g[:, a]
        for b in range(3):
            s_ab = slot_of(tri_g[:, b] - rows)
            for c in range(3):
                s_ac = slot_of(tri_g[:, c] - rows)
                np.add.at(G, (rows, s_ab, s_ac), Ke[:, a, b] / 3.0)
    return G


@dataclass(frozen=True)
class NodalStencilOperator:
    """Full-field operator A(k_nodal) over the structured grid.

    Delegates layout, QoI and loads to the affine ``StencilOperator`` (whose
    comp_vals are unused here) and assembles per-sample diagonal values
    from the nodal field through G. It keeps the solver protocol (vals,
    diag, matvec, F_root, observe, vals_grid, to_grid, from_grid), so
    ``fem/solve.py`` and ``ops/pcg_stencil.py`` serve it unchanged; its k
    is a nodal field, (n,) or (B, n), not (B, 5)."""

    base: StencilOperator
    G: torch.Tensor  # (n, 7, 7)

    nodal = True  # fem.solve.solve_fom takes the planes-level adjoint

    @classmethod
    def create(cls, mesh: FinMesh, host: FinFEMDiaHost, biot: float, dtype=torch.float32,
               device="cuda") -> "NodalStencilOperator":
        """The operator on ``device`` (the card unless the caller asks for "cpu")."""
        base = StencilOperator.from_host(host, biot=biot, dtype=dtype, device=device)
        G = torch.as_tensor(assemble_nodal_coeff(mesh, host), dtype=dtype, device=base.device)
        return cls(base=base, G=G)

    # --- protocol delegation ------------------------------------------------
    n = property(lambda self: self.base.n)
    n_grid = property(lambda self: self.base.n_grid)
    n_dof = property(lambda self: self.base.n_dof)
    n_obs = property(lambda self: self.base.n_obs)
    dtype = property(lambda self: self.base.dtype)
    device = property(lambda self: self.base.device)
    resolution = property(lambda self: self.base.resolution)
    offsets = property(lambda self: self.base.offsets)
    max_offset = property(lambda self: self.base.max_offset)
    biot = property(lambda self: self.base.biot)
    F_root = property(lambda self: self.base.F_root)
    qoi = property(lambda self: self.base.qoi)
    ext_mass = property(lambda self: self.base.ext_mass)
    fixed = property(lambda self: self.base.fixed)
    grid_shape0 = property(lambda self: self.base.grid_shape0)
    grid_shape = property(lambda self: self.base.grid_shape)

    def matvec(self, vals: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return self.base.matvec(vals, u)

    def diag(self, vals: torch.Tensor) -> torch.Tensor:
        return self.base.diag(vals)

    def observe(self, u: torch.Tensor) -> torch.Tensor:
        return self.base.observe(u)

    def to_grid(self, v: torch.Tensor) -> torch.Tensor:
        return self.base.to_grid(v)

    def from_grid(self, a: torch.Tensor) -> torch.Tensor:
        return self.base.from_grid(a)

    # --- non-affine assembly ------------------------------------------------
    def vals(self, k_nodal: torch.Tensor) -> torch.Tensor:
        """(..., n) nodal conductivities -> (..., n, 7) diagonal values:
        seven shift-multiply-adds of the nodal field against G, plus the
        Robin mass and the padding identity. Elementwise, so exact in the
        working dtype, and differentiable in k_nodal."""
        b = self.base
        m, n = b.max_offset, b.n
        k = torch.as_tensor(k_nodal, dtype=self.dtype, device=self.device)
        k_pad = torch.nn.functional.pad(k, (m, m))
        acc = None
        for d, off in enumerate(b.offsets):
            term = self.G[:, :, d] * k_pad[..., m + off: m + off + n, None]
            acc = term if acc is None else acc + term
        return acc + b.biot * b.ext_mass + b.fixed

    def apply(self, k_nodal: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return self.matvec(self.vals(k_nodal), u)

    def vals_grid(self, k_nodal: torch.Tensor) -> torch.Tensor:
        """(..., n) -> (..., 7, X, Y) diagonal planes on the padded grid."""
        vals = self.vals(k_nodal)[..., : self.n_grid, :]
        return self.to_grid(vals.transpose(-1, -2))
