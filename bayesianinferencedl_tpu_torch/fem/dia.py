"""Stencil (DIA/diagonal) operator on the uncompacted structured grid.

If node ids keep the full (nx+1) x (ny+1) grid numbering (outside-domain
nodes become identity rows), every stiffness / boundary-mass entry of the
fin's P1 operator lands on one of exactly SEVEN diagonals,

    offsets: 0, +-1, +-(ny+1), +-(ny+2)

so A(k) stores as (n, 7) diagonal values and a matvec is seven
shift-multiply-adds of a zero-padded vector. The host assembly is the NumPy
code of the JAX package's ``fem/dia.py`` (that module imports jax at the
top, so it is carried here rather than imported); ``StencilOperator`` is its
torch counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.geometry.fin import N_REGIONS
from bayesianinferencedl_tpu_torch.geometry.mesh import FinMesh
from bayesianinferencedl_tpu_torch.fem import p1
from bayesianinferencedl_tpu_torch.utils.device import resolve_device
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul


@dataclass
class FinFEMDiaHost:
    """Host-side stencil assembly. Diagonal order is ascending offset."""

    offsets: np.ndarray  # (n_diag,) int64, e.g. [-(ny+2), -(ny+1), -1, 0, 1, ny+1, ny+2]
    comp_vals: np.ndarray  # (n, n_diag, 5)
    ext_mass: np.ndarray  # (n, n_diag)
    fixed: np.ndarray  # (n, n_diag) identity for non-domain rows + padding
    F_root: np.ndarray  # (n,)
    qoi: np.ndarray  # (n_obs, n)
    qoi_root: np.ndarray  # (n,)
    n_grid: int  # true structured-grid node count before padding
    resolution: int

    @property
    def n(self) -> int:
        return self.comp_vals.shape[0]

    def to_scipy_components(self):
        """float64 scipy CSR matrices ([A_1..A_5], M_ext) of this host —
        for exact offline algebra (f64 Galerkin projection) and oracles."""
        import scipy.sparse as sp

        n = self.n
        rows = np.arange(n)
        n_comp = self.comp_vals.shape[2]
        mats = []
        for ch in range(n_comp + 1):
            data_all, r_all, c_all = [], [], []
            for s, off in enumerate(self.offsets):
                vals = self.comp_vals[:, s, ch] if ch < n_comp else self.ext_mass[:, s]
                cols = rows + int(off)
                ok = (cols >= 0) & (cols < n) & (vals != 0)
                data_all.append(vals[ok])
                r_all.append(rows[ok])
                c_all.append(cols[ok])
            mats.append(
                sp.coo_matrix(
                    (np.concatenate(data_all), (np.concatenate(r_all), np.concatenate(c_all))),
                    shape=(n, n),
                ).tocsr()
            )
        return mats[:-1], mats[-1]


def assemble_fin_dia(mesh: FinMesh, pad_to: int = 128) -> FinFEMDiaHost:
    """Assemble the affine fin operator in stencil form on the full grid.

    Reconstructs each kept node's structured-grid id from its coordinates
    (the structured mesh guarantees exact lattice coordinates), then
    accumulates element/edge contributions by diagonal offset.
    """
    n_res = mesh.resolution
    h = 0.25 / n_res
    ny = 16 * n_res
    gi = np.rint((mesh.nodes[:, 0] + 3.0) / h).astype(np.int64)
    gj = np.rint(mesh.nodes[:, 1] / h).astype(np.int64)
    gid = gi * (ny + 1) + gj
    n_grid = (24 * n_res + 1) * (ny + 1)
    n = ((n_grid + pad_to - 1) // pad_to) * pad_to

    offsets = np.array([-(ny + 2), -(ny + 1), -1, 0, 1, ny + 1, ny + 2], dtype=np.int64)
    off_slot = {int(o): s for s, o in enumerate(offsets)}
    nd = len(offsets)

    comp_vals = np.zeros((n, nd, N_REGIONS))
    ext_mass = np.zeros((n, nd))

    Ke, _ = p1.element_stiffness(mesh.nodes, mesh.triangles)
    tri_g = gid[mesh.triangles]  # (nt, 3) global ids

    for a in range(3):
        for b in range(3):
            rows = tri_g[:, a]
            offs = tri_g[:, b] - tri_g[:, a]
            slot_of = np.vectorize(off_slot.__getitem__, otypes=[np.int64])(offs)
            np.add.at(comp_vals, (rows, slot_of, mesh.tri_region), Ke[:, a, b])

    Me = p1.edge_mass(mesh.nodes, mesh.ext_edges)
    edge_g = gid[mesh.ext_edges]  # (ne, 2)
    for a in range(2):
        for b in range(2):
            rows = edge_g[:, a]
            offs = edge_g[:, b] - edge_g[:, a]
            slot_of = np.vectorize(off_slot.__getitem__, otypes=[np.int64])(offs)
            np.add.at(ext_mass, (rows, slot_of), Me[:, a, b])

    # identity rows for any grid node with no stiffness diagonal (outside the
    # fin) and for padding rows
    diag_slot = off_slot[0]
    has_dof = comp_vals[:, diag_slot, :].sum(axis=1) > 0
    fixed = np.zeros((n, nd))
    fixed[~has_dof, diag_slot] = 1.0

    F_root = np.zeros(n)
    load = p1.edge_load(mesh.nodes, mesh.root_edges)
    np.add.at(F_root, gid[mesh.root_edges].reshape(-1), load.reshape(-1))

    area = mesh.tri_areas()
    qoi = np.zeros((N_REGIONS, n))
    w = np.repeat(area[:, None] / 3.0, 3, axis=1).reshape(-1)
    np.add.at(qoi, (mesh.tri_region.repeat(3), tri_g.reshape(-1)), w)
    qoi /= qoi.sum(axis=1, keepdims=True)

    qoi_root = np.zeros(n)
    np.add.at(qoi_root, gid[mesh.root_edges].reshape(-1), load.reshape(-1))
    qoi_root /= qoi_root.sum()

    return FinFEMDiaHost(
        offsets=offsets,
        comp_vals=comp_vals,
        ext_mass=ext_mass,
        fixed=fixed,
        F_root=F_root,
        qoi=qoi,
        qoi_root=qoi_root,
        n_grid=n_grid,
        resolution=n_res,
    )


@dataclass(frozen=True)
class StencilOperator:
    """Device-side 7-diagonal affine operator (gather-free SpMV)."""

    comp_vals: torch.Tensor  # (n, 7, 5)
    ext_mass: torch.Tensor  # (n, 7)
    fixed: torch.Tensor  # (n, 7)
    F_root: torch.Tensor  # (n,)
    qoi: torch.Tensor  # (n_obs, n)
    qoi_root: torch.Tensor  # (n,)
    offsets: tuple  # python ints, ascending
    biot: float
    n_grid: int

    @classmethod
    def from_host(
        cls, host: FinFEMDiaHost, biot: float, dtype=torch.float32, device="cuda"
    ) -> "StencilOperator":
        """The operator on ``device``: the card unless the caller asks for "cpu"."""
        device = resolve_device(device)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        return cls(
            comp_vals=t(host.comp_vals),
            ext_mass=t(host.ext_mass),
            fixed=t(host.fixed),
            F_root=t(host.F_root),
            qoi=t(host.qoi),
            qoi_root=t(host.qoi_root),
            offsets=tuple(int(o) for o in host.offsets),
            biot=float(biot),
            n_grid=int(host.n_grid),
        )

    @property
    def n(self) -> int:
        return self.comp_vals.shape[0]

    @property
    def n_dof(self) -> int:
        """Grid node count (identity rows included)."""
        return self.n_grid

    @property
    def n_obs(self) -> int:
        return self.qoi.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.comp_vals.dtype

    @property
    def device(self) -> torch.device:
        return self.comp_vals.device

    @property
    def max_offset(self) -> int:
        return max(abs(o) for o in self.offsets)

    @property
    def resolution(self) -> int:
        """Mesh resolution, recovered from the stencil layout: the second-
        largest offset is ny+1 with ny = 16 * resolution."""
        return (self.offsets[-2] - 1) // 16

    def vals(self, k: torch.Tensor) -> torch.Tensor:
        """(..., 5) conductivities -> (..., n, 7) diagonal values.

        An elementwise multiply-sum over the five components, never a
        matmul, so the assembled operator is exact in the working dtype
        whatever the matmul precision settings are."""
        k = torch.as_tensor(k, dtype=self.dtype, device=self.device)
        kk = k[..., None, None, :]
        acc = kk[..., 0] * self.comp_vals[:, :, 0]
        for i in range(1, self.comp_vals.shape[2]):
            acc = acc + kk[..., i] * self.comp_vals[:, :, i]
        return acc + self.biot * self.ext_mass + self.fixed

    def matvec(self, vals: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Seven shift-multiply-adds on a zero-padded vector; no gather.
        vals (..., n, 7), u (..., n) -> (..., n)."""
        m = self.max_offset
        n = self.n
        u_pad = torch.nn.functional.pad(u, (m, m))
        acc = torch.zeros_like(u)
        for s, off in enumerate(self.offsets):
            acc = acc + vals[..., s] * u_pad[..., m + off : m + off + n]
        return acc

    def apply(self, k: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return self.matvec(self.vals(k), u)

    def apply_component(self, i: int, u: torch.Tensor) -> torch.Tensor:
        """u -> A_i u, the i-th region's component (the Galerkin projection)."""
        return self.matvec(self.comp_vals[:, :, i], u)

    def apply_ext_mass(self, u: torch.Tensor) -> torch.Tensor:
        """u -> (M_ext + I_pad) u."""
        return self.matvec(self.ext_mass + self.fixed, u)

    def diag(self, vals: torch.Tensor) -> torch.Tensor:
        return vals[..., self.offsets.index(0)]

    def observe(self, u: torch.Tensor) -> torch.Tensor:
        """QoI map y = B u, (..., n) -> (..., n_obs), in full fp32."""
        with fp32_matmul():
            return torch.matmul(u, self.qoi.T)

    # --- 2-D grid view (the single-sample stencil kernel K4) ---------------
    # The shapes are the JAX package's: the grid padded to (8, 128) tiles,
    # whose padded cells carry zero planes. Every view takes leading batch
    # dimensions.
    @property
    def grid_shape0(self) -> tuple[int, int]:
        """True structured-grid shape (nx+1, ny+1); flat id = ix*(ny+1)+iy."""
        y0 = self.offsets[-2]  # the ny+1 offset
        return self.n_grid // y0, y0

    @property
    def grid_shape(self) -> tuple[int, int]:
        """Padded grid shape: the first dim to a multiple of 8, the second
        to a multiple of 128."""
        x0, y0 = self.grid_shape0
        return ((x0 + 7) // 8) * 8, ((y0 + 127) // 128) * 128

    def to_grid(self, v_flat: torch.Tensor) -> torch.Tensor:
        """(..., n) flat vectors -> (..., X, Y) padded grid arrays, contiguous."""
        x0, y0 = self.grid_shape0
        x, y = self.grid_shape
        a = v_flat[..., : self.n_grid].reshape(*v_flat.shape[:-1], x0, y0)
        return torch.nn.functional.pad(a, (0, y - y0, 0, x - x0)).contiguous()

    def from_grid(self, a: torch.Tensor) -> torch.Tensor:
        """(..., X, Y) grid arrays -> (..., n) flat vectors (padding tail
        zeroed)."""
        x0, y0 = self.grid_shape0
        flat = a[..., :x0, :y0].reshape(*a.shape[:-2], x0 * y0)
        return torch.nn.functional.pad(flat, (0, self.n - self.n_grid))

    def vals_grid(self, k: torch.Tensor) -> torch.Tensor:
        """(..., 5) conductivities -> (..., 7, X, Y) diagonal planes of A(k)."""
        vals = self.vals(k)[..., : self.n_grid, :]  # (..., n_grid, 7)
        return self.to_grid(vals.transpose(-1, -2))
