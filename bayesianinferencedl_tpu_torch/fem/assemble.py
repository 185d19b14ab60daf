r"""Affine ELL assembly of the fin operator, on the host in NumPy float64.

The weak form  sum_i k_i \int_{Omega_i} grad u . grad v + Bi \int_{Gext} u v
discretizes to  A(k) = sum_{i<5} k_i A_i + Bi * M_ext  — five affine stiffness
components plus a boundary mass, all sharing one sparsity pattern (their
union), stored once in a padded ELL layout over the mesh's own nodes:

    cols      (n, L) int32    column ids, padded entries point at own row
    comp_vals (n, L, 5)       per-region stiffness values
    ext_mass  (n, L)          exterior boundary mass values
    fixed     (n, L)          identity entries for padding rows (keeps SPD)

Assembling A(k) is then a contraction over the five components and a matvec
is a gather, a multiply and a row sum (``fem/operators.py``). This is the
layout for a fin without a structured grid, and the oracle path beside the
stencil layout of ``fem/dia.py``: the port's own copy of the JAX package's
``fem/assemble.py``, bit for bit. Rows are padded to a multiple of ``pad_to``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from bayesianinferencedl_tpu_torch.geometry.fin import N_REGIONS
from bayesianinferencedl_tpu_torch.geometry.mesh import FinMesh
from bayesianinferencedl_tpu_torch.fem import p1


@dataclass
class FinFEMHost:
    """Host-side (NumPy float64) assembled fin FEM problem.

    ELL operator arrays (see module docstring) plus:
      F_root:    (n,) root-flux load vector (unit inward flux on Gamma_root)
      qoi:       (n_obs, n) QoI rows, the area-averaged temperature per region
      qoi_root:  (n,) boundary-average temperature over Gamma_root
      diag_slot: (n,) ELL slot index of the diagonal entry of each row
      n_dof:     true dof count before padding (rows >= n_dof are identity)
    """

    cols: np.ndarray
    comp_vals: np.ndarray
    ext_mass: np.ndarray
    fixed: np.ndarray
    diag_slot: np.ndarray
    F_root: np.ndarray
    qoi: np.ndarray
    qoi_root: np.ndarray
    n_dof: int
    resolution: int

    @property
    def n(self) -> int:
        return self.cols.shape[0]

    @property
    def ell_width(self) -> int:
        return self.cols.shape[1]

    @property
    def n_obs(self) -> int:
        return self.qoi.shape[0]


def _coo_to_ell(
    n_dof: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,  # (nnz_raw, n_channels)
    pad_to: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Merge duplicate COO entries and lay them out as padded ELL.

    Returns (ell_cols, ell_vals (n, L, C), fixed (n, L), diag_slot, n_padded)."""
    n_channels = vals.shape[1]
    key = rows.astype(np.int64) * n_dof + cols.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    merged = np.zeros((uniq.size, n_channels))
    for ch in range(n_channels):
        np.add.at(merged[:, ch], inv, vals[:, ch])
    u_rows = (uniq // n_dof).astype(np.int64)
    u_cols = (uniq % n_dof).astype(np.int64)

    # uniq is sorted by key = row * n + col, so entries are grouped by row and
    # sorted by column within each row
    counts = np.bincount(u_rows, minlength=n_dof)
    L = int(counts.max())
    n_padded = ((n_dof + pad_to - 1) // pad_to) * pad_to

    slot = np.arange(uniq.size) - np.concatenate([[0], np.cumsum(counts)])[u_rows]

    ell_cols = np.tile(np.arange(n_padded, dtype=np.int64)[:, None], (1, L))
    ell_vals = np.zeros((n_padded, L, n_channels))
    ell_cols[u_rows, slot] = u_cols
    ell_vals[u_rows, slot] = merged

    fixed = np.zeros((n_padded, L))
    fixed[n_dof:, 0] = 1.0  # identity rows on padding: A(k) stays SPD

    # the diagonal slot of each row (every real row has one; padding rows use
    # slot 0, which points home)
    diag_slot = np.zeros(n_padded, dtype=np.int32)
    is_diag = u_rows == u_cols
    diag_slot[u_rows[is_diag]] = slot[is_diag]

    return ell_cols.astype(np.int32), ell_vals, fixed, diag_slot, n_padded


def assemble_fin(mesh: FinMesh, pad_to: int = 128) -> FinFEMHost:
    """Assemble the affine fin operator of a :class:`FinMesh` in ELL form:
    one host scatter, float64 throughout, whatever the device dtype."""
    nodes, tris = mesh.nodes, mesh.triangles
    n_dof = mesh.n_nodes

    Ke, area = p1.element_stiffness(nodes, tris)
    if (area <= 0).any():
        raise ValueError("non-positive triangle area (bad mesh orientation)")

    # stiffness components: 9 COO entries per triangle, channel = region
    rows = np.repeat(tris, 3, axis=1).reshape(-1)
    cols = np.tile(tris, (1, 3)).reshape(-1)
    vals = np.zeros((rows.size, N_REGIONS + 1))  # +1 channel: the exterior mass
    vals[np.arange(rows.size), mesh.tri_region.repeat(9)] = Ke.reshape(-1)

    # exterior boundary mass (the Robin term): 4 entries per exterior edge
    Me = p1.edge_mass(nodes, mesh.ext_edges)
    e = mesh.ext_edges
    e_rows = np.repeat(e, 2, axis=1).reshape(-1)
    e_cols = np.tile(e, (1, 2)).reshape(-1)
    e_vals = np.zeros((e_rows.size, N_REGIONS + 1))
    e_vals[:, N_REGIONS] = Me.reshape(-1)

    # every row gets a diagonal slot
    d_rows = np.arange(n_dof)
    d_vals = np.zeros((n_dof, N_REGIONS + 1))

    all_rows = np.concatenate([rows, e_rows, d_rows])
    all_cols = np.concatenate([cols, e_cols, d_rows])
    all_vals = np.concatenate([vals, e_vals, d_vals], axis=0)

    ell_cols, ell_vals, fixed, diag_slot, n_padded = _coo_to_ell(
        n_dof, all_rows, all_cols, all_vals, pad_to
    )
    comp_vals = ell_vals[:, :, :N_REGIONS]
    ext_mass = ell_vals[:, :, N_REGIONS]

    # root load: unit inward flux on Gamma_root
    F = np.zeros(n_padded)
    load = p1.edge_load(nodes, mesh.root_edges)
    np.add.at(F, mesh.root_edges.reshape(-1), load.reshape(-1))

    # QoI: area-averaged temperature per conductivity region
    qoi = np.zeros((N_REGIONS, n_padded))
    w = np.repeat(area[:, None] / 3.0, 3, axis=1).reshape(-1)
    r = mesh.tri_region.repeat(3)
    np.add.at(qoi, (r, tris.reshape(-1)), w)
    qoi /= qoi.sum(axis=1, keepdims=True)

    # root boundary average (the classic fin output functional)
    qoi_root = np.zeros(n_padded)
    np.add.at(qoi_root, mesh.root_edges.reshape(-1), load.reshape(-1))
    qoi_root /= qoi_root.sum()

    return FinFEMHost(
        cols=ell_cols,
        comp_vals=comp_vals,
        ext_mass=ext_mass,
        fixed=fixed,
        diag_slot=diag_slot,
        F_root=F,
        qoi=qoi,
        qoi_root=qoi_root,
        n_dof=n_dof,
        resolution=mesh.resolution,
    )
