"""SciPy float64 reference assembly and solve: the correctness oracle.

The same weak form as ``assemble.py`` assembled by an independent path
(scipy.sparse COO -> CSR, sparse direct solve), so agreement between the two
is a real cross-check. It also gives the general load assembly (volume
source and boundary data) of the method-of-manufactured-solutions tests.
The port's own copy of the JAX package's ``fem/oracle.py``; NumPy and SciPy
only, so it runs wherever the port does.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from bayesianinferencedl_tpu_torch.geometry.fin import N_REGIONS
from bayesianinferencedl_tpu_torch.geometry.mesh import FinMesh
from bayesianinferencedl_tpu_torch.fem import p1


def stiffness_components(mesh: FinMesh) -> list[sp.csr_matrix]:
    """The five region-restricted stiffness matrices A_i (unit conductivity)."""
    n = mesh.n_nodes
    Ke, _ = p1.element_stiffness(mesh.nodes, mesh.triangles)
    out = []
    for i in range(N_REGIONS):
        sel = mesh.tri_region == i
        t = mesh.triangles[sel]
        rows = np.repeat(t, 3, axis=1).reshape(-1)
        cols = np.tile(t, (1, 3)).reshape(-1)
        A = sp.coo_matrix((Ke[sel].reshape(-1), (rows, cols)), shape=(n, n))
        out.append(A.tocsr())
    return out


def boundary_mass(mesh: FinMesh, which: str = "ext") -> sp.csr_matrix:
    """The P1 mass matrix of the exterior ("ext") or root ("root") boundary."""
    edges = mesh.ext_edges if which == "ext" else mesh.root_edges
    n = mesh.n_nodes
    Me = p1.edge_mass(mesh.nodes, edges)
    rows = np.repeat(edges, 2, axis=1).reshape(-1)
    cols = np.tile(edges, (1, 2)).reshape(-1)
    return sp.coo_matrix((Me.reshape(-1), (rows, cols)), shape=(n, n)).tocsr()


def volume_mass(mesh: FinMesh) -> sp.csr_matrix:
    n = mesh.n_nodes
    Me = p1.element_mass(mesh.nodes, mesh.triangles)
    rows = np.repeat(mesh.triangles, 3, axis=1).reshape(-1)
    cols = np.tile(mesh.triangles, (1, 3)).reshape(-1)
    return sp.coo_matrix((Me.reshape(-1), (rows, cols)), shape=(n, n)).tocsr()


def system_matrix(mesh: FinMesh, k: np.ndarray, biot: float) -> sp.csr_matrix:
    comps = stiffness_components(mesh)
    A = biot * boundary_mass(mesh, "ext")
    for i in range(N_REGIONS):
        A = A + float(k[i]) * comps[i]
    return A.tocsr()


def root_load(mesh: FinMesh) -> np.ndarray:
    F = np.zeros(mesh.n_nodes)
    load = p1.edge_load(mesh.nodes, mesh.root_edges)
    np.add.at(F, mesh.root_edges.reshape(-1), load.reshape(-1))
    return F


def general_load(
    mesh: FinMesh,
    f_nodal: np.ndarray | None = None,
    g_root_nodal: np.ndarray | None = None,
    g_ext_nodal: np.ndarray | None = None,
) -> np.ndarray:
    """F = M f + M_root g_root + M_ext g_ext with nodal data (the MMS tests)."""
    F = np.zeros(mesh.n_nodes)
    if f_nodal is not None:
        F += volume_mass(mesh) @ f_nodal
    if g_root_nodal is not None:
        F += boundary_mass(mesh, "root") @ g_root_nodal
    if g_ext_nodal is not None:
        F += boundary_mass(mesh, "ext") @ g_ext_nodal
    return F


def solve(mesh: FinMesh, k: np.ndarray, biot: float, F: np.ndarray | None = None) -> np.ndarray:
    """float64 sparse direct solve of A(k) u = F (default: the root-flux load),
    in mesh-node order."""
    A = system_matrix(mesh, k, biot)
    if F is None:
        F = root_load(mesh)
    return spla.spsolve(A.tocsc(), F)
