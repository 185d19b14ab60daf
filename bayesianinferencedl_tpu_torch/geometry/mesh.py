"""Structured P1 triangulation of the thermal fin (SURVEY.md §7 stage 1).

The fin's every feature lies on the 0.25-lattice, so a structured grid with
cell size h = 0.25/resolution triangulates the domain exactly — no unstructured
mesher (the reference leaned on FEniCS/mshr for this; SURVEY.md §2a #2).

All arrays are NumPy float64/int32 on the host. ``FinMesh`` is a plain
dataclass of arrays so it pickles/npz-caches trivially and feeds straight into
``fem.dia.assemble_fin_dia``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from bayesianinferencedl_tpu_torch.geometry import fin as fin_geo


@dataclass
class FinMesh:
    """A P1 triangle mesh of the thermal fin.

    nodes:        (n_nodes, 2) float64 vertex coordinates.
    triangles:    (n_tri, 3) int32 vertex ids, counter-clockwise.
    tri_region:   (n_tri,) int32 conductivity region id in [0, 5).
    root_edges:   (n_root, 2) int32 vertex ids of Gamma_root boundary edges.
    ext_edges:    (n_ext, 2) int32 vertex ids of Gamma_ext boundary edges.
    ext_normals:  (n_ext, 2) float64 outward unit normals of ext edges.
    root_normals: (n_root, 2) float64 outward unit normals of root edges.
    resolution:   the n in h = 0.25/n.
    """

    nodes: np.ndarray
    triangles: np.ndarray
    tri_region: np.ndarray
    root_edges: np.ndarray
    ext_edges: np.ndarray
    ext_normals: np.ndarray
    root_normals: np.ndarray
    resolution: int

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.triangles.shape[0]

    @property
    def h(self) -> float:
        return 0.25 / self.resolution

    def tri_areas(self) -> np.ndarray:
        p = self.nodes[self.triangles]  # (nt, 3, 2)
        d1 = p[:, 1] - p[:, 0]
        d2 = p[:, 2] - p[:, 0]
        return 0.5 * (d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])

    def region_areas(self) -> np.ndarray:
        areas = self.tri_areas()
        out = np.zeros(fin_geo.N_REGIONS)
        np.add.at(out, self.tri_region, areas)
        return out

    def save_npz(self, path: str | Path) -> None:
        np.savez_compressed(
            path,
            nodes=self.nodes,
            triangles=self.triangles,
            tri_region=self.tri_region,
            root_edges=self.root_edges,
            ext_edges=self.ext_edges,
            ext_normals=self.ext_normals,
            root_normals=self.root_normals,
            resolution=np.int32(self.resolution),
        )

    @classmethod
    def load_npz(cls, path: str | Path) -> "FinMesh":
        z = np.load(path)
        return cls(
            nodes=z["nodes"],
            triangles=z["triangles"],
            tri_region=z["tri_region"],
            root_edges=z["root_edges"],
            ext_edges=z["ext_edges"],
            ext_normals=z["ext_normals"],
            root_normals=z["root_normals"],
            resolution=int(z["resolution"]),
        )


def build_fin_mesh(resolution: int = 4, cache_dir: Optional[str | Path] = None) -> FinMesh:
    """Triangulate the thermal fin at cell size h = 0.25/resolution.

    Structured grid over the bounding box [-3, 3] x [0, 4]; cells whose
    centroid lies in the fin are kept and split into two triangles along the
    (0,0)-(1,1) diagonal. Node ids are compacted to the kept cells.
    """
    if cache_dir is not None:
        cache = Path(cache_dir) / f"fin_mesh_r{resolution}.npz"
        if cache.exists():
            return FinMesh.load_npz(cache)

    n = int(resolution)
    if n < 1:
        raise ValueError("resolution must be >= 1")
    h = 0.25 / n
    nx, ny = 24 * n, 16 * n  # cells across [-3,3] x [0,4]

    # Cell centroids -> keep mask + region
    ci, cj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    cx = -3.0 + (ci + 0.5) * h
    cy = (cj + 0.5) * h
    centroids = np.stack([cx, cy], axis=-1)
    region = fin_geo.region_of_points(centroids)  # (nx, ny), -1 outside
    keep = region >= 0

    # Global structured node ids
    def gid(i, j):
        return i * (ny + 1) + j

    ki, kj = np.nonzero(keep)
    v00 = gid(ki, kj)
    v10 = gid(ki + 1, kj)
    v01 = gid(ki, kj + 1)
    v11 = gid(ki + 1, kj + 1)

    # Two CCW triangles per quad: (v00, v10, v11), (v00, v11, v01)
    tris_g = np.concatenate(
        [
            np.stack([v00, v10, v11], axis=1),
            np.stack([v00, v11, v01], axis=1),
        ],
        axis=0,
    )
    tri_region = np.concatenate([region[keep], region[keep]]).astype(np.int32)

    # Compact node ids
    used = np.unique(tris_g)
    remap = -np.ones((nx + 1) * (ny + 1), dtype=np.int64)
    remap[used] = np.arange(used.size)
    triangles = remap[tris_g].astype(np.int32)

    gi, gj = np.divmod(used, ny + 1)
    nodes = np.stack([-3.0 + gi * h, gj * h], axis=1).astype(np.float64)

    # Boundary edges: edges that appear in exactly one triangle.
    # Directed edges of CCW triangles keep the domain to their left, so the
    # outward normal of boundary edge (a, b) is (ty, -tx) for t = b - a.
    e = np.concatenate(
        [triangles[:, [0, 1]], triangles[:, [1, 2]], triangles[:, [2, 0]]], axis=0
    )
    e_sorted = np.sort(e, axis=1)
    _, first_idx, counts = np.unique(
        e_sorted[:, 0].astype(np.int64) * used.size + e_sorted[:, 1],
        return_index=True,
        return_counts=True,
    )
    boundary = e[first_idx[counts == 1]]  # directed (a, b), domain on the left

    pa = nodes[boundary[:, 0]]
    pb = nodes[boundary[:, 1]]
    t = pb - pa
    lengths = np.linalg.norm(t, axis=1)
    normals = np.stack([t[:, 1], -t[:, 0]], axis=1) / lengths[:, None]

    mid = 0.5 * (pa + pb)
    is_root = (np.abs(mid[:, 1]) < 0.25 * h) & (np.abs(mid[:, 0]) < fin_geo.POST_HALF_WIDTH)

    mesh = FinMesh(
        nodes=nodes,
        triangles=triangles,
        tri_region=tri_region,
        root_edges=boundary[is_root].astype(np.int32),
        ext_edges=boundary[~is_root].astype(np.int32),
        ext_normals=normals[~is_root],
        root_normals=normals[is_root],
        resolution=n,
    )

    if cache_dir is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        mesh.save_npz(cache)
    return mesh
