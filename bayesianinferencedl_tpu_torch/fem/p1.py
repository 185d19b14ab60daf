"""Closed-form P1 (linear triangle) element matrices, vectorized over cells.

The reference relies on FEniCS' form compiler to generate element kernels
(SURVEY.md §3.1); for P1 on triangles the matrices are ~40 lines of closed
form, so we compute them directly on the host in float64.

Conventions: triangle vertices p_a, a in {0,1,2}, CCW; area A > 0;
barycentric gradient of shape fn a is (b_a, c_a) / (2A) with
b = (y1-y2, y2-y0, y0-y1), c = (x2-x1, x0-x2, x1-x0).
"""

from __future__ import annotations

import numpy as np


def element_stiffness(nodes: np.ndarray, triangles: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-element stiffness K_e = (b b^T + c c^T) / (4A), unit conductivity.

    Returns (K, area): K is (n_tri, 3, 3), area is (n_tri,).
    """
    p = nodes[triangles]  # (nt, 3, 2)
    x, y = p[..., 0], p[..., 1]
    b = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], axis=1)
    c = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], axis=1)
    # area = 0.5 * cross(p1-p0, p2-p0)
    d1 = p[:, 1] - p[:, 0]
    d2 = p[:, 2] - p[:, 0]
    area = 0.5 * (d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])
    K = (b[:, :, None] * b[:, None, :] + c[:, :, None] * c[:, None, :]) / (4.0 * area[:, None, None])
    return K, area


def element_mass(nodes: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Per-element consistent mass M_e = A/12 * [[2,1,1],[1,2,1],[1,1,2]]."""
    p = nodes[triangles]
    d1 = p[:, 1] - p[:, 0]
    d2 = p[:, 2] - p[:, 0]
    area = 0.5 * (d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])
    base = (np.ones((3, 3)) + np.eye(3)) / 12.0
    return area[:, None, None] * base[None]


def edge_mass(nodes: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Per-edge P1 boundary mass M_e = L/6 * [[2,1],[1,2]] (for Robin terms
    and nodal-data boundary loads)."""
    pa = nodes[edges[:, 0]]
    pb = nodes[edges[:, 1]]
    length = np.linalg.norm(pb - pa, axis=1)
    base = np.array([[2.0, 1.0], [1.0, 2.0]]) / 6.0
    return length[:, None, None] * base[None]


def edge_load(nodes: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Per-edge load for unit flux: L/2 * [1, 1]."""
    pa = nodes[edges[:, 0]]
    pb = nodes[edges[:, 1]]
    length = np.linalg.norm(pb - pa, axis=1)
    return 0.5 * length[:, None] * np.ones((1, 2))
