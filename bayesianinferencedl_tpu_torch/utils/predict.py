"""Posterior push-forward prediction: uncertainty on quantities that were
never measured.

The parameter posterior implies a posterior over any derived quantity: the
whole temperature field, the reading a thermocouple would take where none
was placed. The uncertainty has two parts:

- epistemic: the spread of u(x; theta) over posterior draws (it shrinks
  with more or better data, which ``infer/oed.py`` designs);
- aleatoric: the noise a new measurement at x would add (reported only when
  the caller passes ``noise_sigma``).

The draws' fields come from one batched FOM sweep (``api.predict_temperature``);
the statistics are host order statistics. Point values are exact P1
interpolation: the containing triangle's three nodes, weighted
barycentrically (exact for the FEM solution, which is piecewise linear).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def interp_rows(mesh, points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """P1 interpolation rows for in-domain points (P, 2): (ids, w), (P, 3)
    mesh-node ids and barycentric weights with u(points[p]) = sum_j w[p, j]
    u_nodes[ids[p, j]]. A brute-force host search over the triangles (the
    points are few, offline); a point outside the fin raises ValueError
    naming it."""
    pts = np.atleast_2d(np.asarray(points, np.float64))
    if pts.shape[-1] != 2:
        raise ValueError(f"points must be (P, 2), got {pts.shape}")
    tri = np.asarray(mesh.triangles)
    xy = np.asarray(mesh.nodes, np.float64)
    a, b, c = xy[tri[:, 0]], xy[tri[:, 1]], xy[tri[:, 2]]
    # barycentric solve: [b - a | c - a] [l1 l2]^T = p - a
    m00, m01 = b[:, 0] - a[:, 0], c[:, 0] - a[:, 0]
    m10, m11 = b[:, 1] - a[:, 1], c[:, 1] - a[:, 1]
    det = m00 * m11 - m01 * m10
    ids = np.empty((pts.shape[0], 3), np.int64)
    w = np.empty((pts.shape[0], 3), np.float64)
    eps = 1e-9
    for p_i, p in enumerate(pts):
        rx, ry = p[0] - a[:, 0], p[1] - a[:, 1]
        l1 = (m11 * rx - m01 * ry) / det
        l2 = (-m10 * rx + m00 * ry) / det
        l0 = 1.0 - l1 - l2
        inside = (l0 >= -eps) & (l1 >= -eps) & (l2 >= -eps)
        if not inside.any():
            raise ValueError(f"prediction point {tuple(p)} lies outside the fin domain")
        t = int(np.argmax(inside))
        ids[p_i] = tri[t]
        w[p_i] = np.clip([l0[t], l1[t], l2[t]], 0.0, 1.0)
        w[p_i] /= w[p_i].sum()
    return ids, w


def _stats(draws: np.ndarray) -> dict:
    """(D, ...) draws -> {mean, std, q05, q50, q95} over the draw axis."""
    q = np.quantile(draws, [0.05, 0.5, 0.95], axis=0)
    return {"mean": draws.mean(axis=0), "std": draws.std(axis=0), "q05": q[0], "q50": q[1], "q95": q[2]}


@dataclass
class FieldPrediction:
    """The posterior predictive summary of a nodal field, and of points.

    Node arrays are in mesh-node order ((n_nodes,), mapped back from the
    solver's padded layout), coordinates in ``node_xy``; point arrays (P,)
    in the order the points were given. ``point_pred_std``, present only
    when noise_sigma was given, is the predictive sd of a new measurement
    at the point: the epistemic spread and noise_sigma in quadrature."""

    node_xy: np.ndarray
    mean: np.ndarray
    std: np.ndarray
    q05: np.ndarray
    q50: np.ndarray
    q95: np.ndarray
    n_draws: int
    points: Optional[np.ndarray] = None
    point_mean: Optional[np.ndarray] = None
    point_std: Optional[np.ndarray] = None
    point_q05: Optional[np.ndarray] = None
    point_q50: Optional[np.ndarray] = None
    point_q95: Optional[np.ndarray] = None
    point_pred_std: Optional[np.ndarray] = None
    point_draws: Optional[np.ndarray] = None  # (D, P)

    def save_npz(self, path) -> None:
        np.savez(path, **{f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                          if getattr(self, f.name) is not None})

    def summary_rows(self) -> list[dict]:
        """One dict a prediction point."""
        if self.points is None:
            return []
        rows = []
        for i, p in enumerate(self.points):
            row = {"x": float(p[0]), "y": float(p[1]), "mean": float(self.point_mean[i]),
                   "sd": float(self.point_std[i]), "q05": float(self.point_q05[i]),
                   "q95": float(self.point_q95[i])}
            if self.point_pred_std is not None:
                row["pred_sd"] = float(self.point_pred_std[i])
            rows.append(row)
        return rows


def predict_field(u_draws, sol_idx: np.ndarray, mesh, *, points: Optional[np.ndarray] = None,
                  noise_sigma: Optional[float] = None) -> FieldPrediction:
    """Summarise posterior field draws u_draws (D, n_solver), in the
    solver's layout, into a FieldPrediction; sol_idx (n_nodes,) indexes each
    mesh node in that layout (``infer.oed.solution_indices``). points:
    optional (P, 2) coordinates for exact P1 point prediction."""
    if isinstance(u_draws, torch.Tensor):
        u_draws = u_draws.detach().cpu().numpy()
    u_nodes = np.asarray(u_draws)[:, np.asarray(sol_idx)]
    pred = FieldPrediction(node_xy=np.asarray(mesh.nodes), n_draws=u_nodes.shape[0], **_stats(u_nodes))
    if points is None:
        return pred
    ids, w = interp_rows(mesh, points)
    pd = np.einsum("dpj->dp", u_nodes[:, ids] * w[None])
    ps = _stats(pd)
    return dataclasses.replace(
        pred, points=np.atleast_2d(np.asarray(points, np.float64)), point_mean=ps["mean"],
        point_std=ps["std"], point_q05=ps["q05"], point_q50=ps["q50"], point_q95=ps["q95"],
        point_draws=pd,
        point_pred_std=None if noise_sigma is None else np.sqrt(ps["std"] ** 2 + float(noise_sigma) ** 2),
    )
