"""Bayesian optimal experimental design: where should the sensors go?

Given candidate pointwise temperature sensors on the fin, choose the
n-sensor subset that maximises the expected information gain of the
linearised (Laplace) posterior,

    EIG(S) = 1/2 E_theta~prior[ log det( I_d + sigma^-2 Jw_S(theta) Jw_S(theta)^T ) ],

with J(theta) = d u(sensors) / d theta the pointwise sensitivity at a prior
draw and Jw = J C^{1/2} absorbing the prior covariance (Bayesian
D-optimality; Chaloner & Verdinelli).

- Sensitivities are exact: per draw one FOM solve and 5 tangent solves
  A(k) w_i = -A_i u on the plain PCG of ``fem/solve.py`` (one batch of B x 5
  systems), w_i at the candidate nodes chained with dk_i / dx. The
  reference takes the same Jacobian by reverse mode, one adjoint solve per
  candidate node; 5 tangents are fewer solves at every candidate count here.
- The greedy selection maximises a submodular set function, so it carries
  the (1 - 1/e) near-optimality guarantee; each pick updates the per-draw
  posterior covariance by Sherman-Morrison over all candidates at once.

``with_sensor_qoi`` turns a design into a fin whose observables are those
sensors, for ``api.build_pipeline(cfg, fin=...)``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.fem.solve import pcg_fom


def mesh_node_grid_ids(mesh) -> np.ndarray:
    """The structured-grid solution index of every mesh node in the stencil
    layout, which numbers the full (nx + 1) x (ny + 1) lattice: u[gid] is
    the temperature at mesh node i."""
    h = 0.25 / mesh.resolution
    ny = 16 * mesh.resolution
    gi = np.rint((mesh.nodes[:, 0] + 3.0) / h).astype(np.int64)
    gj = np.rint(mesh.nodes[:, 1] / h).astype(np.int64)
    return gi * (ny + 1) + gj


def solution_indices(fin) -> np.ndarray:
    """(n_nodes,) index into the solver's u vector of each mesh node: the
    structured-grid ids for the stencil layout, the identity for the ELL
    layout, which numbers u by mesh node."""
    if hasattr(fin.op, "vals_grid"):
        return mesh_node_grid_ids(fin.mesh)
    return np.arange(fin.mesh.n_nodes, dtype=np.int64)


def boundary_candidates(fin) -> np.ndarray:
    """The default candidates: exterior-boundary nodes (where a thermocouple
    could sit), deduplicated, as mesh-node ids."""
    return np.unique(np.asarray(fin.mesh.ext_edges).reshape(-1))


def pointwise_sensitivities(fin, xs: torch.Tensor, node_ids: np.ndarray, *, to_theta=None,
                            tol: float = 1e-9, maxiter: int = 3000) -> torch.Tensor:
    """(B, n_cand, d) exact sensitivities d u(node) / d x at each draw x (B,
    d) in working coordinates (pass the prior's elementwise to_theta, as
    run_inversion composes its misfits; identity if omitted): one FOM solve
    and 5 tangent solves a draw, all at tol / maxiter."""
    op = fin.op
    xs = torch.as_tensor(xs, dtype=op.dtype, device=op.device).detach().requires_grad_(True)
    with torch.enable_grad():
        theta = to_theta(xs) if to_theta is not None else xs
        # d theta_i / d x_i: to_theta is elementwise, so the gradient of the sum is its diagonal
        dtheta = torch.autograd.grad(theta.sum(), xs)[0] if theta.requires_grad else torch.ones_like(xs)
    k = torch.exp(theta.detach())
    B, d = k.shape  # d = 5: a parameter per component A_i
    u, _, _ = pcg_fom(op, k, op.F_root.expand(B, -1), tol=tol, maxiter=maxiter)
    # tangents: A(k) w_i = -A_i u, one system per (draw, component)
    rhs = -torch.stack([op.matvec(op.comp_vals[:, :, i], u) for i in range(d)], 1)  # (B, d, n)
    w, _, _ = pcg_fom(op, k[:, None, :].expand(B, d, d), rhs, tol=tol, maxiter=maxiter)
    idx = torch.as_tensor(solution_indices(fin)[np.asarray(node_ids)], device=op.device)
    return w[:, :, idx].transpose(1, 2) * (k * dtheta)[:, None, :]


@dataclass
class SensorDesign:
    node_ids: np.ndarray  # (n_sensors,) chosen mesh-node ids, greedy order
    xy: np.ndarray  # (n_sensors, 2) coordinates
    eig_trace: np.ndarray  # (n_sensors,) cumulative EIG (nats) after each pick
    gains: np.ndarray  # (n_sensors,) marginal EIG of each pick
    candidates: np.ndarray  # the candidate pool the design was drawn from


def _whiten(J: torch.Tensor, prior_chol: Optional[torch.Tensor]) -> torch.Tensor:
    """Jw = J L (at least float32)."""
    J = torch.as_tensor(J)
    Jw = J if prior_chol is None else torch.einsum("bnd,de->bne", J, torch.as_tensor(prior_chol).to(J))
    return Jw.to(torch.promote_types(J.dtype, torch.float32))


def greedy_eig(J: torch.Tensor, noise_sigma: float, n_sensors: int, *,
               prior_chol: Optional[torch.Tensor] = None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy D-optimal selection. J: (B, n_cand, d) sensitivities in
    working coordinates; prior_chol: (d, d) lower Cholesky factor of the
    prior covariance (identity if omitted). Returns (picked candidate
    indices, cumulative EIG trace, gains). The per-draw posterior precision
    starts at I_d and each pick adds sigma^-2 jw jw^T; its inverse is carried
    by Sherman-Morrison, so every candidate's gain in a round is one
    (B, n_cand, d) contraction."""
    Jw = _whiten(J, prior_chol)
    B, n_cand, d = Jw.shape
    inv_s2 = 1.0 / float(noise_sigma) ** 2
    Minv = torch.eye(d, dtype=Jw.dtype, device=Jw.device).expand(B, d, d)
    picked, gains, trace, total = [], [], [], 0.0
    for _ in range(n_sensors):
        Mj = torch.einsum("bde,bne->bnd", Minv, Jw)
        # Minv is PSD so q >= 0; the clamp drops a negative rounding tail,
        # which would send log1p to NaN and argmax to the NaN candidate
        q = torch.clamp(torch.einsum("bnd,bnd->bn", Mj, Jw), min=0.0)
        # a repeated sensor still gains (it halves that sensor's noise), so no mask
        g = 0.5 * torch.mean(torch.log1p(inv_s2 * q), 0)
        s = int(torch.argmax(g))
        picked.append(s)
        gains.append(float(g[s]))
        total += float(g[s])
        trace.append(total)
        v = Mj[:, s, :]
        denom = 1.0 / inv_s2 + q[:, s]
        Minv = Minv - torch.einsum("bd,be->bde", v, v) / denom[:, None, None]
        Minv = 0.5 * (Minv + Minv.transpose(-1, -2))
    return np.asarray(picked), np.asarray(trace), np.asarray(gains)


def design_sensors(fin, prior, *, n_sensors: int = 5, noise_sigma: float = 1e-2, n_draws: int = 16,
                   candidates: Optional[np.ndarray] = None, gen: Optional[torch.Generator] = None,
                   tol: float = 1e-9, maxiter: int = 3000) -> SensorDesign:
    """The whole design: n_draws prior draws (from gen, default seed 0 on the
    fin's device), exact sensitivities at the candidate nodes (default the
    exterior boundary), n_sensors picked greedily by expected information
    gain, in working coordinates as run_inversion evaluates its misfits."""
    if gen is None:
        gen = torch.Generator(device=fin.op.device).manual_seed(0)
    cand = boundary_candidates(fin) if candidates is None else np.asarray(candidates)
    xs = prior.sample(gen, (n_draws,))
    J = pointwise_sensitivities(fin, xs, cand, to_theta=prior.to_theta, tol=tol, maxiter=maxiter)
    picked, trace, gains = greedy_eig(J, noise_sigma, n_sensors, prior_chol=prior.chol)
    node_ids = cand[picked]
    return SensorDesign(node_ids=node_ids, xy=np.asarray(fin.mesh.nodes[node_ids]), eig_trace=trace,
                        gains=gains, candidates=cand)


def with_sensor_qoi(fin, node_ids: np.ndarray):
    """A FiveParamFin whose observables are the given pointwise sensors
    instead of the five subfin averages: the qoi rows become one-hot
    selectors at the sensors' solution indices, in the device operator and
    in the host assembly, whose qoi the float64 offline projection reads.
    Everything downstream follows op.n_obs / op.observe, so
    ``api.build_pipeline(cfg, fin=with_sensor_qoi(fin, design.node_ids))``
    inverts the designed observables end to end."""
    idx = solution_indices(fin)[np.asarray(node_ids)]
    B = np.zeros((len(idx), fin.op.n), dtype=np.float64)
    B[np.arange(len(idx)), idx] = 1.0
    host = dataclasses.replace(fin.host, qoi=B)
    op = dataclasses.replace(fin.op, qoi=torch.as_tensor(B, dtype=fin.op.dtype, device=fin.op.device))
    return dataclasses.replace(fin, host=host, op=op)


def eig_of_subset(J: torch.Tensor, subset: np.ndarray, noise_sigma: float, *,
                  prior_chol: Optional[torch.Tensor] = None) -> float:
    """The exact EIG of a fixed sensor subset (brute-force oracles, random
    baselines): 1/2 mean_b log det(I + sigma^-2 Jw_S^T Jw_S), d x d."""
    Jw = _whiten(J, prior_chol)[:, torch.as_tensor(np.asarray(subset), device=J.device), :]
    d = Jw.shape[-1]
    M = torch.eye(d, dtype=Jw.dtype, device=Jw.device) + torch.einsum("bnd,bne->bde", Jw, Jw) / float(
        noise_sigma) ** 2
    return float(0.5 * torch.mean(torch.linalg.slogdet(M)[1]))
