"""Greedy reduced-basis construction.

The outer loop is sequential (each iteration adds the FOM solution at the
worst-approximated candidate), so it is a short host loop; the error
indicator over the whole candidate set is one batched residual per
iteration (``ReducedOperator.residual_norm``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.fem.solve import pcg_fom
from bayesianinferencedl_tpu_torch.rom.galerkin import ReducedOperator
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul


class GreedyResult(NamedTuple):
    V: torch.Tensor  # (n, r) orthonormal basis in the working dtype
    selected: np.ndarray  # (r,) the chosen candidates' indices
    indicators: np.ndarray  # (r,) the largest indicator at each iteration
    # (n, r) the basis columns as built: the first FOM solution (unnormalised),
    # then the orthonormalised residual directions of the selected solutions,
    # for orthonormalize_host
    snapshots: np.ndarray


def greedy_basis(op, candidates: torch.Tensor, r: int, *, tol: float = 1e-10, maxiter: int = 3000,
                 seed_index: int = 0, solve: Optional[Callable] = None) -> GreedyResult:
    """An r-dimensional basis by greedy selection over ``candidates`` (N, 5):
    project, sweep the residual indicator over the candidates, pick the
    largest, solve the FOM there, Gram-Schmidt the solution into V (twice,
    in full fp32: a reduced-precision product leaves cross-terms that ruin
    the basis). solve: k (5,) -> u (n,), by default the plain PCG of
    ``fem/solve.py`` at tol / maxiter (``api.build_pipeline`` passes its
    batched stencil-kernel solver). A candidate already in span(V) ends the
    loop early."""
    if solve is None:
        solve = lambda k: pcg_fom(op, k, op.F_root, tol=tol, maxiter=maxiter)[0]
    candidates = torch.as_tensor(candidates, dtype=op.dtype, device=op.device)
    u0 = solve(candidates[seed_index])
    V = (u0 / torch.linalg.norm(u0))[:, None]
    selected = [int(seed_index)]
    indicators = [float(torch.linalg.norm(u0))]
    snaps = [u0.detach().cpu().numpy().astype(np.float64)]
    for _ in range(1, r):
        rom = ReducedOperator.project(op, V)
        ind = rom.residual_norm(op, candidates).cpu().numpy().copy()
        # never re-select: a noise-floored indicator could re-pick a candidate
        # already in span(V) and degenerate the basis
        ind[np.asarray(selected)] = -np.inf
        j = int(np.argmax(ind))
        indicators.append(float(ind[j]))
        selected.append(j)
        u = solve(candidates[j])
        with fp32_matmul():
            for _ in range(2):
                u = u - V @ (V.T @ u)
        nrm = torch.linalg.norm(u)
        if float(nrm) < 1e-6 * indicators[0]:
            break  # the candidate is already represented: the basis is saturated
        V = torch.cat([V, (u / nrm)[:, None]], 1)
        snaps.append((u / nrm).detach().cpu().numpy().astype(np.float64))
    return GreedyResult(V=V, selected=np.array(selected), indicators=np.array(indicators),
                        snapshots=np.stack(snaps, axis=1))


def orthonormalize_host(snapshots: np.ndarray) -> np.ndarray:
    """A float64 host QR of the greedy basis columns: the device
    Gram-Schmidt at the working dtype leaves float32-floor cross-terms in
    V^T V, which the host QR removes (the span is the device's), giving the
    greedy basis the POD path's float64 offline projection."""
    Q, _ = np.linalg.qr(np.asarray(snapshots, np.float64))
    return Q
