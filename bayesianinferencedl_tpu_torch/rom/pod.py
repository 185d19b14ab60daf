"""POD basis construction (method of snapshots: the eigendecomposition of
the (N, N) Gram matrix of N row-stacked snapshots, V = S^T W / sqrt(lambda)).

- ``pod_basis`` runs on the snapshots' device in their dtype, the route of a
  fin with no host float64 algebra (the ELL layout, ``build_pipeline``);
- ``pod_basis_host`` runs in host float64 whatever the snapshots' dtype, the
  stencil fin's offline route.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul


class PODResult(NamedTuple):
    V: torch.Tensor  # (n, r) orthonormal basis
    singular_values: torch.Tensor  # (N,) the full spectrum
    energy: torch.Tensor  # (N,) cumulative energy fraction


def pod_basis(snapshots: torch.Tensor, r: int) -> PODResult:
    """Leading-r POD basis of row-stacked snapshots (N, n), on their device
    and in their dtype, every product in full fp32. In float32 the Gram
    matrix's condition number kappa(S)^2 loses every mode below ~sqrt(eps32)
    relative energy (``pod_basis_host`` keeps them)."""
    S = snapshots
    with fp32_matmul():
        G = S @ S.T  # (N, N) Gram
    w, W = torch.linalg.eigh(G)  # ascending
    w = w.flip(0)
    W = W.flip(1)
    w_pos = torch.clamp(w, min=0.0)
    sv = torch.sqrt(w_pos)
    tiny = torch.finfo(S.dtype).tiny
    inv = torch.where(sv > sv[0] * 1e-12, 1.0 / torch.clamp(sv, min=tiny), 0.0)
    with fp32_matmul():
        V = S.T @ (W[:, :r] * inv[:r][None, :])  # (n, r)
    energy = torch.cumsum(w_pos, 0) / torch.clamp(torch.sum(w_pos), min=tiny)
    return PODResult(V=V, singular_values=sv, energy=energy)


def orthonormality_error(V: torch.Tensor) -> torch.Tensor:
    """max |V^T V - I|, in full fp32."""
    with fp32_matmul():
        G = V.T @ V
    return torch.max(torch.abs(G - torch.eye(V.shape[1], dtype=V.dtype, device=V.device)))


def pod_basis_host(snapshots, r: int):
    """Leading-r POD basis of row-stacked snapshots (N, n), in host float64
    whatever the snapshot dtype or device (method of snapshots: eigh of the
    (N, N) Gram matrix, whose condition number is kappa(S)^2 — float32
    would lose every mode below ~sqrt(eps32) relative energy).

    Returns (V: (n, r) float64 ndarray, singular_values: (N,) ndarray)."""
    if isinstance(snapshots, torch.Tensor):
        snapshots = snapshots.detach().cpu().numpy()
    S = np.asarray(snapshots, dtype=np.float64)
    G = S @ S.T
    w, W = np.linalg.eigh(G)
    w = w[::-1]
    W = W[:, ::-1]
    w_pos = np.maximum(w, 0.0)
    sv = np.sqrt(w_pos)
    inv = np.where(sv > sv[0] * 1e-14, 1.0 / np.maximum(sv, np.finfo(np.float64).tiny), 0.0)
    V = S.T @ (W[:, :r] * inv[:r][None, :])
    # one Gram-Schmidt pass to clean the trailing modes
    Q, _ = np.linalg.qr(V)
    return Q, sv
