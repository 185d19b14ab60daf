"""POD basis construction, in float64 on the host."""

from __future__ import annotations

import numpy as np
import torch


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
