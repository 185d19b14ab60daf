"""Snapshot generation: parameter sampling for the snapshot and dataset
sweeps, and ``generate_snapshots``, the batched plain-PCG FOM solve of a fin
the stencil kernels do not carry (the ELL layout; ``api.make_fom_solver``
routes the rest)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from bayesianinferencedl_tpu_torch.fem.solve import pcg_fom


def sample_log_uniform(
    gen: torch.Generator, n: int, dim: int = 5, lo: float = 0.1, hi: float = 10.0,
    dtype=torch.float32,
) -> torch.Tensor:
    """Log-uniform conductivity samples on [lo, hi]^dim, drawn on the
    generator's device."""
    u = torch.rand((n, dim), generator=gen, device=gen.device, dtype=dtype)
    return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))


def generate_snapshots(op, ks: torch.Tensor, *, tol: float = 1e-10, maxiter: int = 3000,
                       chunk: Optional[int] = None) -> torch.Tensor:
    """Solve the FOM at each parameter sample ks (N, 5): (N, n) snapshots,
    through the plain PCG of ``fem/solve.py`` (each sample stops at its own
    tolerance). ``chunk`` splits the batch to bound peak memory: an ELL
    solve gathers (B, n, L) values, ~1 GB in float32 at res16 with B = 256.
    The result does not depend on it."""
    ks = torch.as_tensor(ks, dtype=op.dtype, device=op.device)
    step = max(1, ks.shape[0] if chunk is None else int(chunk))
    parts = [pcg_fom(op, kc, op.F_root.expand(kc.shape[0], -1), tol=tol, maxiter=maxiter)[0]
             for kc in ks.split(step)]
    return torch.cat(parts) if parts else ks.new_zeros((0, op.n))
