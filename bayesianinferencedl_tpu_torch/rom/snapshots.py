"""Parameter sampling and snapshot generation: one batched FOM solve."""

from __future__ import annotations

import math

import torch

from bayesianinferencedl_tpu_torch.ops.pcg_stencil import solve_fom_stencil


def sample_log_uniform(
    gen: torch.Generator, n: int, dim: int = 5, lo: float = 0.1, hi: float = 10.0,
    dtype=torch.float32,
) -> torch.Tensor:
    """Log-uniform conductivity samples on [lo, hi]^dim, drawn on the
    generator's device."""
    u = torch.rand((n, dim), generator=gen, device=gen.device, dtype=dtype)
    return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))


def generate_snapshots(op, ks: torch.Tensor, *, tol: float, maxiter: int, deflation=None) -> torch.Tensor:
    """Solve the FOM at each parameter sample; returns (n_samples, n)."""
    u, _ = solve_fom_stencil(op, ks, tol=tol, maxiter=maxiter, deflation=deflation)
    return u
