"""Parameter sampling for the snapshot and dataset sweeps (the solves are
``api.make_fom_solver``)."""

from __future__ import annotations

import math

import torch


def sample_log_uniform(
    gen: torch.Generator, n: int, dim: int = 5, lo: float = 0.1, hi: float = 10.0,
    dtype=torch.float32,
) -> torch.Tensor:
    """Log-uniform conductivity samples on [lo, hi]^dim, drawn on the
    generator's device."""
    u = torch.rand((n, dim), generator=gen, device=gen.device, dtype=dtype)
    return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
