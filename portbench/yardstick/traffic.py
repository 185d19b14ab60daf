"""Draws of the benchmark's traffic, made from the run's seed.

``sample_log_uniform`` is a frozen copy of
``bayesianinferencedl_tpu_torch/rom/snapshots.sample_log_uniform``, the draw
of conductivities the package's own snapshot and dataset sweeps use.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sample_log_uniform(gen: torch.Generator, n: int, dim: int = 5, lo: float = 0.1,
                       hi: float = 10.0, dtype=torch.float32) -> torch.Tensor:
    """Log-uniform conductivity samples on [lo, hi]^dim, drawn on the
    generator's device."""
    u = torch.rand((n, dim), generator=gen, device=gen.device, dtype=dtype)
    return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))


def sub_seeds(seed: int, n: int) -> list[int]:
    """n independent 63-bit seeds derived from the run's seed (any whole
    number, negative or beyond 64 bits included)."""
    words = np.random.SeedSequence(abs(int(seed)) * 2 + (seed < 0)).generate_state(2 * n, np.uint32)
    return [int(words[2 * i]) << 31 ^ int(words[2 * i + 1]) for i in range(n)]
