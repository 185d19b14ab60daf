"""Priors for the inverse problem, in working coordinates theta = log k."""

from __future__ import annotations

from typing import NamedTuple

import torch

from bayesianinferencedl_tpu_torch.utils.device import resolve_device
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul


class GaussianPrior(NamedTuple):
    """N(mean, C) with C given by its Cholesky factor (C = L L^T)."""

    mean: torch.Tensor  # (d,)
    chol: torch.Tensor  # (d, d) lower-triangular

    @classmethod
    def iid(cls, dim: int, mean: float = 0.0, sigma: float = 0.6, dtype=torch.float32, device="cuda"):
        """N(mean, sigma^2 I) on ``device`` (the card unless the caller asks
        for "cpu")."""
        device = resolve_device(device)
        return cls(
            mean=torch.full((dim,), mean, dtype=dtype, device=device),
            chol=torch.eye(dim, dtype=dtype, device=device) * sigma,
        )

    @property
    def dim(self) -> int:
        return self.mean.shape[0]

    def sample(self, gen: torch.Generator, shape: tuple = ()) -> torch.Tensor:
        z = torch.randn((*shape, self.dim), generator=gen, dtype=self.mean.dtype, device=self.mean.device)
        with fp32_matmul():
            return self.mean + z @ self.chol.T

    def whiten(self, theta: torch.Tensor) -> torch.Tensor:
        """L^-1 (theta - mean) over the last axis, by a triangular solve."""
        v = (theta - self.mean)[..., None]
        return torch.linalg.solve_triangular(self.chol, v, upper=False)[..., 0]

    def to_theta(self, theta: torch.Tensor) -> torch.Tensor:
        """Working coordinates ARE theta = log k for the Gaussian prior."""
        return theta


class BoxPrior:
    """Uniform / log-uniform prior on k as a probit push-forward: not ported
    yet (ROADMAP.md queue 1, item 9)."""

    @classmethod
    def create(cls, *args, **kwargs):
        raise NotImplementedError(
            "BoxPrior (uniform / log_uniform priors) is not ported yet: ROADMAP.md queue 1, item 9"
        )
