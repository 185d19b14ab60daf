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


class BoxPrior(NamedTuple):
    """Uniform or log-uniform prior on k over the box [low, high]^d, in
    unbounded coordinates z whose reference measure is N(0, I).

    is_log[i] = 1.0: log-uniform on k_i; 0.0: uniform on k_i. Mixed
    per-component kinds are allowed (build the tuple directly).

    The probit map is exact: z ~ N(0, I) gives k = T(z) the box
    distribution, so pCN in z with the plain data misfit targets the right
    posterior, with no Jacobian term (the prior is the reference measure).
    Every forward composes ``to_theta``; the samplers see only z, through
    mean = 0 and chol = I. In float32, Phi(z) saturates for |z| > ~5.3,
    which only clamps k to the box's edge."""

    mean: torch.Tensor  # (d,) zeros: the z-space reference mean (pCN's m)
    chol: torch.Tensor  # (d, d) identity: the z-space reference Cholesky factor
    low: torch.Tensor  # (d,) lower bounds on k
    high: torch.Tensor  # (d,) upper bounds on k
    is_log: torch.Tensor  # (d,) 1.0 log-uniform, 0.0 uniform

    @classmethod
    def create(cls, dim: int, low: float = 0.1, high: float = 10.0, kind: str = "log_uniform",
               dtype=torch.float32, device="cuda") -> "BoxPrior":
        """The box [low, high]^dim of one kind on ``device`` (the card unless
        the caller asks for "cpu")."""
        if kind not in ("uniform", "log_uniform"):
            raise ValueError(f"kind must be 'uniform' or 'log_uniform', got {kind!r}")
        device = resolve_device(device)
        full = lambda v: torch.full((dim,), v, dtype=dtype, device=device)
        return cls(mean=full(0.0), chol=torch.eye(dim, dtype=dtype, device=device), low=full(low),
                   high=full(high), is_log=full(1.0 if kind == "log_uniform" else 0.0))

    @property
    def dim(self) -> int:
        return self.mean.shape[0]

    # the z-space reference measure, what the samplers see
    def sample(self, gen: torch.Generator, shape: tuple = ()) -> torch.Tensor:
        return torch.randn((*shape, self.dim), generator=gen, dtype=self.mean.dtype,
                           device=self.mean.device)

    def log_density(self, z: torch.Tensor) -> torch.Tensor:
        return -0.5 * torch.sum(z * z, -1)

    def whiten(self, z: torch.Tensor) -> torch.Tensor:
        return z

    def unwhiten(self, z: torch.Tensor) -> torch.Tensor:
        return z

    def precision_apply(self, v: torch.Tensor) -> torch.Tensor:
        return v

    # the push-forward
    def to_theta(self, z: torch.Tensor) -> torch.Tensor:
        """z -> theta = log k, elementwise (any batch shape)."""
        u = torch.special.ndtr(z)
        # a uniform prior may have low <= 0: keep the unselected log-uniform
        # branch finite, or its -inf / NaN leaks into torch.where's gradient
        # (0 * NaN = NaN in the backward)
        safe_lo = torch.clamp(self.low, min=torch.finfo(z.dtype).tiny)
        log_lo, log_hi = torch.log(safe_lo), torch.log(self.high)
        theta_log = log_lo + (log_hi - log_lo) * u
        theta_lin = torch.log(self.low + (self.high - self.low) * u)
        return torch.where(self.is_log > 0.5, theta_log, theta_lin)

    def from_theta(self, theta: torch.Tensor) -> torch.Tensor:
        """theta = log k -> z (the probit inverse), to start chains at a known
        conductivity; u is clipped to [1e-6, 1 - 1e-6] to keep ndtri finite."""
        log_lo, log_hi = torch.log(self.low), torch.log(self.high)
        u_log = (theta - log_lo) / (log_hi - log_lo)
        u_lin = (torch.exp(theta) - self.low) / (self.high - self.low)
        u = torch.where(self.is_log > 0.5, u_log, u_lin)
        return torch.special.ndtri(torch.clamp(u, 1e-6, 1 - 1e-6))
