"""The corrected forward model G~(k) = y_ROM(k) + NN(k)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from bayesianinferencedl_tpu_torch.models.surrogate import TrainedSurrogate
from bayesianinferencedl_tpu_torch.rom.galerkin import ReducedOperator


class CorrectedForward(NamedTuple):
    """Batched callable: log_k (C, 5) -> y_ROM(exp(log_k)) + e_hat(log_k),
    with the Cholesky reduced solve (the reference form); differentiable=True
    keeps the surrogate's graph (the ROM term is differentiable always)."""

    rom: ReducedOperator
    surrogate: TrainedSurrogate

    def __call__(self, log_ks: torch.Tensor, *, differentiable: bool = False) -> torch.Tensor:
        return (self.rom.forward(torch.exp(log_ks))
                + self.surrogate.predict(log_ks, differentiable=differentiable))
