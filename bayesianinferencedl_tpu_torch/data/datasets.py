"""Training-set generation for the ROM-error surrogate: one batched FOM
sweep and one batched ROM sweep; the targets are e = y_FOM - y_ROM."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from bayesianinferencedl_tpu_torch.rom.galerkin import ReducedOperator
from bayesianinferencedl_tpu_torch.rom.snapshots import sample_log_uniform


class ErrorDataset(NamedTuple):
    log_k: torch.Tensor  # (N, 5) inputs (log-conductivity)
    error: torch.Tensor  # (N, m) targets y_FOM - y_ROM
    y_fom: torch.Tensor  # (N, m)
    y_rom: torch.Tensor  # (N, m)


def generate_error_dataset(
    op,
    rom: ReducedOperator,
    gen: torch.Generator,
    n_samples: int,
    *,
    fom_solver: Callable[[torch.Tensor], torch.Tensor],
    rom_forward: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> ErrorDataset:
    """fom_solver: batched ks -> u (B, n) (K1, K3r, K4r or K4c through
    ``api.make_fom_solver``). rom_forward: batched ks -> y (B, m), default
    the Cholesky ``rom.forward``; pass the deployed ``rom.fast_forward`` so
    the surrogate learns the error of the path the chains evaluate."""
    ks = sample_log_uniform(gen, n_samples, dtype=op.dtype)
    y_fom = op.observe(fom_solver(ks))
    y_rom = (rom_forward or rom.forward)(ks)
    return ErrorDataset(log_k=torch.log(ks), error=y_fom - y_rom, y_fom=y_fom, y_rom=y_rom)
