"""Training-set generation for the ROM-error surrogate: one batched FOM
sweep and one batched ROM sweep; the targets are e = y_FOM - y_ROM."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from bayesianinferencedl_tpu_torch.rom.galerkin import ReducedOperator
from bayesianinferencedl_tpu_torch.rom.snapshots import generate_snapshots, sample_log_uniform


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
    lo: float = 0.1,
    hi: float = 10.0,
    tol: float = 1e-10,
    maxiter: int = 3000,
    chunk: Optional[int] = None,
    fom_solver: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    rom_forward: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> ErrorDataset:
    """ks log-uniform on [lo, hi]^5. fom_solver: batched ks -> u (B, n)
    (K1, K3r, K4r or K4c through ``api.make_fom_solver``); default the plain
    PCG of ``fem/solve.py`` at ``tol`` and ``maxiter`` (``generate_snapshots``),
    over ``chunk`` samples at a time if given (memory only: the values do
    not depend on it). rom_forward: batched ks -> y (B, m), default the Cholesky
    ``rom.forward``; pass the deployed ``rom.fast_forward`` so the surrogate
    learns the error of the path the chains evaluate."""
    ks = sample_log_uniform(gen, n_samples, lo=lo, hi=hi, dtype=op.dtype)
    if fom_solver is None:
        fom_solver = lambda k: generate_snapshots(op, k, tol=tol, maxiter=maxiter, chunk=chunk)
    y_fom = op.observe(fom_solver(ks))
    y_rom = (rom_forward or rom.forward)(ks)
    return ErrorDataset(log_k=torch.log(ks), error=y_fom - y_rom, y_fom=y_fom, y_rom=y_rom)
