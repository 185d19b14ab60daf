"""Carry a built pipeline's weights and state across from plain arrays.

``pipeline_from_arrays`` turns the arrays of a pipeline built elsewhere
(for example the JAX reference, via ``np.asarray`` on its fields) into a
port ``Pipeline`` that computes the same forward maps. The dict holds:

    Ahat (5, r, r), Mhat (r, r), Fhat (r,), Bhat (n_obs, r), V (n, r)
    P0 (r, r)                                the reduced preconditioner
    W0, b0, W1, b1, ...                      MLP layers, W (in, out)
    x_mean, x_std, y_mean, y_std             the surrogate's normaliser
    rom_pcg_iters                            deployed reduced-PCG iterations

The mesh and FOM are rebuilt from ``cfg`` (meshes are deterministic).
"""

from __future__ import annotations

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.api import Pipeline, make_prior
from bayesianinferencedl_tpu_torch.models.corrected import CorrectedForward
from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
from bayesianinferencedl_tpu_torch.models.surrogate import MLP, Normalizer, TrainedSurrogate
from bayesianinferencedl_tpu_torch.rom.galerkin import ReducedOperator


def pipeline_from_arrays(cfg, arrays: dict, *, device="cuda", dtype=torch.float32) -> Pipeline:
    t = lambda k: torch.tensor(np.asarray(arrays[k]), dtype=dtype, device=device)
    fin = FiveParamFin.create(
        resolution=cfg.mesh.resolution, biot=cfg.fem.biot, dtype=dtype, device=device,
        cg_tol=cfg.fem.cg_tol, cg_maxiter=cfg.fem.cg_maxiter,
    )
    rom = ReducedOperator(
        Ahat=t("Ahat"), Mhat=t("Mhat"), Fhat=t("Fhat"), Bhat=t("Bhat"), V=t("V"),
        biot=float(cfg.fem.biot),
    )
    n_layers = sum(1 for k in arrays if k.startswith("W") and k[1:].isdigit())
    if n_layers == 0:
        raise ValueError("arrays hold no MLP layers (W0, b0, ...)")
    mlp = MLP.from_params(
        [(t(f"W{i}"), t(f"b{i}")) for i in range(n_layers)], cfg.surrogate.activation
    )
    norm = Normalizer(x_mean=t("x_mean"), x_std=t("x_std"), y_mean=t("y_mean"), y_std=t("y_std"))
    surrogate = TrainedSurrogate(mlp=mlp, norm=norm)
    return Pipeline(
        config=cfg, fin=fin, rom=rom, surrogate=surrogate,
        corrected=CorrectedForward(rom=rom, surrogate=surrogate), dataset=None,
        prior=make_prior(cfg.prior, dtype, device), P0=t("P0"),
        rom_pcg_iters=int(np.asarray(arrays["rom_pcg_iters"])),
    )
