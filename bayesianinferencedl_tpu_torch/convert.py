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

``flow_from_arrays`` does the same for a normalizing flow (infer/flow.py):
the reference's flow parameters ``{"mu" (d,), "raw" (d, d), "couplings":
[[(W (in, out), b (out,)), ...], ...]}`` become a ``CouplingFlow``, or, with
``ref=(mean, chol)``, a ``FlowVIResult`` in that frame.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.api import Pipeline, make_prior
from bayesianinferencedl_tpu_torch.infer.flow import CouplingFlow, FlowVIResult
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


def flow_from_arrays(arrays: dict, *, ref=None, device="cuda", dtype=torch.float32):
    """The flow whose parameters are ``arrays`` (dim, couplings and width read
    off their shapes); with ref=(mean (d,), chol (d, d)) a FlowVIResult in
    that frame, its trace empty and its summary the frame's (mean, I)."""
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    couplings = arrays["couplings"]
    mu = t(arrays["mu"])
    d = mu.shape[0]
    hidden = int(np.asarray(couplings[0][0][0]).shape[1]) if couplings else 1
    flow = CouplingFlow(d, len(couplings), hidden, generator=torch.Generator(device=device),
                        dtype=dtype, device=device)  # its draws are overwritten below
    with torch.no_grad():
        flow.mu.copy_(mu)
        flow.raw.copy_(t(arrays["raw"]))
        for mlp, layers in zip(flow.couplings, couplings):
            for p, a in zip(mlp.params(), [x for W, b in layers for x in (W, b)]):
                p.copy_(t(a))
    if ref is None:
        return flow
    ref_mean, ref_chol = (t(r) for r in ref)
    return FlowVIResult(flow=flow, ref_mean=ref_mean, ref_chol=ref_chol, elbo_trace=mu.new_zeros((0,)),
                        theta_mean=ref_mean.clone(), theta_cov=torch.eye(d, dtype=dtype, device=device),
                        n_forward=0)
