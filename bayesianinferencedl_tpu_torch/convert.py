"""Carry a built pipeline's weights and state across from plain arrays.

``pipeline_from_arrays`` turns the arrays of a pipeline built elsewhere
(for example the JAX reference, via ``np.asarray`` on its fields) into a
port ``Pipeline`` that computes the same forward maps. The dict holds:

    Ahat (5, r, r), Mhat (r, r), Fhat (r,), Bhat (n_obs, r), V (n, r)
    P0 (r, r)                                the reduced preconditioner
    W0, b0, W1, b1, ...                      MLP layers, W (in, out)
    x_mean, x_std, y_mean, y_std             the surrogate's normaliser
    rom_pcg_iters                            deployed reduced-PCG iterations

The mesh and FOM are rebuilt from ``cfg`` (meshes are deterministic), and
the online tier is cfg.rom.online_precision.

``flow_from_arrays`` does the same for a normalizing flow (infer/flow.py):
the reference's flow parameters ``{"mu" (d,), "raw" (d, d), "couplings":
[[(W (in, out), b (out,)), ...], ...]}`` become a ``CouplingFlow``, or, with
``ref=(mean, chol)``, a ``FlowVIResult`` in that frame.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.api import Pipeline
from bayesianinferencedl_tpu_torch.infer.flow import CouplingFlow, FlowVIResult


def pipeline_from_arrays(cfg, arrays: dict, *, device="cuda", dtype=torch.float32) -> Pipeline:
    """``Pipeline.from_arrays`` (the unpacking ``Pipeline.load`` shares), with
    no error dataset."""
    return Pipeline.from_arrays(cfg, arrays, device=device, dtype=dtype)


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
