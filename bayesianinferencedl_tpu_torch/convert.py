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

``full_field_from_arrays`` does the same for a full-field pipeline
(``api_full_field.py``): the RFF field's ``features`` (n, M) with its
frequencies ``rff_W`` (2, M) and phases ``rff_b`` (M,), optionally the
nodal coefficient tensor ``G`` (n, 7, 7) (else assembled anew), the
affinized ROM's ``W`` (n, m_k), Ahat (m_k, r, r), Mhat, Fhat, Bhat, V, P0,
the MLP layers, the normaliser and rom_pcg_iters, with the build's scalars
as keywords.

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
from bayesianinferencedl_tpu_torch.models.surrogate import MLP, Normalizer, TrainedSurrogate


def pipeline_from_arrays(cfg, arrays: dict, *, device="cuda", dtype=torch.float32, fin=None) -> Pipeline:
    """``Pipeline.from_arrays`` (the unpacking ``Pipeline.load`` shares), with
    no error dataset; fin: the pipeline's own prebuilt fin (a sensor design's,
    ``infer.oed.with_sensor_qoi``) instead of the config's."""
    return Pipeline.from_arrays(cfg, arrays, device=device, dtype=dtype, fin=fin)


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


def full_field_from_arrays(arrays: dict, *, resolution: int, biot: float = 0.1, ell: float = 1.0,
                           sigma: float = 0.5, mean: float = 0.0, seed: int = 0,
                           cg_tol: float = 1e-7, cg_maxiter: int = 2000,
                           online_precision: str = "highest", activation: str = "tanh",
                           device="cuda", dtype=torch.float32):
    """A ``FullFieldPipeline`` from a full-field pipeline's arrays (the keys
    of the module docstring), its mesh, nodal operator and deflation basis
    rebuilt at ``resolution``. A pipeline without the ROM keys comes back
    forward_only (rom, surrogate and P0 None)."""
    from bayesianinferencedl_tpu_torch.api_full_field import FullFieldPipeline, _kernel_deflation, _nodal_fin
    from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
    from bayesianinferencedl_tpu_torch.models.full_field import RandomField
    from bayesianinferencedl_tpu_torch.rom.nonaffine import AffinizedReducedOperator
    from bayesianinferencedl_tpu_torch.utils.precision import check_tier

    t = lambda k: torch.tensor(np.asarray(arrays[k]), dtype=dtype, device=device)
    mesh, host, _, op, assembler = _nodal_fin(resolution, biot, dtype, torch.device(device))
    if "G" in arrays:
        op = type(op)(base=op.base, G=t("G"))
    field = RandomField(features=t("features"), sigma=float(sigma), mean=float(mean),
                        W=t("rff_W"), b=t("rff_b"))
    if field.features.shape[0] != op.n:
        raise ValueError(f"the features have {field.features.shape[0]} rows, the res{resolution} "
                         f"operator {op.n}")
    rom = surrogate = P0 = None
    if "Ahat" in arrays:
        rom = AffinizedReducedOperator(W=t("W"), Ahat=t("Ahat"), Mhat=t("Mhat"), Fhat=t("Fhat"),
                                       Bhat=t("Bhat"), V=t("V"), biot=float(biot))
        n_layers = sum(1 for k in arrays if k[0] == "W" and k[1:].isdigit())
        surrogate = TrainedSurrogate(
            mlp=MLP.from_params([(t(f"W{i}"), t(f"b{i}")) for i in range(n_layers)], activation),
            norm=Normalizer(*(t(k) for k in ("x_mean", "x_std", "y_mean", "y_std"))))
        P0 = t("P0")
    return FullFieldPipeline(
        op=op, field=field, rom=rom, surrogate=surrogate,
        prior=GaussianPrior.iid(field.n_features, mean=0.0, sigma=1.0, dtype=dtype, device=device),
        P0=P0, rom_pcg_iters=int(np.asarray(arrays.get("rom_pcg_iters", 25))), cg_tol=cg_tol,
        cg_maxiter=cg_maxiter, deflation=_kernel_deflation(host, op, biot),
        rom_precision=check_tier(online_precision), ell=float(ell), seed=int(seed),
        biot=float(biot), mesh=mesh, assembler=assembler,
    )
