"""High-level pipeline API.

``build_pipeline`` runs the offline stack (mesh -> stencil FOM -> batched
FOM snapshots through K1, K3r or K4r / K4c -> host-f64 POD and Galerkin projection ->
reduced preconditioner P0 -> ROM-error dataset -> tanh MLP trained with
Adam) on one device. ``run_inversion`` runs single-temperature pCN (on the
``fom`` likelihood in segments of 64 steps, one batched FOM solve a step),
parallel-tempered pCN (``pt_pcn``) or MALA (``pt_mala``) on ``rom`` or
``rom_nn``, delayed acceptance, plain (``da_pcn``) or tempered
(``pt_da_pcn``), with pCN or MALA subchains on the ``da_coarse`` surrogate
corrected against the ``fom`` likelihood (or ``rom``), one batched FOM solve
per outer step, the Laplace-seeded samplers (``laplace_mh``, ``gpcn``,
``mala_lap``, ``hmc_lap``: the MAP and its Laplace approximation first) and
the gradient samplers ``mala`` and ``hmc``, which take the differentiable
forward (``Pipeline.working_forward_fn(..., differentiable=True)``). With
``infer_noise`` every sampler runs on the noise-marginalised potential.
Tempered runs also return the log evidence. Nothing moves between devices
on its own: asking for ``device="cuda"`` without a card raises.

Chains start from prior draws (the Laplace-seeded samplers from the
Laplace approximation), or with ``init="eki"`` / ``"vi"`` from an EKI
ensemble or a short full-rank ADVI fit. The chains live in the prior's
working coordinates: theta = log k under the Gaussian prior, the probit
coordinates z under a box prior (``PriorConfig.kind`` "uniform" /
"log_uniform"); every forward a sampler or driver evaluates is
``Pipeline.working_forward_fn``, the forward composed with
``prior.to_theta``.

The online reduced solves run at ``ROMConfig.online_precision``: "highest"
(full fp32), "high" (bf16x3) or "fast" (one bf16 pass), per call
(``utils.precision``); ``build_pipeline`` trains the surrogate on the
deployed tier and iteration count. ``Pipeline.save`` / ``Pipeline.load``
keep a built pipeline in the JAX package's npz layout, readable by either
side. The disk-checkpointed, resumable chain runners
(``run_pcn_checkpointed`` and its kin, ``infer/checkpointed.py``) are
exported here, as the reference exports them.

The approximation layer has its own entry points, with ``run_inversion``'s data
contract: ``run_eki_inversion`` (ensemble Kalman inversion, one batched
forward an iteration), ``run_vi_inversion`` (ADVI), ``run_svgd_inversion``
(Stein variational gradient descent), ``psis_certify`` (Pareto-smoothed
importance sampling of any Gaussian fit: one batched forward) and
``run_smc_evidence`` (the log evidence by adaptive tempered SMC, its groups
one batch); the normalizing flow's ``run_flow_vi_inversion`` (tempered SMC
distilled into a coupling flow by maximum likelihood, or annealed
reverse-KL flow-VI), ``psis_certify_flow`` (PSIS with the flow as the
proposal) and ``run_neutra_inversion`` (flow-preconditioned pCN, exact).

Not ported yet, raising ``NotImplementedError`` that names its ROADMAP.md
item: ``mlda_pcn``.
"""

from __future__ import annotations

import math
import time
import warnings
import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.config import PipelineConfig
from bayesianinferencedl_tpu_torch.data.datasets import ErrorDataset, generate_error_dataset
from bayesianinferencedl_tpu_torch.fem.solve import pcg_fom
from bayesianinferencedl_tpu_torch.infer.checkpointed import (  # noqa: F401  (the reference's api exports)
    run_da_checkpointed,
    run_hmc_checkpointed,
    run_mala_checkpointed,
    run_pcn_checkpointed,
    run_pt_checkpointed,
    run_pt_da_checkpointed,
)
from bayesianinferencedl_tpu_torch.infer.delayed_acceptance import DAResult, run_da_pcn_segmented
from bayesianinferencedl_tpu_torch.infer.diagnostics import ess_bulk, ess_tail, split_rhat
from bayesianinferencedl_tpu_torch.infer.eki import EKIResult, run_eki
from bayesianinferencedl_tpu_torch.infer.evidence import log_evidence_from_pt
from bayesianinferencedl_tpu_torch.infer.flow import (
    FlowVIResult,
    flow_fit_pipeline,
    flow_psis_certify,
    run_neutra_pcn,
)
from bayesianinferencedl_tpu_torch.infer.hmc import run_hmc, run_hmc_chees, run_hmc_segmented
from bayesianinferencedl_tpu_torch.infer.mala import MALAResult, run_mala, run_mala_segmented
from bayesianinferencedl_tpu_torch.infer.map import find_map_multistart, laplace_approximation
from bayesianinferencedl_tpu_torch.infer.pcn import (
    PCNResult,
    gaussian_misfit,
    marginal_misfit,
    run_pcn,
    run_pcn_segmented,
)
from bayesianinferencedl_tpu_torch.infer.priors import BoxPrior, GaussianPrior
from bayesianinferencedl_tpu_torch.infer.psis import PSISResult, psis_correct
from bayesianinferencedl_tpu_torch.infer.samplers import MHResult, run_gpcn, run_laplace_mh
from bayesianinferencedl_tpu_torch.infer.smc import run_smc
from bayesianinferencedl_tpu_torch.infer.svgd import SVGDResult, run_svgd
from bayesianinferencedl_tpu_torch.infer.tempering import (
    PTDAResult,
    PTMALAResult,
    PTResult,
    run_pt_da_segmented,
    run_pt_mala,
    run_pt_pcn,
)
from bayesianinferencedl_tpu_torch.infer.vi import VIResult, run_advi, vi_sample
from bayesianinferencedl_tpu_torch.models.corrected import CorrectedForward
from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
from bayesianinferencedl_tpu_torch.models.surrogate import MLP, Normalizer, TrainedSurrogate, train_surrogate
from bayesianinferencedl_tpu_torch.ops.pcg_stencil import solve_fom_stencil
from bayesianinferencedl_tpu_torch.rom.galerkin import ReducedOperator
from bayesianinferencedl_tpu_torch.rom.pod import pod_basis_host
from bayesianinferencedl_tpu_torch.rom.snapshots import sample_log_uniform
from bayesianinferencedl_tpu_torch.utils.checkpoint import load_checkpoint, np_dtype, read_meta, save_checkpoint
from bayesianinferencedl_tpu_torch.utils.device import resolve_device
from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger
from bayesianinferencedl_tpu_torch.utils.ppc import noise_posterior, ppc_chi2_pvalue, ppc_shape_pvalue
from bayesianinferencedl_tpu_torch.utils.precision import check_tier

# the untimed warm-up run that precedes the timed one: pcn and pt_pcn run
# 2 * _WARMUP_STEPS steps (_WARMUP_STEPS burn-in); the samplers with a
# batched FOM solve in every step (pcn on fom, da_pcn, pt_da_pcn) run
# _WARMUP_DA (steps, burn-in), enough to build the kernels and allocate;
# the others, the Laplace and gradient samplers included, run pcn's
_WARMUP_STEPS = 20
_WARMUP_DA = (2, 1)
_AUDIT_MAX = 1024  # kept states re-solved by the FOM iteration audit
_PORTED = ("pcn", "da_pcn", "pt_pcn", "pt_da_pcn", "laplace_mh", "gpcn", "mala", "mala_lap", "hmc",
           "hmc_lap", "pt_mala")
_LAPLACE = ("laplace_mh", "gpcn", "mala_lap", "hmc_lap")  # seeded by the MAP's Laplace approximation
_TEMPERED = ("pt_pcn", "pt_mala", "pt_da_pcn")
# the unported samplers and their ROADMAP.md queue 1 items
_UNPORTED = {"mlda_pcn": 19}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pipeline_layout(r: int, sizes: tuple) -> list:
    """The leaves of a saved pipeline, [(name, shape)], in file order: the
    order of ``jax.tree.leaves((rom, params, norm, P0, dataset))`` in the
    JAX package's ``Pipeline.save``, each named by its key path there
    (``jax.tree_util.keystr``). rom is the ReducedOperator's data fields,
    params the MLP's [(W, b), ...], norm and dataset NamedTuples in field
    order. V's rows (the padded FOM size) and the dataset's length (0 rows:
    none) are not fixed here."""
    d, m = sizes[0], sizes[-1]
    out = [("[0].Ahat", (5, r, r)), ("[0].Mhat", (r, r)), ("[0].Fhat", (r,)), ("[0].Bhat", (m, r)),
           ("[0].V", None)]
    for i, (din, dout) in enumerate(zip(sizes[:-1], sizes[1:])):
        out += [(f"[1][{i}][0]", (din, dout)), (f"[1][{i}][1]", (dout,))]
    out += [(f"[2].{f}", (w,)) for f, w in (("x_mean", d), ("x_std", d), ("y_mean", m), ("y_std", m))]
    out.append(("[3]", (r, r)))
    out += [(f"[4].{f}", None) for f in ("log_k", "error", "y_fom", "y_rom")]
    return out


@dataclass
class Pipeline:
    """All offline artifacts of the framework, ready for online inversion."""

    config: PipelineConfig
    fin: FiveParamFin
    rom: ReducedOperator
    surrogate: TrainedSurrogate
    corrected: CorrectedForward
    dataset: Optional[ErrorDataset]
    prior: GaussianPrior
    P0: torch.Tensor  # reduced-space preconditioner Ahat(1)^{-1}
    rom_pcg_iters: int = 15  # deployed reduced-PCG iteration count
    # the online tier of the reduced solves: "highest", "high" (bf16x3) or
    # "fast" (bf16); ROMConfig.online_precision at build and load
    rom_precision: str = "highest"

    @property
    def device(self) -> torch.device:
        return self.rom.Ahat.device

    @classmethod
    def from_arrays(cls, cfg: PipelineConfig, arrays: dict, *, dataset: Optional[ErrorDataset] = None,
                    device="cuda", dtype=torch.float32) -> "Pipeline":
        """A pipeline from its arrays (the keys of ``convert.pipeline_from_arrays``:
        Ahat, Mhat, Fhat, Bhat, V, P0, W0, b0, ..., x_mean, x_std, y_mean,
        y_std, rom_pcg_iters), the mesh and FOM rebuilt from ``cfg`` (meshes
        are deterministic) and the tier taken from cfg.rom.online_precision."""
        t = lambda k: torch.tensor(np.asarray(arrays[k]), dtype=dtype, device=device)
        fin = FiveParamFin.create(
            resolution=cfg.mesh.resolution, biot=cfg.fem.biot, dtype=dtype, device=device,
            cg_tol=cfg.fem.cg_tol, cg_maxiter=cfg.fem.cg_maxiter,
        )
        rom = ReducedOperator(Ahat=t("Ahat"), Mhat=t("Mhat"), Fhat=t("Fhat"), Bhat=t("Bhat"), V=t("V"),
                              biot=float(cfg.fem.biot))
        if rom.V.shape[0] != fin.op.n:
            raise ValueError(f"the basis has {rom.V.shape[0]} rows, the res{cfg.mesh.resolution} "
                             f"FOM {fin.op.n}")
        n_layers = sum(1 for k in arrays if k.startswith("W") and k[1:].isdigit())
        if n_layers == 0:
            raise ValueError("arrays hold no MLP layers (W0, b0, ...)")
        mlp = MLP.from_params([(t(f"W{i}"), t(f"b{i}")) for i in range(n_layers)],
                              cfg.surrogate.activation)
        norm = Normalizer(x_mean=t("x_mean"), x_std=t("x_std"), y_mean=t("y_mean"), y_std=t("y_std"))
        surrogate = TrainedSurrogate(mlp=mlp, norm=norm)
        return cls(
            config=cfg, fin=fin, rom=rom, surrogate=surrogate,
            corrected=CorrectedForward(rom=rom, surrogate=surrogate), dataset=dataset,
            prior=make_prior(cfg.prior, dtype, device), P0=t("P0"),
            rom_pcg_iters=int(np.asarray(arrays["rom_pcg_iters"])),
            rom_precision=check_tier(cfg.rom.online_precision),
        )

    def save(self, path) -> None:
        """Every offline artifact (the reduced operator and basis, the MLP and
        its normaliser, P0, the error dataset, the config) in one npz, in
        the JAX package's layout (``_pipeline_layout``): its
        ``Pipeline.load`` reads the file, and so does this class's. A
        pipeline without a dataset (``convert.pipeline_from_arrays``) saves
        one of 0 rows."""
        sur = self.surrogate
        ds = self.dataset
        if ds is None:
            d, m = sur.mlp.sizes[0], sur.mlp.sizes[-1]
            z = lambda w: self.P0.new_zeros((0, w))
            ds = ErrorDataset(log_k=z(d), error=z(m), y_fom=z(m), y_rom=z(m))
        named = {f"[0].{f}": getattr(self.rom, f) for f in ("Ahat", "Mhat", "Fhat", "Bhat", "V")}
        named.update({f"[1][{i}][{j}]": a for i, Wb in enumerate(sur.params) for j, a in enumerate(Wb)})
        named.update({f"[2].{f}": a for f, a in zip(Normalizer._fields, sur.norm)})
        named["[3]"] = self.P0
        named.update({f"[4].{f}": a for f, a in zip(ErrorDataset._fields, ds)})
        layout = _pipeline_layout(self.rom.r, sur.mlp.sizes)
        save_checkpoint(path, [named[name] for name, _ in layout], meta={
            "config": self.config.to_dict(),
            "rom_pcg_iters": int(self.rom_pcg_iters),
            "surrogate_sizes": list(sur.mlp.sizes),
            "surrogate_activation": sur.mlp.activation,
        })

    @classmethod
    def load(cls, path, *, device="cuda", dtype=torch.float32) -> "Pipeline":
        """A pipeline from ``save``'s npz (or the JAX package's): the mesh and
        FOM rebuilt from the saved config, every array cast to ``dtype`` on
        ``device`` (the card unless the caller asks for "cpu"), the tier from
        the config's online_precision."""
        meta = read_meta(path)
        cfg = PipelineConfig.from_dict(meta["config"])
        sizes = tuple(int(v) for v in meta["surrogate_sizes"])
        cfg = dataclasses.replace(cfg, surrogate=dataclasses.replace(
            cfg.surrogate, activation=meta["surrogate_activation"]))
        layout = _pipeline_layout(cfg.rom.basis_size, sizes)
        leaves, _ = load_checkpoint(path, [(k, shape, np_dtype(dtype)) for k, shape in layout])
        arrays = {f: leaves[f"[0].{f}"] for f in ("Ahat", "Mhat", "Fhat", "Bhat", "V")}
        for i in range(len(sizes) - 1):
            arrays[f"W{i}"], arrays[f"b{i}"] = leaves[f"[1][{i}][0]"], leaves[f"[1][{i}][1]"]
        arrays.update({f: leaves[f"[2].{f}"] for f in ("x_mean", "x_std", "y_mean", "y_std")})
        arrays["P0"], arrays["rom_pcg_iters"] = leaves["[3]"], meta["rom_pcg_iters"]
        ds = ErrorDataset(*(torch.tensor(leaves[f"[4].{f}"], device=resolve_device(device))
                            for f in ErrorDataset._fields))
        return cls.from_arrays(cfg, arrays, dataset=ds if ds.log_k.shape[0] else None, device=device,
                               dtype=dtype)

    def batched_forward_fn(self, likelihood: str, *, differentiable: bool = False) -> Callable:
        """(C, d) log-conductivities -> (C, n_obs) observables for the chain
        hot loop: ``fom`` observes one batched FOM solve (tol ``fin.cg_tol``,
        cap ``fin.cg_maxiter``, ``make_fom_solver``); ``rom`` and ``rom_nn``
        go through the factorisation-free reduced PCG.

        differentiable=True (the MAP, the Laplace Jacobian and the gradient
        samplers) routes around the solvers without a backward: ``fom``
        through ``fin.solve`` (the plain PCG of ``fem/solve.py``, whose
        backward is one adjoint solve), ``rom`` and ``rom_nn`` through
        ``ReducedOperator.solve_pcg_diff``. Its values agree with the
        default route's to the solver's tolerance."""
        if likelihood not in ("fom", "rom", "rom_nn"):
            raise ValueError(f"unknown likelihood {likelihood!r}")
        if likelihood == "fom":
            if differentiable:
                return lambda thetas: self.fin.op.observe(self.fin.solve(torch.exp(thetas)))
            solve = make_fom_solver(self.fin, tol=self.fin.cg_tol, maxiter=self.fin.cg_maxiter)
            return lambda thetas: self.fin.op.observe(solve(torch.exp(thetas)))
        ff = self.rom.fast_forward(self.P0, self.rom_pcg_iters, self.rom_precision,
                                   differentiable=differentiable)
        if likelihood == "rom":
            return lambda thetas: ff(torch.exp(thetas))
        return lambda thetas: (ff(torch.exp(thetas))
                               + self.surrogate.predict(thetas, differentiable=differentiable))

    def forward_fn(self, likelihood: str) -> Callable:
        """theta (d,) -> observables (n_obs,)."""
        fb = self.batched_forward_fn(likelihood)
        return lambda theta: fb(theta[None])[0]

    def working_forward_fn(self, likelihood: str, *, differentiable: bool = False) -> Callable:
        """``batched_forward_fn`` composed with ``prior.to_theta``: (C, d)
        working coordinates (log k under the Gaussian prior, z under a box
        prior) -> (C, n_obs). The forward every sampler and driver here
        evaluates, as the reference composes to_theta into each."""
        fb = self.batched_forward_fn(likelihood, differentiable=differentiable)
        to_theta = self.prior.to_theta
        return lambda xs: fb(to_theta(xs))


def make_prior(cfg_prior, dtype=torch.float32, device="cuda"):
    """PriorConfig -> prior object on ``device`` (the card unless the caller
    asks for "cpu"): kind "gaussian" is the log-normal-k GaussianPrior on
    theta = log k, "uniform" / "log_uniform" the probit push-forward
    BoxPrior on k."""
    if cfg_prior.kind == "gaussian":
        return GaussianPrior.iid(cfg_prior.dim, mean=cfg_prior.mean, sigma=cfg_prior.sigma,
                                 dtype=dtype, device=device)
    return BoxPrior.create(cfg_prior.dim, low=cfg_prior.low, high=cfg_prior.high, kind=cfg_prior.kind,
                           dtype=dtype, device=device)


def make_fom_solver(fin: FiveParamFin, *, tol: float, maxiter: int, with_iters: bool = False):
    """Batched FOM solver ks (B, 5) -> u (B, n); with_iters=True returns (u,
    iters), the per-sample iteration counts (audit_fom_iters).

    By the operator's dtype, as in the JAX package: float32 goes through
    the stencil kernels (K1 or K3r with the two-level deflation
    preconditioner; K4r / K4c, undeflated, on the largest meshes, where no basis
    is built), float64 through the plain PCG of ``fem/solve.py``."""
    if fin.op.dtype != torch.float32:
        def solve(ks):
            ks = torch.as_tensor(ks, dtype=fin.op.dtype, device=fin.op.device)
            u, iters, _ = pcg_fom(fin.op, ks, fin.op.F_root.expand(ks.shape[0], -1), tol=tol,
                                  maxiter=maxiter)
            return (u, iters) if with_iters else u

        return solve
    defl = fin.deflation_for_kernels()

    def solve(ks):
        u, iters = solve_fom_stencil(fin.op, ks, tol=tol, maxiter=maxiter, deflation=defl)
        return (u, iters) if with_iters else u

    return solve


def audit_fom_iters(pipe: "Pipeline", thetas: torch.Tensor) -> tuple[int, int, float]:
    """Re-solve a batch of kept chain states (B, d) and report (cap,
    max_iters, frac_at_cap). The sampler discards iteration counts; this
    audit makes a capped (unconverged) solve visible instead of silently
    biasing the posterior. Same solver and cap as
    ``batched_forward_fn("fom")``: the plain ``fin.cg_maxiter``."""
    cap = pipe.fin.cg_maxiter
    solver = make_fom_solver(pipe.fin, tol=pipe.fin.cg_tol, maxiter=cap, with_iters=True)
    _, iters = solver(torch.exp(thetas))
    iters = iters.cpu().numpy()
    return cap, int(iters.max()), float((iters >= cap).mean())


def _rel(num: torch.Tensor, den: torch.Tensor) -> float:
    return float(torch.linalg.norm(num) / torch.linalg.norm(den))


def build_pipeline(
    config: PipelineConfig = PipelineConfig(),
    *,
    device="cuda",
    dtype=torch.float32,
    metrics: Optional[MetricsLogger] = None,
) -> Pipeline:
    """The offline build on ``device`` (the card unless the caller asks for
    ``"cpu"``; without a card "cuda" raises). Every FOM solve (snapshots,
    training dataset, holdout) is one batched call of K1, K3r or K4r / K4c, by the
    mesh size. Holdout errors are logged as the ``holdout_rel_err`` event."""
    log = metrics or MetricsLogger()
    cfg = config
    if cfg.rom.method != "pod":
        raise NotImplementedError(
            f"ROMConfig.method={cfg.rom.method!r} (the greedy basis, rom/greedy.py) is not ported "
            "yet: ROADMAP.md queue 1, item 21"
        )
    dev = resolve_device(device)
    tier = check_tier(cfg.rom.online_precision)

    with log.timer("build_fom"):
        fin = FiveParamFin.create(
            resolution=cfg.mesh.resolution, biot=cfg.fem.biot, dtype=dtype, device=dev,
            cg_tol=cfg.fem.cg_tol, cg_maxiter=cfg.fem.cg_maxiter,
        )
        fom_solver = make_fom_solver(fin, tol=cfg.fem.cg_tol, maxiter=cfg.fem.cg_maxiter)
    defl = fin.deflation_for_kernels()
    log.log("fom_built", n_dof=fin.op.n_dof, n_padded=fin.op.n, m=None if defl is None else defl.m,
            device=str(dev))

    gen = torch.Generator(device=dev).manual_seed(cfg.rom.seed)
    k_snap = sample_log_uniform(gen, cfg.rom.n_snapshots, dtype=dtype)
    with log.timer("snapshots"):
        S = fom_solver(k_snap)
        _sync(dev)
        V, _ = pod_basis_host(S, cfg.rom.basis_size)
    with log.timer("project_rom"):
        rom = ReducedOperator.project_host(fin.host, cfg.fem.biot, V, dtype=dtype, device=dev)
    log.log("rom_built", r=rom.r, method="pod", f64_offline=True)

    P0 = rom.preconditioner()
    # deployed reduced-PCG iteration count: the r/2 knee, bumped to 3r/4
    # for observation noise below 5e-4 (the reference's rule)
    rom_pcg_iters = cfg.rom.online_iters or max(15, cfg.rom.basis_size // 2)
    if not cfg.rom.online_iters and cfg.mcmc.noise_sigma < 5e-4:
        rom_pcg_iters = max(rom_pcg_iters, 3 * cfg.rom.basis_size // 4)
        warnings.warn(
            f"noise_sigma={cfg.mcmc.noise_sigma:g} < 5e-4: bumping the deployed "
            f"reduced-PCG iteration count to 3r/4 = {rom_pcg_iters}. "
            "Set ROMConfig.online_iters explicitly to override.",
            stacklevel=2,
        )
        log.log("online_iters_bumped", value=rom_pcg_iters,
                reason=f"noise_sigma {cfg.mcmc.noise_sigma:g} < 5e-4")
    # the dataset's and the holdout's ROM forwards run the deployed tier and
    # iteration count, so the surrogate learns the error of the path the
    # chains evaluate
    rom_fwd = rom.fast_forward(P0, rom_pcg_iters, tier)

    with log.timer("error_dataset"):
        gen_ds = torch.Generator(device=dev).manual_seed(cfg.surrogate.seed + 1)
        ds = generate_error_dataset(fin.op, rom, gen_ds, cfg.surrogate.n_train,
                                    fom_solver=fom_solver, rom_forward=rom_fwd)
        _sync(dev)
    rom_rel_err = _rel(ds.error, ds.y_fom)
    log.log("rom_rel_err", value=rom_rel_err)

    with log.timer("train_surrogate"):
        surrogate, losses = train_surrogate(
            ds.log_k, ds.error,
            hidden=tuple(cfg.surrogate.hidden),
            activation=cfg.surrogate.activation,
            lr=cfg.surrogate.learning_rate,
            batch_size=cfg.surrogate.batch_size,
            steps=cfg.surrogate.epochs * max(1, cfg.surrogate.n_train // cfg.surrogate.batch_size),
            seed=cfg.surrogate.seed,
        )
        _sync(dev)
    log.log("surrogate_trained", final_loss=float(losses[-50:].mean()) if len(losses) else None)

    corrected = CorrectedForward(rom=rom, surrogate=surrogate)
    y_corr = ds.y_rom + surrogate.predict(ds.log_k)
    corr_rel_err = _rel(y_corr - ds.y_fom, ds.y_fom)
    log.log("corrected_rel_err", value=corr_rel_err, rom_rel_err=rom_rel_err)

    # holdout: 128 fresh draws through the same deployed forward path
    with log.timer("holdout_eval"):
        n_hold = min(128, cfg.surrogate.n_train)
        gen_h = torch.Generator(device=dev).manual_seed(cfg.surrogate.seed + 7919)
        ds_h = generate_error_dataset(fin.op, rom, gen_h, n_hold,
                                      fom_solver=fom_solver, rom_forward=rom_fwd)
        _sync(dev)
    y_corr_h = ds_h.y_rom + surrogate.predict(ds_h.log_k)
    log.log(
        "holdout_rel_err", rom=_rel(ds_h.error, ds_h.y_fom),
        corrected=_rel(y_corr_h - ds_h.y_fom, ds_h.y_fom), n_holdout=n_hold,
    )

    return Pipeline(
        config=cfg, fin=fin, rom=rom, surrogate=surrogate, corrected=corrected,
        dataset=ds, prior=make_prior(cfg.prior, dtype, dev), P0=P0,
        rom_pcg_iters=rom_pcg_iters, rom_precision=tier,
    )


@dataclass
class InversionResult:
    result: Union[PCNResult, DAResult, PTResult, PTDAResult, MHResult, MALAResult, PTMALAResult]
    theta_true: torch.Tensor
    data: torch.Tensor
    ess: torch.Tensor  # bulk ESS per dimension (rank-normalised, split)
    rhat: torch.Tensor  # split-R-hat per dimension, max of bulk and tail
    wall_seconds: float
    samples_per_sec: float
    ess_per_sec: float
    ess_tail: Optional[torch.Tensor] = None
    ppc: Optional[dict] = None
    # fom-likelihood runs only: the solver-iteration audit over kept states
    # (audit_fom_iters); a solve at the cap is unconverged
    fom_iter_cap: Optional[int] = None
    fom_iter_max: Optional[int] = None
    fom_hit_cap_frac: Optional[float] = None
    # tempered samplers only: the log evidence log E_prior[exp(-Phi)] by
    # stepping-stone over the ladder (infer/evidence.py); differences across
    # likelihoods on the same data are log Bayes factors
    log_evidence: Optional[float] = None
    log_evidence_std: Optional[float] = None
    # infer_noise runs only: the marginal posterior of the noise sigma
    # (utils/ppc.py noise_posterior): {"sigma_mean", "sigma_sd", "sigma_q05",
    # "sigma_q50", "sigma_q95", "n_draws", "n_obs"}
    noise_sigma_post: Optional[dict] = None


def _child(gen: torch.Generator) -> torch.Generator:
    """A fresh generator seeded from ``gen``'s stream."""
    seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device).item())
    return torch.Generator(device=gen.device).manual_seed(seed)


def _observations(pipe: Pipeline, gen: torch.Generator, theta_true: Optional[torch.Tensor],
                  data: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """(theta_true, data), the data contract of every entry point here.
    data=(n_obs,): those observations as they are, with theta_true (default
    the prior mean) for reporting only. data=None: theta_true (default a
    prior draw from gen), then one FOM solve and noise from gen, in that
    order, so one seed gives the same observations to every one of them."""
    dtype, dev = pipe.prior.mean.dtype, pipe.device
    if data is not None:
        data = torch.as_tensor(data, dtype=dtype, device=dev)
        n_obs = pipe.fin.op.n_obs
        if tuple(data.shape) != (n_obs,):
            raise ValueError(f"external data must have shape ({n_obs},), got {tuple(data.shape)}")
        return (pipe.prior.mean if theta_true is None else theta_true), data
    if theta_true is None:
        theta_true = pipe.prior.sample(gen)
    y_true = pipe.fin.forward(torch.exp(pipe.prior.to_theta(theta_true)))
    noise = pipe.config.mcmc.noise_sigma * torch.randn(y_true.shape, generator=gen, dtype=dtype, device=dev)
    return theta_true, y_true + noise


def _map_laplace(pipe: Pipeline, like: str, mk_misfit: Callable, data: torch.Tensor, b0: float,
                 gen: torch.Generator, log: MetricsLogger):
    """The offline step of the Laplace-seeded samplers: the MAP by 8-start
    BFGS on the differentiable forward, and the Gauss-Newton Laplace
    approximation at it, timed as "map_laplace" and logged as the "map"
    event. With infer_noise the MAP is the marginal potential's; its GN
    curvature ((a0 + m/2) / (b0 + S/2)) J^T J is the Gaussian one at the
    plug-in scale sigma_hat^2 = (b0 + S/2) / (a0 + m/2), the conditional
    posterior mode of sigma^2 at the MAP, so the Laplace factors are built
    there."""
    cfg = pipe.config.mcmc
    fwd_d = pipe.working_forward_fn(like, differentiable=True)
    with log.timer("map_laplace"):
        theta_map, nlp = find_map_multistart(mk_misfit(fwd_d), pipe.prior, gen, n_starts=8)
        sig_lap = cfg.noise_sigma
        if cfg.infer_noise:
            with torch.no_grad():
                r_map = fwd_d(theta_map[None])[0] - data
            s_map = float(torch.sum(r_map * r_map))
            sig_lap = math.sqrt((b0 + 0.5 * s_map) / (2.0 + 0.5 * r_map.shape[-1]))
        lap = laplace_approximation(fwd_d, data, sig_lap, pipe.prior, theta_map)
        _sync(pipe.device)
    log.log("map", nlp=float(nlp), theta_map=theta_map.cpu().tolist())
    return lap


def _gradient_sampler_runner(kind: str, like: str, misfit_b: Callable, prior, theta0, *,
                             step: float, thin: int, n_leap: int, jitter: float,
                             ref: Optional[tuple] = None, log: Optional[MetricsLogger] = None):
    """(run, warm_run), each (gen, n_steps, n_burn) -> result, for a gradient
    sampler (kind "mala" or "hmc"), shared by the prior- and the Laplace-
    preconditioned entries of ``run_inversion``: on fom in segments (32
    MALA steps, or max(1, 32 // n_leap) HMC trajectories, a segment), else
    in one run. n_leap=0 (hmc only) chooses the trajectory length by the
    cross-chain ChEES criterion (``run_hmc_chees``, rom/rom_nn only) and
    logs the probe table as the "chees" event; its warm-up runs
    fixed-length HMC at the median candidate, which builds and allocates
    what the probes use without running them twice."""
    if kind == "hmc" and n_leap == 0:
        if like == "fom":
            raise ValueError(
                "hmc_leap=0 (ChEES auto trajectory tuning) requires a cheap likelihood "
                "(rom/rom_nn): the probes run unsegmented, a full-order solve and its adjoint "
                "in every leapfrog step; pick a fixed n_leap for the fom likelihood"
            )

        def run_auto(g, n_steps, n_burn):
            res, info = run_hmc_chees(misfit_b, prior, theta0, g, n_steps=n_steps, n_burn=n_burn,
                                      step=step, jitter=jitter, thin=thin, ref=ref)
            if log is not None:
                log.log("chees", **info)
            return res

        warm = lambda g, n_steps, n_burn: run_hmc(
            misfit_b, prior, theta0, g, n_steps=n_steps, n_burn=n_burn, step=step, n_leap=8,
            jitter=jitter, thin=thin, ref=ref)
        return run_auto, warm
    if kind == "mala":
        plain, seg_fn, kw, segment = run_mala, run_mala_segmented, {}, 32
    else:
        plain, seg_fn = run_hmc, run_hmc_segmented
        kw, segment = dict(n_leap=n_leap, jitter=jitter), max(1, 32 // n_leap)
    if like == "fom":
        run = lambda g, n_steps, n_burn: seg_fn(
            misfit_b, prior, theta0, g, n_steps=n_steps, n_burn=n_burn, step=step,
            segment=segment, ref=ref, **kw)
    else:
        run = lambda g, n_steps, n_burn: plain(
            misfit_b, prior, theta0, g, n_steps=n_steps, n_burn=n_burn, step=step, thin=thin,
            ref=ref, **kw)
    return run, run


def run_inversion(
    pipe: Pipeline,
    *,
    likelihood: Optional[str] = None,
    sampler: Optional[str] = None,
    init: str = "prior",
    theta_true: Optional[torch.Tensor] = None,
    data: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    metrics: Optional[MetricsLogger] = None,
) -> InversionResult:
    """Bayesian inversion with batched chains on pipe's device:
    - ``pcn``: on rom/rom_nn, or on fom in segments of 64 steps;
    - ``pt_pcn``: ``cfg.n_chains`` cold chains x ``cfg.n_temps`` levels from
      ``cfg.lambda_min``, the ladder adapted in burn-in if
      ``cfg.adapt_ladder``, on rom/rom_nn;
    - ``da_pcn`` / ``pt_da_pcn``: subchains of ``cfg.subchain`` pCN (or,
      with ``cfg.da_inner = "mala"``, MALA) steps on the ``cfg.da_coarse``
      surrogate, Metropolis-corrected against ``likelihood``, in segments of
      64 (da_pcn) or 32 (pt_da_pcn) outer steps for fom and 512 otherwise;
      n_steps and n_burn count outer steps;
    - ``laplace_mh`` / ``gpcn``: the MAP (8-start BFGS) and its Laplace
      approximation, then independence MH or generalised pCN with it, on
      the ordinary batched misfit (the stencil kernels on fom);
    - ``mala`` / ``hmc``, prior-preconditioned, and ``mala_lap`` /
      ``hmc_lap``, Laplace-preconditioned: gradient samplers on the
      differentiable forward, segmented on fom; ``cfg.hmc_leap = 0`` picks
      the trajectory length by ChEES (rom/rom_nn);
    - ``pt_mala``: tempered MALA with replica exchange, on rom/rom_nn.
    Every misfit is Gaussian at ``cfg.noise_sigma``, or with
    ``cfg.infer_noise`` the noise-marginalised potential under the prior
    sigma^2 ~ InvGamma(2, noise_sigma^2).

    init: "prior" draws the chains' starts from the prior; "eki" takes the
    final ensemble of an EKI run (``cfg.n_chains`` members, logged as the
    "eki_init" event), "vi" draws them from an 800-step full-rank ADVI fit
    ("vi_init"). Exactness is unaffected, only the burn-in it takes; not
    for multimodal targets, where the Gaussian-ansatz transport can
    collapse toward one basin. The Laplace-seeded samplers ignore it.

    data=None: theta_true is drawn from the prior (or given) and the noisy
    observations are simulated with one FOM solve. data=(n_obs,): invert
    those observations as they are. An untimed warm-up run precedes the
    timed run, which uses a fresh generator and is timed with CUDA events on
    a card. fom-likelihood runs re-solve up to 1,024 kept states and report
    the solver's iteration audit; tempered runs report the log evidence,
    infer_noise runs the noise posterior and the scale-free PPC."""
    log = metrics or MetricsLogger()
    cfg = pipe.config.mcmc
    like = likelihood or cfg.likelihood
    smp = sampler or cfg.sampler
    if smp in _UNPORTED:
        raise NotImplementedError(
            f"sampler {smp!r} is not ported yet: ROADMAP.md queue 1, item {_UNPORTED[smp]}"
        )
    if smp not in _PORTED:
        raise ValueError(f"unknown sampler {smp!r}")
    if smp == "pt_pcn" and like == "fom":
        raise NotImplementedError(
            "pt_pcn with the fom likelihood puts a full-order solve in every step; use "
            "sampler='pt_da_pcn' (tempered delayed acceptance: the exact FOM posterior, "
            "segmented, one batched FOM solve per outer step) instead"
        )
    if smp == "pt_mala" and like == "fom":
        raise NotImplementedError(
            "pt_mala with the fom likelihood puts a full-order solve and its adjoint in every "
            "step; use sampler='pt_da_pcn' with da_inner subchains instead"
        )
    if smp in ("da_pcn", "pt_da_pcn") and like == cfg.da_coarse:
        raise ValueError(
            f"sampler={smp!r} with likelihood == da_coarse ({like!r}) is degenerate: the outer "
            "correction always accepts and each kept sample costs subchain + 1 evaluations of "
            "the same model. Set likelihood='fom' (the exact target) or use sampler='pcn'."
        )
    fwd_b = pipe.working_forward_fn(like)
    dev = pipe.device
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(cfg.seed)
    theta_true, data = _observations(pipe, gen, theta_true, data)

    # every misfit below: conditioned on noise_sigma, or with sigma integrated
    # out under the proper prior InvGamma(2, noise_sigma^2), whose mean is
    # noise_sigma^2 with infinite variance: the noise becomes a scale guess
    b0 = float(cfg.noise_sigma) ** 2
    if cfg.infer_noise:
        mk_misfit = lambda f: marginal_misfit(f, data, a0=2.0, b0=b0)
    else:
        mk_misfit = lambda f: gaussian_misfit(f, data, cfg.noise_sigma)
    misfit_b = mk_misfit(fwd_b)
    # the differentiable route (the MAP, the Laplace factors, the gradient
    # samplers, MALA subchains): adjoint solves, never a backward through
    # solver iterations
    misfit_d = lambda lk=like: mk_misfit(pipe.working_forward_fn(lk, differentiable=True))
    warm = (2 * _WARMUP_STEPS, _WARMUP_STEPS)
    grad_kw = dict(step=cfg.mala_step, thin=cfg.thin, n_leap=cfg.hmc_leap, jitter=cfg.hmc_jitter,
                   log=log)
    run_warm = None
    if smp in _LAPLACE:  # init is ignored: the Laplace approximation seeds the chains
        lap = _map_laplace(pipe, like, mk_misfit, data, b0, _child(gen), log)
        theta0 = lap.sample(gen, (cfg.n_chains,))
    elif init == "eki":
        # a derivative-free warm start: chains start inside the posterior
        # bulk instead of diffusing there through burn-in
        with log.timer("eki_init"):
            eki0 = run_eki(fwd_b, pipe.prior, data, cfg.noise_sigma, _child(gen),
                           n_ensemble=cfg.n_chains)
        theta0 = eki0.ensemble
        log.log("eki_init", n_iters=len(eki0.ts) - 1, n_forward=eki0.n_forward)
    elif init == "vi":
        # the gradient-based warm start: a short full-rank ADVI fit, chains drawn from q
        g_vi = _child(gen)
        with log.timer("vi_init"):
            vi0 = run_advi(misfit_d(), pipe.prior, g_vi, n_steps=800, n_mc=32, rank="full")
            _sync(dev)
        theta0 = vi_sample(vi0, g_vi, (cfg.n_chains,))
        log.log("vi_init", n_forward=vi0.n_forward, elbo_final=float(torch.mean(vi0.elbo_trace[-50:])))
    elif init == "prior":
        theta0 = pipe.prior.sample(gen, (cfg.n_chains,))
    else:
        raise ValueError(f"init must be 'prior', 'eki', or 'vi', got {init!r}")
    if smp == "laplace_mh":
        run = lambda g, n_steps, n_burn: run_laplace_mh(
            misfit_b, pipe.prior, lap, theta0, g, n_steps=n_steps, n_burn=n_burn)
    elif smp == "gpcn":
        run = lambda g, n_steps, n_burn: run_gpcn(
            misfit_b, pipe.prior, lap, theta0, g, n_steps=n_steps, n_burn=n_burn, beta=cfg.beta)
    elif smp in ("mala_lap", "hmc_lap"):
        # Laplace-preconditioned: posterior-covariance steps that stay exact
        # where the posterior is not Gaussian
        run, run_warm = _gradient_sampler_runner(
            smp.replace("_lap", ""), like, misfit_d(), pipe.prior, theta0, ref=(lap.mean, lap.chol),
            **grad_kw)
    elif smp in ("mala", "hmc"):
        run, run_warm = _gradient_sampler_runner(smp, like, misfit_d(), pipe.prior, theta0, **grad_kw)
    elif smp == "pt_mala":
        misfit_pt = misfit_d()
        run = lambda g, n_steps, n_burn: run_pt_mala(
            misfit_pt, pipe.prior, theta0, g, n_steps=n_steps, n_burn=n_burn, step=cfg.mala_step,
            n_temps=cfg.n_temps, lambda_min=cfg.lambda_min, adapt_ladder=cfg.adapt_ladder,
        )
    elif smp == "pcn" and like == "fom":
        warm = _WARMUP_DA
        run = lambda g, n_steps, n_burn: run_pcn_segmented(
            misfit_b, pipe.prior, theta0, g, n_steps=n_steps, n_burn=n_burn, beta=cfg.beta,
            segment=64,
        )
    elif smp == "pcn":
        run = lambda g, n_steps, n_burn: run_pcn(
            misfit_b, pipe.prior, theta0, g, n_steps=n_steps, n_burn=n_burn,
            beta=cfg.beta, thin=cfg.thin,
        )
    elif smp == "pt_pcn":
        run = lambda g, n_steps, n_burn: run_pt_pcn(
            misfit_b, pipe.prior, theta0, g, n_steps=n_steps, n_burn=n_burn, beta=cfg.beta,
            n_temps=cfg.n_temps, lambda_min=cfg.lambda_min, adapt_ladder=cfg.adapt_ladder,
        )
    else:
        warm = _WARMUP_DA
        # MALA subchains need the coarse gradient; their beta is the initial h
        mala = cfg.da_inner == "mala"
        misfit_c = misfit_d(cfg.da_coarse) if mala else mk_misfit(pipe.working_forward_fn(cfg.da_coarse))
        da_beta = cfg.mala_step if mala else cfg.beta
        fom = like == "fom"
        if smp == "da_pcn":
            run = lambda g, n_steps, n_burn: run_da_pcn_segmented(
                misfit_b, misfit_c, pipe.prior, theta0, g, n_steps=n_steps, n_burn=n_burn,
                beta=da_beta, subchain=cfg.subchain, segment=64 if fom else 512, inner=cfg.da_inner,
            )
        else:
            run = lambda g, n_steps, n_burn: run_pt_da_segmented(
                misfit_b, misfit_c, pipe.prior, theta0, g, n_steps=n_steps, n_burn=n_burn,
                beta=da_beta, subchain=cfg.subchain, n_temps=cfg.n_temps,
                lambda_min=cfg.lambda_min, segment=32 if fom else 512, inner=cfg.da_inner,
                adapt_ladder=cfg.adapt_ladder,
            )

    (run_warm or run)(_child(gen), min(cfg.n_steps, warm[0]), min(cfg.n_burn, warm[1]))
    _sync(dev)
    g_run = _child(gen)
    if dev.type == "cuda":
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        res = run(g_run, cfg.n_steps, cfg.n_burn)
        t1.record()
        t1.synchronize()
        wall = t0.elapsed_time(t1) / 1e3
    else:
        t_start = time.perf_counter()
        res = run(g_run, cfg.n_steps, cfg.n_burn)
        wall = time.perf_counter() - t_start

    ess = ess_bulk(res.samples)
    ess_t = ess_tail(res.samples)
    r = split_rhat(res.samples)
    T, C, d = res.samples.shape

    # fom runs: audit the solver's iteration counts on a spread of kept
    # states, so that a capped, unconverged solve inside the run shows
    cap = it_max = hit_frac = None
    if like == "fom" and T > 0:
        idx = np.linspace(0, T * C - 1, min(_AUDIT_MAX, T * C)).astype(np.int64)
        states = res.samples.reshape(T * C, d)[torch.from_numpy(idx).to(dev)]
        cap, it_max, hit_frac = audit_fom_iters(pipe, pipe.prior.to_theta(states))
        log.log("fom_iter_audit", cap=cap, max_iters=it_max, hit_cap_frac=hit_frac)
        if hit_frac > 0:
            warnings.warn(
                f"{hit_frac:.1%} of audited chain states hit the FOM solver iteration cap "
                f"({cap}): those solves are unconverged and bias the posterior; raise cg_maxiter",
                stacklevel=2,
            )

    ppc = sigma_post = None
    if T > 0 and cfg.infer_noise:
        # an unknown noise absorbs any misfit magnitude, so the chi-square
        # check is powerless: check the residuals' shape, and recover the
        # noise marginal from its conjugate conditional
        ppc = ppc_shape_pvalue(fwd_b, res.samples, data, _child(gen))
        _, sigma_post = noise_posterior(fwd_b, res.samples, data, _child(gen), a0=2.0, b0=b0)
        log.log("noise_post", **sigma_post)
    elif T > 0:
        ppc = ppc_chi2_pvalue(fwd_b, res.samples, data, cfg.noise_sigma, _child(gen))
    if ppc is not None:
        log.log("ppc", **ppc)

    # tempered runs: one batch of prior draws turns the stepping-stone
    # accumulators into the log evidence
    log_z = log_z_std = None
    if smp in _TEMPERED:
        est = log_evidence_from_pt(res, misfit_b, pipe.prior, _child(gen))
        log_z, log_z_std = est.log_z, est.log_z_std
        log.log("log_evidence", log_z=log_z, log_z_std=log_z_std, method="ss")

    n_kept = T * C
    out = InversionResult(
        result=res, theta_true=theta_true, data=data, ess=ess, rhat=r,
        wall_seconds=wall, samples_per_sec=n_kept / wall,
        ess_per_sec=float(torch.min(ess)) / wall, ess_tail=ess_t, ppc=ppc,
        fom_iter_cap=cap, fom_iter_max=it_max, fom_hit_cap_frac=hit_frac,
        log_evidence=log_z, log_evidence_std=log_z_std, noise_sigma_post=sigma_post,
    )
    extra = {}
    if smp in ("da_pcn", "pt_da_pcn"):
        extra = dict(inner_accept_rate=float(torch.mean(res.inner_accept_rate)),
                     n_fine_evals=res.n_fine_evals, subchain=cfg.subchain)
    if smp in _TEMPERED:
        extra["swap_rate"] = res.swap_rate.cpu().tolist()
    log.log(
        "inversion", likelihood=like, sampler=smp, wall_seconds=wall,
        samples_per_sec=out.samples_per_sec, ess_min=float(torch.min(ess)),
        ess_tail_min=float(torch.min(ess_t)), ess_per_sec=out.ess_per_sec,
        accept_rate=float(torch.mean(res.accept_rate)), rhat_max=float(torch.max(r)), **extra,
    )
    return out


def _approx_setup(pipe: Pipeline, generator, theta_true, data):
    """The approximation entry points' shared start: (gen, theta_true, data) by the data
    contract of ``_observations``, from ``generator`` or cfg.seed."""
    cfg = pipe.config.mcmc
    gen = generator if generator is not None else torch.Generator(device=pipe.device).manual_seed(cfg.seed)
    theta_true, data = _observations(pipe, gen, theta_true, data)
    return gen, theta_true, data


def _timed(dev: torch.device, fn):
    """(fn(), host seconds), synchronised before the clock is read."""
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def run_eki_inversion(
    pipe: Pipeline,
    likelihood: str = "rom_nn",
    *,
    n_ensemble: int = 1024,
    ess_target: float = 0.5,
    theta_true: Optional[torch.Tensor] = None,
    data: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    metrics: Optional[MetricsLogger] = None,
) -> tuple[EKIResult, torch.Tensor, torch.Tensor, float]:
    """Ensemble Kalman inversion (infer/eki.py): a derivative-free posterior
    approximation in ~10-20 batched forwards, with ``run_inversion``'s data
    contract. On the fom likelihood each iteration is one batched
    stencil-kernel solve over the whole ensemble. Exact only in the
    linear-Gaussian limit. Returns (EKIResult, theta_true, data,
    wall_seconds) and logs the "eki" event."""
    gen, theta_true, data = _approx_setup(pipe, generator, theta_true, data)
    fwd_b = pipe.working_forward_fn(likelihood)
    res, wall = _timed(pipe.device, lambda: run_eki(
        fwd_b, pipe.prior, data, pipe.config.mcmc.noise_sigma, _child(gen),
        n_ensemble=n_ensemble, ess_target=ess_target))
    if metrics is not None:
        metrics.log("eki", likelihood=likelihood, n_ensemble=n_ensemble, n_iters=len(res.ts) - 1,
                    n_forward=res.n_forward, misfit_final=res.misfit_trace[-1], wall_seconds=wall)
    return res, theta_true, data, wall


def run_vi_inversion(
    pipe: Pipeline,
    likelihood: str = "rom_nn",
    *,
    rank: str = "full",
    n_steps: int = 1500,
    n_mc: int = 32,
    lr: float = 0.05,
    theta_true: Optional[torch.Tensor] = None,
    data: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    metrics: Optional[MetricsLogger] = None,
) -> tuple[VIResult, torch.Tensor, torch.Tensor, float]:
    """ADVI (infer/vi.py): q = N(mu, L L^T) in the whitened prior frame by
    stochastic ELBO ascent, each step one forward and reverse pass of the
    differentiable forward over the n_mc draws; ``run_inversion``'s data
    contract. Returns (VIResult, theta_true, data, wall_seconds) and logs
    the "vi" event."""
    gen, theta_true, data = _approx_setup(pipe, generator, theta_true, data)
    misfit_b = gaussian_misfit(pipe.working_forward_fn(likelihood, differentiable=True), data,
                               pipe.config.mcmc.noise_sigma)
    res, wall = _timed(pipe.device, lambda: run_advi(
        misfit_b, pipe.prior, _child(gen), n_steps=n_steps, n_mc=n_mc, rank=rank, lr=lr))
    if metrics is not None:
        metrics.log("vi", likelihood=likelihood, rank=rank, n_steps=n_steps, n_mc=n_mc,
                    n_forward=res.n_forward, elbo_final=float(torch.mean(res.elbo_trace[-50:])),
                    wall_seconds=wall)
    return res, theta_true, data, wall


def run_svgd_inversion(
    pipe: Pipeline,
    likelihood: str = "rom_nn",
    *,
    n_particles: int = 512,
    n_steps: int = 800,
    lr: float = 0.05,
    anneal_steps: Optional[int] = None,
    theta_true: Optional[torch.Tensor] = None,
    data: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    metrics: Optional[MetricsLogger] = None,
) -> tuple[SVGDResult, torch.Tensor, torch.Tensor, float]:
    """SVGD (infer/svgd.py): n_particles prior-frame draws transported along
    the kernelised Stein direction, each step one forward and reverse pass
    of the differentiable forward over all particles and two (J, J) x (J, d)
    products; ``run_inversion``'s data contract. Biased at finite J and
    without a density: certify its moment-matched Gaussian if needed.
    Returns (SVGDResult, theta_true, data, wall_seconds) and logs the
    "svgd" event."""
    gen, theta_true, data = _approx_setup(pipe, generator, theta_true, data)
    misfit_b = gaussian_misfit(pipe.working_forward_fn(likelihood, differentiable=True), data,
                               pipe.config.mcmc.noise_sigma)
    res, wall = _timed(pipe.device, lambda: run_svgd(
        misfit_b, pipe.prior, _child(gen), n_particles=n_particles, n_steps=n_steps, lr=lr,
        anneal_steps=anneal_steps))
    if metrics is not None:
        metrics.log("svgd", likelihood=likelihood, n_particles=n_particles, n_steps=n_steps,
                    n_forward=res.n_forward, misfit_final=float(res.misfit_trace[-1]),
                    wall_seconds=wall)
    return res, theta_true, data, wall


def psis_certify(
    pipe: Pipeline,
    q_mean: torch.Tensor,
    q_chol: torch.Tensor,
    data: torch.Tensor,
    likelihood: str = "rom_nn",
    *,
    n_draws: int = 4096,
    generator: Optional[torch.Generator] = None,
    metrics: Optional[MetricsLogger] = None,
) -> PSISResult:
    """Certify and correct a Gaussian approximation N(q_mean, q_chol
    q_chol^T) over working coordinates (a VIResult's theta_mean /
    theta_chol, a Laplace fit, a moment-matched ensemble) by Pareto-smoothed
    importance sampling (infer/psis.py): n_draws draws, one batched forward
    through the sampler's route (on fom, one stencil-kernel solve), the
    k-hat gate and the importance-weighted moments. The draws come from
    ``generator``, else from cfg.seed + 7. Logs the "psis" event."""
    cfg = pipe.config.mcmc
    gen = generator if generator is not None else torch.Generator(device=pipe.device).manual_seed(cfg.seed + 7)
    data = torch.as_tensor(data, dtype=pipe.prior.mean.dtype, device=pipe.device)
    misfit_b = gaussian_misfit(pipe.working_forward_fn(likelihood), data, cfg.noise_sigma)
    res = psis_correct(misfit_b, pipe.prior, q_mean, q_chol, gen, n_draws=n_draws)
    if metrics is not None:
        metrics.log("psis", likelihood=likelihood, n_draws=n_draws, k_hat=res.k_hat, ess=res.ess,
                    reliable=res.reliable)
    return res


@dataclass(frozen=True)
class SMCEvidenceResult:
    """run_smc_evidence's output: the SMC log evidence with a cross-group
    Monte-Carlo error bar, and the terminal (equally weighted) particles."""

    particles: torch.Tensor  # (n_particles, d) pooled over the groups, working coordinates
    log_evidence: float
    log_evidence_std: float
    log_z_groups: torch.Tensor  # (n_groups,) the per-group estimates
    n_stages: torch.Tensor  # (n_groups,) each group's schedule length
    theta_true: torch.Tensor
    data: torch.Tensor
    wall_seconds: float


def run_smc_evidence(
    pipe: Pipeline,
    *,
    likelihood: Optional[str] = None,
    n_particles: int = 4096,
    n_groups: int = 8,
    n_mutations: int = 5,
    ess_target: float = 0.5,
    max_stages: int = 64,
    theta_true: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    metrics: Optional[MetricsLogger] = None,
) -> SMCEvidenceResult:
    """The log evidence by adaptive tempered SMC (infer/smc.py), unbiased in
    Z and independent of the stepping-stone estimate of the tempered
    samplers. The observations are simulated as ``run_inversion`` simulates
    them (theta_true, then the noise, from the same generator state), so one
    seed gives the same data to both, and to runs on other likelihoods:
    their differences are log Bayes factors. cfg.infer_noise switches to
    the noise-marginalised potential.

    n_groups populations of n_particles / n_groups run as one batch (one
    batched misfit a mutation sweep); each group's estimate is unbiased, so
    the combined estimate is their mean in Z and their spread the error
    bar."""
    log = metrics or MetricsLogger()
    cfg = pipe.config.mcmc
    like = likelihood or cfg.likelihood
    gen, theta_true, data = _approx_setup(pipe, generator, theta_true, None)
    fwd_b = pipe.working_forward_fn(like)
    if cfg.infer_noise:
        misfit_b = marginal_misfit(fwd_b, data, a0=2.0, b0=float(cfg.noise_sigma) ** 2)
    else:
        misfit_b = gaussian_misfit(fwd_b, data, cfg.noise_sigma)
    return _smc_evidence_core(
        misfit_b, pipe.prior, _child(gen), n_particles=n_particles, n_groups=n_groups,
        n_mutations=n_mutations, ess_target=ess_target, max_stages=max_stages, log=log,
        likelihood=like, event="smc_evidence", theta_true=theta_true, data=data,
    )


def _smc_evidence_core(
    misfit_b: Callable,
    prior: GaussianPrior,
    gen: torch.Generator,
    *,
    n_particles: int,
    n_groups: int,
    n_mutations: int,
    ess_target: float,
    max_stages: int,
    log: MetricsLogger,
    likelihood: str,
    event: str,
    theta_true: torch.Tensor,
    data: torch.Tensor,
) -> SMCEvidenceResult:
    """The SMC-evidence engine: the groups as one batch, their unbiased-in-Z
    combination, the timing (synchronised), the event and the result."""
    if n_particles % n_groups:
        raise ValueError(f"n_particles {n_particles} not divisible by n_groups {n_groups}")
    res, wall = _timed(prior.mean.device, lambda: run_smc(
        misfit_b, prior, gen, n_particles=n_particles // n_groups, n_groups=n_groups,
        n_mutations=n_mutations, ess_target=ess_target, max_stages=max_stages))
    lz = res.log_evidence
    log_z = float(torch.logsumexp(lz, dim=0) - math.log(lz.shape[0]))
    log_z_std = float(torch.std(lz, correction=0))
    log.log(event, likelihood=likelihood, log_z=log_z, log_z_std=log_z_std,
            n_stages=res.n_stages.cpu().tolist(), wall_seconds=wall, method="smc")
    return SMCEvidenceResult(
        particles=res.particles.reshape(n_particles, -1), log_evidence=log_z,
        log_evidence_std=log_z_std, log_z_groups=lz, n_stages=res.n_stages,
        theta_true=theta_true, data=data, wall_seconds=wall,
    )


def run_flow_vi_inversion(
    pipe: Pipeline,
    likelihood: str = "rom_nn",
    *,
    n_couplings: int = 6,
    hidden: int = 32,
    n_steps: Optional[int] = None,
    n_mc: int = 64,
    lr: float = 0.003,
    pretrain: str = "smc",
    pretrain_particles: int = 2048,
    pretrain_steps: int = 2000,
    n_mutations: int = 5,
    max_stages: int = 64,
    anneal_steps: Optional[int] = None,
    theta_true: Optional[torch.Tensor] = None,
    data: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    metrics: Optional[MetricsLogger] = None,
) -> tuple[FlowVIResult, torch.Tensor, torch.Tensor, float]:
    """A normalizing-flow posterior approximation (infer/flow.py), the
    non-Gaussian member of the approximation layer.

    pretrain="smc": one tempered-SMC population on the batched forward, then
    the flow fitted to it by mass-covering maximum likelihood; no reverse-KL
    refinement unless n_steps > 0 (it re-collapses a covering fit).
    pretrain="none": annealed reverse-KL flow-VI (default 3,000 steps) on the
    differentiable forward (``working_forward_fn(..., differentiable=True)``),
    for unimodal targets. ``run_inversion``'s data contract: the observations
    come first from ``generator`` (default cfg.seed), the fit's draws from a
    child of it. Returns (FlowVIResult, theta_true, data, wall_seconds) and
    logs the "flow_vi" event."""
    if pretrain not in ("smc", "none"):
        raise ValueError(f"pretrain must be 'smc' or 'none', got {pretrain!r}")
    gen, theta_true, data = _approx_setup(pipe, generator, theta_true, data)
    noise = pipe.config.mcmc.noise_sigma
    misfit_b = gaussian_misfit(pipe.working_forward_fn(likelihood), data, noise)
    misfit_bd = gaussian_misfit(pipe.working_forward_fn(likelihood, differentiable=True), data, noise)
    (res, n_stages), wall = _timed(pipe.device, lambda: flow_fit_pipeline(
        misfit_b, misfit_bd, pipe.prior, _child(gen), n_couplings=n_couplings, hidden=hidden,
        pretrain=pretrain, pretrain_particles=pretrain_particles, pretrain_steps=pretrain_steps,
        n_mutations=n_mutations, max_stages=max_stages, n_steps=n_steps, n_mc=n_mc, lr=lr,
        anneal_steps=anneal_steps))
    if metrics is not None:
        metrics.log("flow_vi", likelihood=likelihood, pretrain=pretrain, n_couplings=n_couplings,
                    n_steps=n_steps, smc_stages=n_stages, n_forward=res.n_forward,
                    elbo_final=float(torch.mean(res.elbo_trace[-50:])), wall_seconds=wall)
    return res, theta_true, data, wall


def psis_certify_flow(
    pipe: Pipeline,
    flow_res: FlowVIResult,
    data: torch.Tensor,
    likelihood: str = "rom_nn",
    *,
    n_draws: int = 4096,
    base_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
    metrics: Optional[MetricsLogger] = None,
) -> PSISResult:
    """``psis_certify`` for a flow fit: n_draws flow draws carrying their exact
    log q, one batched forward through the sampler's route (on fom, one
    stencil-kernel solve), the k-hat gate, the weighted moments and the
    evidence. base_scale > 1 widens the flow's base (defensive importance
    sampling). The draws come from ``generator``, else from cfg.seed + 7.
    Logs the "psis_flow" event."""
    cfg = pipe.config.mcmc
    gen = generator if generator is not None else torch.Generator(device=pipe.device).manual_seed(cfg.seed + 7)
    data = torch.as_tensor(data, dtype=pipe.prior.mean.dtype, device=pipe.device)
    misfit_b = gaussian_misfit(pipe.working_forward_fn(likelihood), data, cfg.noise_sigma)
    res = flow_psis_certify(misfit_b, pipe.prior, flow_res, gen, n_draws=n_draws, base_scale=base_scale)
    if metrics is not None:
        metrics.log("psis_flow", likelihood=likelihood, n_draws=n_draws, base_scale=base_scale,
                    k_hat=res.k_hat, ess=res.ess, reliable=res.reliable)
    return res


def run_neutra_inversion(
    pipe: Pipeline,
    flow_res: FlowVIResult,
    data: torch.Tensor,
    likelihood: str = "rom_nn",
    *,
    theta_true: Optional[torch.Tensor] = None,
    n_chains: int = 1024,
    n_steps: int = 2000,
    n_burn: int = 1000,
    beta: float = 0.3,
    thin: int = 1,
    generator: Optional[torch.Generator] = None,
    metrics: Optional[MetricsLogger] = None,
) -> InversionResult:
    """Flow-preconditioned pCN (NeuTra, infer/flow.py run_neutra_pcn): the
    exact posterior of ``likelihood`` on ``data``, sampled in the flow's
    latent coordinates, one batched misfit a step (on fom, one stencil-kernel
    solve a step and one for the chains' start). The chains' start and every
    step's draws come from ``generator``, else from cfg.seed + 11. Returns an
    InversionResult whose diagnostics (bulk and tail ESS, split-R-hat) are
    over the pushed, working-coordinate samples, and logs the "neutra"
    event."""
    cfg = pipe.config.mcmc
    gen = generator if generator is not None else torch.Generator(device=pipe.device).manual_seed(cfg.seed + 11)
    dtype = pipe.prior.mean.dtype
    data = torch.as_tensor(data, dtype=dtype, device=pipe.device)
    if theta_true is None:
        theta_true = pipe.prior.mean
    misfit_b = gaussian_misfit(pipe.working_forward_fn(likelihood), data, cfg.noise_sigma)
    out, wall = _timed(pipe.device, lambda: run_neutra_pcn(
        flow_res, misfit_b, pipe.prior, gen, n_chains=n_chains, n_steps=n_steps, n_burn=n_burn,
        beta=beta, thin=thin))
    ess, ess_t, rh = ess_bulk(out.samples), ess_tail(out.samples), split_rhat(out.samples)
    n_total = out.samples.shape[0] * out.samples.shape[1]
    res = InversionResult(
        result=out, theta_true=theta_true, data=data, ess=ess, rhat=rh, wall_seconds=wall,
        samples_per_sec=n_total / wall, ess_per_sec=float(torch.min(ess)) / wall, ess_tail=ess_t,
    )
    if metrics is not None:
        metrics.log("neutra", likelihood=likelihood, n_chains=n_chains, n_steps=n_steps,
                    rhat_split_max=float(torch.max(rh)), ess_bulk_min=float(torch.min(ess)),
                    accept_rate=float(torch.mean(out.accept_rate)), wall_seconds=wall)
    return res
