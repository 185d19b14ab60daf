"""Full-field (nodal conductivity) pipeline: the offline build and the online
Bayesian inversion in random-Fourier-feature (RFF) coefficient space.

``build_full_field_pipeline`` mirrors ``api.build_pipeline`` for the
non-affine model. The conductivity is k = exp(theta), theta = mean + sigma
F z with F the (n, M) RFF features, and z ~ N(0, I) is what the chains
sample: pCN's own reference measure, so the inverse problem is
dimension-robust. Every batched FOM solve (the snapshot sweep, the error
dataset, the holdout, the synthetic truth and the fom likelihood of every
gradient-free sampler) goes through ``ops.pcg_stencil.solve_fom_stencil``:
on the card K3r with the two-level deflation, whose coarse matrices are
projected per sample from the nodal planes
(``DeflationBasis.coarse_inverses_from_vals``). The gradient samplers, the
MAP and LIS's Jacobians take the differentiable plain PCG of
``fem/solve.py`` (the planes-level adjoint). The ROM is affinized through a
conductivity-POD basis (``rom/nonaffine.py``), and the NN error surrogate
takes z as its input.

``run_full_field_inversion`` runs every single-device sampler of the
reference on it, by the port's own samplers and entry points; around it the
evidence (``run_full_field_evidence``, ``select_correlation_length``), the
prediction of temperature and conductivity, simulation-based calibration
and the approximation layer. Draws come from ``generator=`` where the JAX
package takes ``key``. Nothing moves between devices on its own.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.api import (
    InversionResult,
    SMCEvidenceResult,
    _child,
    _gradient_sampler_runner,
    _runner,
    _smc_evidence_core,
    _sync,
    _timed,
)
from bayesianinferencedl_tpu_torch.fem.dia import StencilOperator
from bayesianinferencedl_tpu_torch.fem.dia_nonaffine import NodalStencilOperator, assemble_nodal_coeff
from bayesianinferencedl_tpu_torch.fem.solve import pcg_fom, solve_fom
from bayesianinferencedl_tpu_torch.geometry.mesh import FinMesh, build_fin_mesh
from bayesianinferencedl_tpu_torch.infer.delayed_acceptance import run_da_pcn_segmented
from bayesianinferencedl_tpu_torch.infer.diagnostics import ess_bulk, ess_tail, split_rhat
from bayesianinferencedl_tpu_torch.infer.eki import run_eki
from bayesianinferencedl_tpu_torch.infer.flow import flow_fit_pipeline, flow_psis_certify, run_neutra_pcn
from bayesianinferencedl_tpu_torch.infer.lis import build_lis, run_lis_pcn, run_lis_pcn_segmented
from bayesianinferencedl_tpu_torch.infer.map import find_map, laplace_approximation
from bayesianinferencedl_tpu_torch.infer.mlda import run_mlda_segmented
from bayesianinferencedl_tpu_torch.infer.oed import mesh_node_grid_ids
from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit, marginal_misfit, run_pcn, run_pcn_segmented
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.infer.psis import psis_correct
from bayesianinferencedl_tpu_torch.infer.samplers import run_gpcn, run_laplace_mh
from bayesianinferencedl_tpu_torch.infer.sbc import run_sbc
from bayesianinferencedl_tpu_torch.infer.svgd import run_svgd
from bayesianinferencedl_tpu_torch.infer.tempering import run_pt_da_segmented, run_pt_mala, run_pt_pcn
from bayesianinferencedl_tpu_torch.infer.vi import run_advi
from bayesianinferencedl_tpu_torch.models.five_param import assemble_host
from bayesianinferencedl_tpu_torch.models.full_field import RandomField
from bayesianinferencedl_tpu_torch.models.surrogate import TrainedSurrogate, train_surrogate
from bayesianinferencedl_tpu_torch.ops.deflation import DeflationBasis
from bayesianinferencedl_tpu_torch.ops.pcg_stencil import layout_for, solve_fom_stencil
from bayesianinferencedl_tpu_torch.rom.nonaffine import AffinizedReducedOperator, greedy_basis_nonaffine
from bayesianinferencedl_tpu_torch.rom.pod import pod_basis_host
from bayesianinferencedl_tpu_torch.utils.device import resolve_device
from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger
from bayesianinferencedl_tpu_torch.utils.ppc import thin_samples
from bayesianinferencedl_tpu_torch.utils.precision import check_tier
from bayesianinferencedl_tpu_torch.utils.predict import FieldPrediction, predict_field

# the untimed warm-up run before the timed one, (steps, burn-in): the
# samplers with a batched FOM solve in every step run _WARMUP_FOM, the
# others _WARMUP (as api.run_inversion)
_WARMUP = (40, 20)
_WARMUP_FOM = (2, 1)
_AUDIT_MAX = 1024  # kept states re-solved by the FOM iteration audit


def fom_solver(op, deflation: Optional[DeflationBasis], *, tol: float, maxiter: int,
               log: Optional[MetricsLogger] = None) -> Callable:
    """Batched nodal FOM solver ks (B, n) -> (u (B, n), iters (B,)).

    float32: ``solve_fom_stencil`` (K3r, with ``deflation`` and the
    per-sample projected coarse inverses); float64: the plain PCG of
    ``fem/solve.py``. With ``log``, every call reads back its iteration
    counts and logs the "fom_solve" event (batch, max_iters, cap, the
    samples at the cap and the samples whose coarse factorisation failed,
    whose solution is NaN), and warns when a solve reaches the cap: an
    unconverged solve would bias the snapshots, the training data or the
    synthetic truth."""
    f32 = op.dtype == torch.float32

    def solve(ks, x0=None):
        ks = torch.as_tensor(ks, dtype=op.dtype, device=op.device)
        if f32:
            u, iters = solve_fom_stencil(op, ks, tol=tol, maxiter=maxiter, x0=x0, deflation=deflation)
        else:
            u, iters, _ = pcg_fom(op, ks, op.F_root.expand(ks.shape[0], -1), tol=tol, maxiter=maxiter,
                                  x0=x0)
        if log is not None:
            it = iters.cpu().numpy()
            n_failed = int((~torch.isfinite(u).all(-1)).sum())
            at_cap = int((it >= maxiter).sum())
            log.log("fom_solve", batch=int(ks.shape[0]), max_iters=int(it.max()), cap=int(maxiter),
                    n_at_cap=at_cap, n_failed=n_failed)
            if at_cap:
                warnings.warn(f"the FOM solver hit its iteration cap ({maxiter}) on {at_cap} of "
                              f"{ks.shape[0]} samples: raise cg_maxiter, the solves are unconverged",
                              stacklevel=2)
        return u, iters

    return solve


@dataclass
class FullFieldPipeline:
    op: NodalStencilOperator
    field: RandomField
    rom: Optional[AffinizedReducedOperator]
    surrogate: Optional[TrainedSurrogate]
    prior: GaussianPrior  # N(0, I) over the RFF coefficients z
    P0: Optional[torch.Tensor]
    rom_pcg_iters: int = 25
    cg_tol: float = 1e-7
    cg_maxiter: int = 2000
    # the two-level deflation basis of the stencil kernels; its coarse
    # matrices are projected per sample (the operator is not affine)
    deflation: Optional[DeflationBasis] = None
    rom_precision: str = "highest"  # the online tier: "highest", "high" or "fast"
    # the construction's hyperparameters, so that a coarser mesh can carry
    # the same field (the mlda_pcn mid rung, ``coarse_fom_forward``)
    ell: float = 1.0
    seed: int = 0
    biot: float = 0.1
    mesh: Optional[FinMesh] = None
    assembler: str = "numpy"  # which host assembler built the operator

    @property
    def device(self) -> torch.device:
        return self.op.device

    def theta(self, z: torch.Tensor) -> torch.Tensor:
        """z (..., M) -> the nodal log-conductivity field (..., n)."""
        return self.field.theta(z)

    def conductivity(self, z: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.theta(z))

    def node_mesh_ids(self):
        """(mesh, gid): the fin mesh and the solution-vector row of each of
        its nodes (the solver works in the padded grid numbering)."""
        mesh = self.mesh if self.mesh is not None else build_fin_mesh(self.op.resolution)
        return mesh, mesh_node_grid_ids(mesh)

    def node_theta(self, z: torch.Tensor) -> torch.Tensor:
        """z -> log-conductivity at the mesh nodes."""
        _, gid = self.node_mesh_ids()
        return self.theta(z)[..., torch.as_tensor(gid, device=self.device)]

    def solver(self, log: Optional[MetricsLogger] = None) -> Callable:
        """The pipeline's batched FOM solver (``fom_solver``) at its tolerance and cap."""
        return fom_solver(self.op, self.deflation, tol=self.cg_tol, maxiter=self.cg_maxiter, log=log)

    def batched_forward_fn(self, likelihood: str, *, differentiable: bool = False) -> Callable:
        """(C, M) coefficients -> (C, n_obs): ``fom`` observes one batched
        solve through ``solver`` (K3r on the card); ``rom`` and ``rom_nn``
        the affinized ROM's fixed-iteration PCG at the online tier.
        differentiable=True (the MAP, the Laplace and LIS Jacobians, the
        gradient samplers): ``fom`` through ``fem.solve.solve_fom`` (the
        plain PCG with its planes-level adjoint), ``rom`` / ``rom_nn``
        through the PCG's implicit derivative."""
        if likelihood not in ("fom", "rom", "rom_nn"):
            raise ValueError(f"unknown likelihood {likelihood!r}")
        if likelihood == "fom":
            if differentiable:
                return lambda zs: self.op.observe(solve_fom(
                    self.op, self.conductivity(zs), tol=self.cg_tol, maxiter=self.cg_maxiter))
            solve = self.solver()
            return lambda zs: self.op.observe(solve(self.conductivity(zs))[0])
        if self.rom is None:
            raise ValueError(f"likelihood {likelihood!r} needs the ROM: this pipeline was built "
                             "forward_only")
        ff = self.rom.fast_forward(self.P0, self.rom_pcg_iters, self.rom_precision,
                                   differentiable=differentiable)
        if likelihood == "rom":
            return lambda zs: ff(self.conductivity(zs))
        return lambda zs: (ff(self.conductivity(zs))
                           + self.surrogate.predict(zs, differentiable=differentiable))

    def forward_fn(self, likelihood: str) -> Callable:
        """z (M,) -> observables (n_obs,)."""
        fb = self.batched_forward_fn(likelihood)
        return lambda z: fb(z[None])[0]


def _nodal_fin(resolution: int, biot: float, dtype, dev):
    """(mesh, host, G, op, assembler) of the fin at ``resolution``."""
    mesh = build_fin_mesh(resolution)
    host, assembler = assemble_host(mesh, pad_to=128)
    G_host = assemble_nodal_coeff(mesh, host)
    op = NodalStencilOperator(base=StencilOperator.from_host(host, biot=biot, dtype=dtype, device=dev),
                              G=torch.as_tensor(G_host, dtype=dtype, device=dev))
    return mesh, host, G_host, op, assembler


def _kernel_deflation(host, op, biot: float) -> Optional[DeflationBasis]:
    """The deflation basis of the float32 kernels (None on K4's "single"
    layout, which applies none, and in float64, which takes the plain PCG)."""
    if op.dtype != torch.float32 or layout_for(op.n) == "single":
        return None
    return DeflationBasis.create(host, biot=biot, m=128, dtype=op.dtype, device=op.device)


def build_full_field_pipeline(
    *,
    resolution: int = 4,
    biot: float = 0.1,
    dtype=torch.float32,
    ell: float = 1.0,
    sigma: float = 0.5,
    n_features: int = 64,
    n_snapshots: int = 256,
    basis_size: int = 40,
    k_basis_size: int = 40,
    basis: str = "pod",
    n_train: int = 1024,
    surrogate_hidden=(128, 128),
    surrogate_steps: int = 3000,
    cg_tol: float = 1e-7,
    cg_maxiter: int = 2000,
    seed: int = 0,
    online_precision: str = "highest",
    rom_pcg_iters: int = 25,
    forward_only: bool = False,
    metrics: Optional[MetricsLogger] = None,
    device="cuda",
) -> FullFieldPipeline:
    """The offline build on ``device`` (the card unless the caller asks for
    "cpu"; without a card "cuda" raises): the mesh and the nodal stencil
    operator (the host operator from the native assembler where it builds,
    logged in the "fom_built" event), the RFF field in the grid numbering
    the operator reads, the deflation basis, then the snapshot sweep
    (n_snapshots prior fields), the k-POD basis W and the state basis (POD,
    or ``basis="greedy"``: residual-indicator selection among the solved
    snapshots), the host-f64 projection and P0 at the mean snapshot
    coefficients, the error dataset (n_train N(0, I) coefficient draws, the
    ROM on the deployed tier and iteration count), the tanh MLP on z and a
    128-draw holdout ("holdout_rel_err"). Each batched solve logs a
    "fom_solve" event. Draws: the snapshots from seed, the dataset from
    seed + 1, the holdout from seed + 7919; W and b from seed
    (``RandomField.create``).

    forward_only=True stops after the deflation basis: the exact-FOM
    forward and the prior only (rom and surrogate None), the pipeline of
    fom-likelihood evidence sweeps (``select_correlation_length``)."""
    if basis not in ("pod", "greedy"):
        raise ValueError(f"basis must be 'pod' or 'greedy', got {basis!r}")
    tier = check_tier(online_precision)  # a typo fails before the sweeps run
    log = metrics or MetricsLogger()
    dev = resolve_device(device)

    with log.timer("build_fom"):
        mesh, host, G_host, op, assembler = _nodal_fin(resolution, biot, dtype, dev)
        # the features in the grid numbering the nodal operator reads
        field = RandomField.create(mesh, host.n, ell=ell, sigma=sigma, n_features=n_features,
                                   seed=seed, dtype=dtype, device=dev, node_ids=mesh_node_grid_ids(mesh))
        deflation = _kernel_deflation(host, op, biot)
    log.log("fom_built", n_dof=op.n_dof, n_padded=op.n, n_features=n_features, device=str(dev),
            m=None if deflation is None else deflation.m, assembler=assembler)
    solver = fom_solver(op, deflation, tol=cg_tol, maxiter=cg_maxiter, log=log)
    prior = GaussianPrior.iid(n_features, mean=0.0, sigma=1.0, dtype=dtype, device=dev)
    common = dict(op=op, field=field, prior=prior, rom_pcg_iters=rom_pcg_iters, cg_tol=cg_tol,
                  cg_maxiter=cg_maxiter, rom_precision=tier, deflation=deflation, ell=float(ell),
                  seed=int(seed), biot=float(biot), mesh=mesh, assembler=assembler)
    if forward_only:
        return FullFieldPipeline(rom=None, surrogate=None, P0=None, **common)

    gen = torch.Generator(device=dev).manual_seed(seed)
    with log.timer("snapshots"):
        ks = torch.exp(field.sample(gen, n_snapshots))
        S, _ = solver(ks)
        _sync(dev)
    with log.timer("pod"):
        W, _ = pod_basis_host(ks, k_basis_size)
        if basis == "greedy":
            V, _, ind = greedy_basis_nonaffine(op, G_host, ks.double().cpu().numpy(),
                                               S.double().cpu().numpy(), W, basis_size)
            log.log("greedy_basis", r=V.shape[1], indicator_final=float(ind[-1]))
        else:
            V, _ = pod_basis_host(S, basis_size)
    with log.timer("project_rom"):
        rom = AffinizedReducedOperator.project_host(op, G_host, V, W, dtype=dtype, device=dev)
    P0 = rom.preconditioner(rom.coeffs(ks).mean(0))
    log.log("rom_built", r=rom.r, m_k=rom.m_k)
    ff = rom.fast_forward(P0, rom_pcg_iters, tier)

    def error_rows(g, n):
        zs = torch.randn((n, n_features), generator=g, dtype=dtype, device=dev)
        ks_t = torch.exp(field.theta(zs))
        y_fom = op.observe(solver(ks_t)[0])
        y_rom = ff(ks_t)
        return zs, y_fom, y_rom

    with log.timer("error_dataset"):
        zs, y_fom, y_rom = error_rows(torch.Generator(device=dev).manual_seed(seed + 1), n_train)
        err = y_fom - y_rom
        _sync(dev)
    rel = lambda a, b: float(torch.linalg.norm(a) / torch.linalg.norm(b))
    rom_rel = rel(err, y_fom)
    log.log("rom_rel_err", value=rom_rel)

    with log.timer("train_surrogate"):
        surrogate, losses = train_surrogate(zs, err, hidden=tuple(surrogate_hidden),
                                            steps=surrogate_steps, seed=seed)
        _sync(dev)
    log.log("surrogate_trained", final_loss=float(losses[-50:].mean()) if len(losses) else None)
    log.log("corrected_rel_err", value=rel(y_rom + surrogate.predict(zs) - y_fom, y_fom),
            rom_rel_err=rom_rel)

    # the honest figures: fresh coefficient draws through the deployed path
    with log.timer("holdout_eval"):
        n_hold = min(128, n_train)
        zs_h, y_fom_h, y_rom_h = error_rows(torch.Generator(device=dev).manual_seed(seed + 7919), n_hold)
        _sync(dev)
    log.log("holdout_rel_err", rom=rel(y_fom_h - y_rom_h, y_fom_h),
            corrected=rel(y_rom_h + surrogate.predict(zs_h) - y_fom_h, y_fom_h), n_holdout=n_hold)
    return FullFieldPipeline(rom=rom, surrogate=surrogate, P0=P0, **common)


def coarse_fom_forward(pipe: FullFieldPipeline, resolution: int) -> Callable:
    """zs (B, M) -> (B, n_obs): the full-field FOM on a coarser mesh for the
    same RFF coefficients, the mlda_pcn mid rung. The coarse field is the
    fine one's W and b evaluated at the coarse mesh's nodes, so z means the
    same continuum field on both meshes; only the discretisation coarsens.
    Batched through ``fom_solver`` with the coarse mesh's own deflation
    basis (K3r on the card)."""
    dtype, dev = pipe.op.dtype, pipe.device
    mesh_c, host_c, _, op_c, _ = _nodal_fin(resolution, pipe.biot, dtype, dev)
    f = pipe.field
    field_c = RandomField.from_weights(mesh_c, host_c.n, f.W, f.b, sigma=f.sigma, mean=f.mean,
                                       dtype=dtype, device=dev, node_ids=mesh_node_grid_ids(mesh_c))
    solve = fom_solver(op_c, _kernel_deflation(host_c, op_c, pipe.biot), tol=pipe.cg_tol,
                       maxiter=pipe.cg_maxiter)
    return lambda zs: op_c.observe(solve(torch.exp(field_c.theta(zs)))[0])


def _observations(pipe: FullFieldPipeline, gen: torch.Generator, z_true, data, noise_sigma: float):
    """(z_true, data): data=(n_obs,) inverted as given (z_true, default 0,
    for reporting); else z_true (default a prior draw from gen), one FOM
    solve (``solver``, K3r on the card) and noise from gen, in that order,
    so one generator state gives every entry point the same observations."""
    dtype, dev = pipe.prior.mean.dtype, pipe.device
    if data is not None:
        data = torch.as_tensor(data, dtype=dtype, device=dev)
        n_obs = pipe.op.n_obs
        if tuple(data.shape) != (n_obs,):
            raise ValueError(f"external data must have shape ({n_obs},), got {tuple(data.shape)}")
        return (torch.zeros_like(pipe.prior.mean) if z_true is None else z_true), data
    if z_true is None:
        z_true = pipe.prior.sample(gen)
    y_true = pipe.forward_fn("fom")(torch.as_tensor(z_true, dtype=dtype, device=dev))
    return z_true, y_true + noise_sigma * torch.randn(y_true.shape, generator=gen, dtype=dtype, device=dev)


def _gen(pipe: FullFieldPipeline, generator, seed: int = 0) -> torch.Generator:
    return generator if generator is not None else torch.Generator(device=pipe.device).manual_seed(seed)


def run_full_field_evidence(
    pipe: FullFieldPipeline,
    *,
    likelihood: str = "rom_nn",
    noise_sigma: float = 1e-3,
    n_particles: int = 4096,
    n_groups: int = 8,
    n_mutations: int = 5,
    ess_target: float = 0.5,
    max_stages: int = 64,
    infer_noise: bool = False,
    z_true: Optional[torch.Tensor] = None,
    data: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    mesh=None,
    metrics: Optional[MetricsLogger] = None,
) -> SMCEvidenceResult:
    """The log evidence of the full-field model by adaptive tempered SMC
    (``api.run_smc_evidence``'s contract on z): the observations as
    ``run_full_field_inversion`` simulates them from the same generator
    (default seed 0), so differences across likelihoods are log Bayes
    factors on the same data; data= takes external observations.
    infer_noise: the noise-marginalised potential under InvGamma(2,
    noise_sigma^2). mesh: one SMC island a rank instead of the groups
    (``parallel.sharding.sharded_smc``). Logs the "ff_smc_evidence" event."""
    log = metrics or MetricsLogger()
    gen = _gen(pipe, generator)
    z_true, data = _observations(pipe, gen, z_true, data, noise_sigma)
    fwd_b = pipe.batched_forward_fn(likelihood)
    if infer_noise:
        misfit_b = marginal_misfit(fwd_b, data, a0=2.0, b0=float(noise_sigma) ** 2)
    else:
        misfit_b = gaussian_misfit(fwd_b, data, noise_sigma)
    return _smc_evidence_core(
        misfit_b, pipe.prior, _child(gen), n_particles=n_particles, n_groups=n_groups,
        n_mutations=n_mutations, ess_target=ess_target, max_stages=max_stages, log=log,
        likelihood=likelihood, event="ff_smc_evidence", theta_true=z_true, data=data, mesh=mesh,
    )


def select_correlation_length(
    ells,
    *,
    resolution: int = 4,
    biot: float = 0.1,
    dtype=torch.float32,
    sigma: float = 0.5,
    n_features: int = 64,
    noise_sigma: float = 1e-2,
    ell_true: Optional[float] = None,
    data: Optional[torch.Tensor] = None,
    n_datasets: int = 1,
    n_particles: int = 4096,
    n_groups: int = 8,
    n_mutations: int = 5,
    ess_target: float = 0.5,
    max_stages: int = 128,
    cg_tol: float = 1e-7,
    cg_maxiter: int = 2000,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    mesh=None,
    metrics: Optional[MetricsLogger] = None,
    device="cuda",
) -> dict:
    """The RFF prior's correlation length by model evidence: every
    candidate ell is a different push-forward z -> k(x) under the same
    N(0, I) prior, so the exact-FOM SMC evidence Z(ell) of the same
    observations ranks them (Bayes factors; softmax(log Z) is the posterior
    under a uniform hyperprior). Each candidate is a forward_only build.

    data=None simulates n_datasets independent experiments from ell_true
    (z_true from the prior under the true feature map); data= takes
    external observations, (n_obs,) or (E, n_obs). Evidences pool across
    experiments (log Z summed): with the fin's 5 observations one
    experiment's Bayes factor is dataset luck. Returns {"ells", "log_z",
    "log_z_std", "posterior", "ell_map", "z_true", "data"}, log_z the pooled
    totals. mesh: each evidence's SMC runs as islands over its ranks."""
    ells = [float(e) for e in ells]
    if data is None and ell_true is None:
        raise ValueError("provide external data= or ell_true to simulate from")
    log = metrics or MetricsLogger()
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(seed)

    def build(ell):
        return build_full_field_pipeline(
            resolution=resolution, biot=biot, dtype=dtype, ell=ell, sigma=sigma,
            n_features=n_features, cg_tol=cg_tol, cg_maxiter=cg_maxiter, seed=seed,
            forward_only=True, metrics=log, device=dev)

    z_true = None
    if data is None:
        pipe_true = build(float(ell_true))
        z_true = pipe_true.prior.sample(gen, (n_datasets,))
        y_true = pipe_true.batched_forward_fn("fom")(z_true)
        data = y_true + noise_sigma * torch.randn(y_true.shape, generator=gen, dtype=dtype, device=dev)
    else:
        data = torch.as_tensor(data, dtype=dtype, device=dev)
        if data.dim() == 1:
            data = data[None]

    gens = [_child(gen) for _ in range(data.shape[0])]  # one per experiment, shared by every ell
    log_z, log_z_std = [], []
    for ell in ells:
        pipe = build(ell)
        tot, var = 0.0, 0.0
        for e in range(data.shape[0]):
            g = torch.Generator(device=dev)
            g.set_state(gens[e].get_state())
            res = run_full_field_evidence(
                pipe, likelihood="fom", noise_sigma=noise_sigma, data=data[e],
                n_particles=n_particles, n_groups=n_groups, n_mutations=n_mutations,
                ess_target=ess_target, max_stages=max_stages, generator=g, mesh=mesh, metrics=log)
            tot += res.log_evidence
            var += res.log_evidence_std ** 2
        log_z.append(tot)
        log_z_std.append(float(np.sqrt(var)))
        log.log("ell_evidence", ell=ell, log_z=tot, log_z_std=log_z_std[-1],
                n_datasets=int(data.shape[0]))

    lz = np.asarray(log_z, np.float64)
    post = np.exp(lz - lz.max())
    post /= post.sum()
    return {
        "ells": ells,
        "log_z": [round(float(v), 3) for v in lz],
        "log_z_std": [round(float(v), 3) for v in log_z_std],
        "posterior": [round(float(p), 4) for p in post],
        "ell_map": ells[int(np.argmax(lz))],
        "z_true": z_true,
        "data": data,
    }


_SAMPLERS = ("pcn", "laplace_mh", "gpcn", "pt_pcn", "pt_mala", "da_pcn", "pt_da_pcn", "mlda_pcn",
             "mala", "mala_lap", "hmc", "hmc_lap", "lis_pcn")


def run_full_field_inversion(
    pipe: FullFieldPipeline,
    *,
    likelihood: str = "rom_nn",
    sampler: str = "pcn",
    n_chains: int = 1024,
    n_steps: int = 5000,
    n_burn: int = 1000,
    beta: float = 0.3,
    noise_sigma: float = 1e-3,
    n_temps: int = 5,
    lambda_min: float = 0.02,
    # conservative: full-field surrogates carry more bias than the
    # five-parameter pipeline's, and DA's drift per outer step grows with
    # the subchain (the CLI passes 64, as the reference's does)
    subchain: int = 8,
    mala_step: float = 0.1,
    hmc_leap: int = 8,
    hmc_jitter: float = 0.2,
    da_inner: str = "pcn",
    mlda_resolution: int = 2,
    mlda_subchain: int = 4,
    adapt_ladder: bool = False,
    lis_points: int = 16,
    lis_rank: Optional[int] = None,
    lis_tol: float = 0.1,
    infer_noise: bool = False,
    z_true: Optional[torch.Tensor] = None,
    data: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    mesh=None,
    metrics: Optional[MetricsLogger] = None,
):
    """MCMC over the RFF coefficients. Returns (result, z_true, data, ess,
    rhat, wall_seconds), ess and rhat the rank-normalised split estimators.

    sampler: "pcn"; "laplace_mh" / "gpcn" (the MAP and its Gauss-Newton
    Laplace approximation in z first); "da_pcn" (rom_nn subchains of
    ``subchain`` steps, pCN or with ``da_inner="mala"`` MALA, corrected by
    the exact ``likelihood`` once an outer step; n_steps and n_burn count
    outer steps); "pt_pcn" / "pt_mala" (tempered, rom/rom_nn); "pt_da_pcn"
    (tempered delayed acceptance); "mala" / "mala_lap" and "hmc" /
    "hmc_lap" (gradient samplers, prior- or Laplace-preconditioned);
    "lis_pcn" (likelihood-informed-subspace pCN: ``lis_points`` Jacobians
    at the MAP and Laplace draws, eigenpairs above ``lis_tol``, at most
    ``lis_rank``); "mlda_pcn" (rom_nn subchains screened by the same
    field's FOM at ``mlda_resolution``, ``mlda_subchain`` of those per exact
    fine correction; likelihood must be fom).

    infer_noise: every misfit the noise-marginalised potential under
    InvGamma(2, noise_sigma^2); the Laplace and LIS machinery builds at the
    plug-in conditional mode of sigma at the MAP. data= inverts external
    observations (z_true then only for reporting). The draws come from
    ``generator`` (default seed 0): the truth and noise first, then the
    chains' starts, the warm-up run and the timed run, each from a child.
    An untimed warm-up run precedes the timed run (CUDA events on a card).
    On fom, up to 1,024 kept states are re-solved for the iteration audit
    (the "fom_iter_audit" event, a warning at the cap). mesh: the chain
    (group) axis of every sampler but laplace_mh and gpcn is split over its
    ranks (``api.run_inversion``'s contract)."""
    if sampler not in _SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}")
    if sampler in ("da_pcn", "pt_da_pcn") and likelihood == "rom_nn":
        raise ValueError(
            f"sampler={sampler!r} with likelihood='rom_nn' is degenerate: the coarse model is "
            "rom_nn, so the outer correction always accepts and each kept sample costs "
            "subchain + 1 evaluations of the same model. Set likelihood='fom' or use sampler='pcn'.")
    if sampler == "pt_pcn" and likelihood == "fom":
        raise NotImplementedError("pt_pcn with the fom likelihood puts a full-order solve in every "
                                  "step; use sampler='pt_da_pcn' instead")
    if sampler == "pt_mala" and likelihood == "fom":
        raise NotImplementedError("pt_mala with the fom likelihood puts a full-order solve and its "
                                  "adjoint in every step; use sampler='pt_da_pcn' with "
                                  "da_inner='mala' subchains instead")
    if sampler == "mlda_pcn" and likelihood != "fom":
        raise ValueError("mlda_pcn targets the fine FOM posterior through a resolution hierarchy; "
                         "set likelihood='fom' (for a single-screen surrogate chain use "
                         "sampler='da_pcn')")
    if sampler == "mlda_pcn" and mlda_resolution >= pipe.op.resolution:
        raise ValueError(f"mlda_resolution ({mlda_resolution}) must be coarser than the pipeline "
                         f"mesh ({pipe.op.resolution})")
    log = metrics or MetricsLogger()
    dev = pipe.device
    gen = _gen(pipe, generator)
    z_true, data = _observations(pipe, gen, z_true, data, noise_sigma)
    b0 = float(noise_sigma) ** 2
    if infer_noise:
        mk_misfit = lambda f: marginal_misfit(f, data, a0=2.0, b0=b0)
    else:
        mk_misfit = lambda f: gaussian_misfit(f, data, noise_sigma)
    fwd_b = pipe.batched_forward_fn(likelihood)
    misfit_b = mk_misfit(fwd_b)
    misfit_d = lambda lk=likelihood: mk_misfit(pipe.batched_forward_fn(lk, differentiable=True))
    fom = likelihood == "fom"
    warm = _WARMUP_FOM if fom else _WARMUP
    run_warm = None
    lap = None

    if sampler in ("laplace_mh", "gpcn", "mala_lap", "hmc_lap", "lis_pcn"):
        fwd_d = pipe.batched_forward_fn(likelihood, differentiable=True)
        with log.timer("map_laplace"):
            z_map, nlp = find_map(mk_misfit(fwd_d), pipe.prior, torch.zeros_like(pipe.prior.mean),
                                  maxiter=300)
            sig = noise_sigma
            if infer_noise:
                with torch.no_grad():
                    r_map = fwd_d(z_map[None])[0] - data
                sig = float(np.sqrt((b0 + 0.5 * float(torch.sum(r_map * r_map)))
                                    / (2.0 + 0.5 * r_map.shape[-1])))
            lap = laplace_approximation(fwd_d, data, sig, pipe.prior, z_map)
            _sync(dev)
        log.log("map", nlp=float(nlp))
        if sampler == "lis_pcn":
            with log.timer("build_lis"):
                pts = torch.cat([z_map[None], lap.sample(_child(gen), (max(lis_points - 1, 1),))])
                lis = build_lis(fwd_d, pipe.prior, pts, sig, lam_tol=lis_tol, rank_max=lis_rank)
            log.log("lis_built", rank=lis.rank, lam_max=float(lis.lam[0]), lam_min=float(lis.lam[-1]),
                    n_points=int(pts.shape[0]))
        theta0 = lap.sample(gen, (n_chains,))
    else:
        theta0 = pipe.prior.sample(gen, (n_chains,))

    if sampler == "laplace_mh":
        run = lambda g, n, nb: run_laplace_mh(misfit_b, pipe.prior, lap, theta0, g, n_steps=n, n_burn=nb)
    elif sampler == "gpcn":
        run = lambda g, n, nb: run_gpcn(misfit_b, pipe.prior, lap, theta0, g, n_steps=n, n_burn=nb,
                                        beta=beta)
    elif sampler == "lis_pcn":
        if fom:
            run = lambda g, n, nb: _runner(mesh, run_lis_pcn_segmented)(
                misfit_b, pipe.prior, lis, theta0, g, n_steps=n, n_burn=nb, beta=beta, segment=64)
        else:
            run = lambda g, n, nb: _runner(mesh, run_lis_pcn)(
                misfit_b, pipe.prior, lis, theta0, g, n_steps=n, n_burn=nb, beta=beta)
    elif sampler in ("mala", "mala_lap", "hmc", "hmc_lap"):
        ref = None if lap is None else (lap.mean, lap.chol)
        run, run_warm = _gradient_sampler_runner(
            sampler.replace("_lap", ""), likelihood, misfit_d(), pipe.prior, theta0, step=mala_step,
            thin=1, n_leap=hmc_leap, jitter=hmc_jitter, ref=ref, log=log, mesh=mesh)
    elif sampler == "pt_pcn":
        run = lambda g, n, nb: _runner(mesh, run_pt_pcn)(misfit_b, pipe.prior, theta0, g, n_steps=n, n_burn=nb,
                                          beta=beta, n_temps=n_temps, lambda_min=lambda_min,
                                          adapt_ladder=adapt_ladder)
    elif sampler == "pt_mala":
        misfit_pt = misfit_d()
        run = lambda g, n, nb: _runner(mesh, run_pt_mala)(misfit_pt, pipe.prior, theta0, g, n_steps=n, n_burn=nb,
                                           step=mala_step, n_temps=n_temps, lambda_min=lambda_min,
                                           adapt_ladder=adapt_ladder)
    elif sampler in ("da_pcn", "pt_da_pcn", "mlda_pcn"):
        warm = _WARMUP_FOM
        mala = da_inner == "mala"
        misfit_c = mk_misfit(pipe.batched_forward_fn("rom_nn", differentiable=mala))
        da_beta = mala_step if mala else beta
        if sampler == "mlda_pcn":
            misfits = (misfit_c, mk_misfit(coarse_fom_forward(pipe, mlda_resolution)), misfit_b)
            run = lambda g, n, nb: _runner(mesh, run_mlda_segmented)(
                misfits, pipe.prior, theta0, g, n_steps=n, n_burn=nb, beta=da_beta,
                subchains=(subchain, mlda_subchain), segment=32, inner=da_inner)
        elif sampler == "da_pcn":
            run = lambda g, n, nb: _runner(mesh, run_da_pcn_segmented)(
                misfit_b, misfit_c, pipe.prior, theta0, g, n_steps=n, n_burn=nb, beta=da_beta,
                subchain=subchain, segment=64 if fom else 512, inner=da_inner)
        else:
            run = lambda g, n, nb: _runner(mesh, run_pt_da_segmented)(
                misfit_b, misfit_c, pipe.prior, theta0, g, n_steps=n, n_burn=nb, beta=da_beta,
                subchain=subchain, n_temps=n_temps, lambda_min=lambda_min,
                segment=32 if fom else 512, inner=da_inner, adapt_ladder=adapt_ladder)
    elif fom:
        run = lambda g, n, nb: _runner(mesh, run_pcn_segmented)(misfit_b, pipe.prior, theta0, g, n_steps=n,
                                                 n_burn=nb, beta=beta, segment=64)
    else:
        run = lambda g, n, nb: _runner(mesh, run_pcn)(misfit_b, pipe.prior, theta0, g, n_steps=n, n_burn=nb,
                                       beta=beta)

    (run_warm or run)(_child(gen), min(n_steps, warm[0]), min(n_burn, warm[1]))
    _sync(dev)
    g_run = _child(gen)
    if dev.type == "cuda":
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        res = run(g_run, n_steps, n_burn)
        t1.record()
        t1.synchronize()
        wall = t0.elapsed_time(t1) / 1e3
    else:
        t_start = time.perf_counter()
        res = run(g_run, n_steps, n_burn)
        wall = time.perf_counter() - t_start

    ess = ess_bulk(res.samples)
    r = split_rhat(res.samples)
    T, C, d = res.samples.shape
    if fom and T > 0:
        idx = np.linspace(0, T * C - 1, min(_AUDIT_MAX, T * C)).astype(np.int64)
        states = res.samples.reshape(T * C, d)[torch.from_numpy(idx).to(dev)]
        _, iters = pipe.solver()(pipe.conductivity(states))
        it = iters.cpu().numpy()
        hit = float((it >= pipe.cg_maxiter).mean())
        log.log("fom_iter_audit", cap=pipe.cg_maxiter, max_iters=int(it.max()), hit_cap_frac=hit)
        if hit > 0:
            warnings.warn(f"{hit:.1%} of audited chain states hit the FOM solver iteration cap "
                          f"({pipe.cg_maxiter}): those solves are unconverged; raise cg_maxiter",
                          stacklevel=2)
    log.log("ff_inversion", likelihood=likelihood, sampler=sampler, wall_seconds=wall,
            samples_per_sec=T * C / wall, ess_min=float(torch.min(ess)),
            accept_rate=float(torch.mean(res.accept_rate)))
    return res, z_true, data, ess, r, wall


def predict_temperature_ff(pipe: FullFieldPipeline, samples: torch.Tensor, *, points=None,
                           n_draws: int = 256, noise_sigma: Optional[float] = None) -> FieldPrediction:
    """The posterior push-forward of the temperature field
    (``api.predict_temperature``'s contract): samples are kept states over
    z, (T, C, M) or (N, M); one batched solve (``solver``, the fom
    samplers' route) over the evenly thinned draws. Mesh-node order."""
    s = torch.as_tensor(samples, dtype=pipe.prior.mean.dtype, device=pipe.device)
    if s.dim() == 2:
        s = s[:, None, :]
    u, _ = pipe.solver()(pipe.conductivity(thin_samples(s, n_draws)))
    mesh, gid = pipe.node_mesh_ids()
    return predict_field(u, gid, mesh, points=points, noise_sigma=noise_sigma)


def predict_conductivity_ff(pipe: FullFieldPipeline, samples: torch.Tensor, *, points=None,
                            n_draws: int = 512) -> FieldPrediction:
    """The posterior of the log-conductivity field itself, per mesh node
    (mean, pointwise sd, quantiles). Linear in z: no solve, one (D, M) x
    (M, n_nodes) product over the thinned draws."""
    s = torch.as_tensor(samples, dtype=pipe.prior.mean.dtype, device=pipe.device)
    if s.dim() == 2:
        s = s[:, None, :]
    mesh, _ = pipe.node_mesh_ids()
    return predict_field(pipe.node_theta(thin_samples(s, n_draws)), np.arange(mesh.n_nodes), mesh,
                         points=points)


def run_sbc_check_ff(
    pipe: FullFieldPipeline,
    likelihood: str = "rom_nn",
    *,
    noise_sigma: float = 1e-2,
    n_datasets: int = 128,
    n_chains: int = 31,
    n_steps: int = 1500,
    n_burn: int = 1000,
    beta: float = 0.25,
    n_bins: int = 8,
    sampler: str = "pcn",
    step: float = 0.1,
    n_leap: int = 8,
    n_temps: int = 5,
    lambda_min: float = 0.02,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    metrics: Optional[MetricsLogger] = None,
):
    """Simulation-based calibration of the full-field sampler stack
    (``infer/sbc.py``, ``api.run_sbc_check``'s contract): J synthetic
    M-dimensional inversions from the pipeline's own N(0, I) prior and
    Gaussian likelihood at noise_sigma, all J x C chains one batch. With M
    p-values the minimum is expected small under uniformity: gate it on a
    Sidak-corrected threshold, as the CLI does. The draws come from
    ``generator``, else from ``seed``. Logs the "sbc_ff" event."""
    fwd = pipe.batched_forward_fn(likelihood, differentiable=sampler in ("mala", "hmc"))
    gen = _gen(pipe, generator, seed)
    res, wall = _timed(pipe.device, lambda: run_sbc(
        fwd, pipe.prior, noise_sigma, gen, n_datasets=n_datasets, n_chains=n_chains,
        n_steps=n_steps, n_burn=n_burn, beta=beta, n_bins=n_bins, sampler=sampler, step=step,
        n_leap=n_leap, n_temps=n_temps, lambda_min=lambda_min))
    if metrics is not None:
        metrics.log("sbc_ff", likelihood=likelihood, n_datasets=n_datasets, n_chains=n_chains,
                    sampler=sampler, noise_sigma=noise_sigma, p_min=float(torch.min(res.p_values)),
                    wall_seconds=wall)
    return res


def run_eki_inversion_ff(pipe: FullFieldPipeline, likelihood: str = "rom_nn", *,
                         noise_sigma: float = 1e-3, n_ensemble: int = 1024, ess_target: float = 0.5,
                         z_true: Optional[torch.Tensor] = None, data: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None, mesh=None,
                         metrics: Optional[MetricsLogger] = None):
    """Ensemble Kalman inversion of the full-field model (``infer/eki.py``):
    the M-dimensional posterior approximated in ~10-20 batched forwards
    (on fom each a K3r solve over the ensemble). Returns (EKIResult, z_true,
    data, wall_seconds)."""
    gen = _gen(pipe, generator)
    z_true, data = _observations(pipe, gen, z_true, data, noise_sigma)
    fwd_b = pipe.batched_forward_fn(likelihood)
    res, wall = _timed(pipe.device, lambda: run_eki(fwd_b, pipe.prior, data, noise_sigma, _child(gen),
                                                    n_ensemble=n_ensemble, ess_target=ess_target,
                                                    mesh=mesh))
    if metrics is not None:
        metrics.log("eki_ff", likelihood=likelihood, n_ensemble=n_ensemble, n_iters=len(res.ts) - 1,
                    n_forward=res.n_forward, misfit_final=res.misfit_trace[-1], wall_seconds=wall)
    return res, z_true, data, wall


def run_vi_inversion_ff(pipe: FullFieldPipeline, likelihood: str = "rom_nn", *,
                        noise_sigma: float = 1e-3, rank: str = "full", n_steps: int = 1500,
                        n_mc: int = 32, lr: float = 0.05, z_true: Optional[torch.Tensor] = None,
                        data: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None, mesh=None,
                        metrics: Optional[MetricsLogger] = None):
    """ADVI of the full-field posterior (``infer/vi.py``): q = N(mu, L L^T)
    over z, rank "full" carrying the whole M x M covariance. Mode-seeking:
    at the multimodal noise_sigma=1e-3 it describes one basin. Returns
    (VIResult, z_true, data, wall_seconds)."""
    gen = _gen(pipe, generator)
    z_true, data = _observations(pipe, gen, z_true, data, noise_sigma)
    misfit_b = gaussian_misfit(pipe.batched_forward_fn(likelihood, differentiable=True), data,
                               noise_sigma)
    res, wall = _timed(pipe.device, lambda: _runner(mesh, run_advi)(
        misfit_b, pipe.prior, _child(gen), n_steps=n_steps, n_mc=n_mc, rank=rank, lr=lr))
    if metrics is not None:
        metrics.log("vi_ff", likelihood=likelihood, rank=rank, n_steps=n_steps, n_mc=n_mc,
                    n_forward=res.n_forward, elbo_final=float(torch.mean(res.elbo_trace[-50:])),
                    wall_seconds=wall)
    return res, z_true, data, wall


def run_svgd_inversion_ff(pipe: FullFieldPipeline, likelihood: str = "rom_nn", *,
                          noise_sigma: float = 1e-3, n_particles: int = 512, n_steps: int = 800,
                          lr: float = 0.05, anneal_steps: Optional[int] = None,
                          z_true: Optional[torch.Tensor] = None, data: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None, segment: Optional[int] = None,
                          mesh=None, metrics: Optional[MetricsLogger] = None):
    """SVGD of the full-field posterior (``infer/svgd.py``): nonparametric
    and gradient-based; at d = M its spreads are lower bounds. Annealed by
    default. segment: the reference's scan chunk size (changes nothing
    here). Returns (SVGDResult, z_true, data, wall_seconds)."""
    gen = _gen(pipe, generator)
    z_true, data = _observations(pipe, gen, z_true, data, noise_sigma)
    misfit_b = gaussian_misfit(pipe.batched_forward_fn(likelihood, differentiable=True), data,
                               noise_sigma)
    res, wall = _timed(pipe.device, lambda: _runner(mesh, run_svgd)(
        misfit_b, pipe.prior, _child(gen), n_particles=n_particles, n_steps=n_steps, lr=lr,
        anneal_steps=anneal_steps, segment=segment))
    if metrics is not None:
        metrics.log("svgd_ff", likelihood=likelihood, n_particles=n_particles, n_steps=n_steps,
                    n_forward=res.n_forward, misfit_final=float(res.misfit_trace[-1]),
                    wall_seconds=wall)
    return res, z_true, data, wall


def psis_certify_ff(pipe: FullFieldPipeline, q_mean: torch.Tensor, q_chol: torch.Tensor,
                    data: torch.Tensor, likelihood: str = "rom_nn", *, noise_sigma: float = 1e-3,
                    n_draws: int = 4096, generator: Optional[torch.Generator] = None,
                    mesh=None, metrics: Optional[MetricsLogger] = None):
    """PSIS certify-and-correct of a Gaussian fit over z (``infer/psis.py``):
    one batched forward over n_draws proposal draws (on fom one K3r solve),
    the k-hat gate and the weighted moments. Draws from ``generator``, else
    seed 7."""
    gen = _gen(pipe, generator, 7)
    data = torch.as_tensor(data, dtype=pipe.prior.mean.dtype, device=pipe.device)
    misfit_b = gaussian_misfit(pipe.batched_forward_fn(likelihood), data, noise_sigma)
    res = psis_correct(misfit_b, pipe.prior, q_mean, q_chol, gen, n_draws=n_draws, mesh=mesh)
    if metrics is not None:
        metrics.log("psis_ff", likelihood=likelihood, n_draws=n_draws, k_hat=res.k_hat, ess=res.ess,
                    reliable=res.reliable)
    return res


def run_flow_vi_inversion_ff(pipe: FullFieldPipeline, likelihood: str = "rom_nn", *,
                             noise_sigma: float = 1e-3, n_couplings: int = 6, hidden: int = 64,
                             pretrain: str = "smc", pretrain_particles: int = 2048,
                             pretrain_steps: int = 3000, n_mutations: int = 5, max_stages: int = 64,
                             n_steps: Optional[int] = None, n_mc: int = 64, lr: float = 0.003,
                             anneal_steps: Optional[int] = None, z_true: Optional[torch.Tensor] = None,
                             data: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None, mesh=None,
                             metrics: Optional[MetricsLogger] = None):
    """A normalizing-flow approximation of the full-field posterior
    (``infer/flow.py``): tempered SMC distilled into a coupling flow by
    maximum likelihood (pretrain "smc", mass-covering, for the multimodal
    default noise), or annealed reverse-KL flow-VI (pretrain "none").
    Returns (FlowVIResult, z_true, data, wall_seconds)."""
    if pretrain not in ("smc", "none"):
        raise ValueError(f"pretrain must be 'smc' or 'none', got {pretrain!r}")
    gen = _gen(pipe, generator)
    z_true, data = _observations(pipe, gen, z_true, data, noise_sigma)
    misfit_b = gaussian_misfit(pipe.batched_forward_fn(likelihood), data, noise_sigma)
    misfit_bd = gaussian_misfit(pipe.batched_forward_fn(likelihood, differentiable=True), data,
                                noise_sigma)
    (res, n_stages), wall = _timed(pipe.device, lambda: flow_fit_pipeline(
        misfit_b, misfit_bd, pipe.prior, _child(gen), n_couplings=n_couplings, hidden=hidden,
        pretrain=pretrain, pretrain_particles=pretrain_particles, pretrain_steps=pretrain_steps,
        n_mutations=n_mutations, max_stages=max_stages, n_steps=n_steps, n_mc=n_mc, lr=lr,
        anneal_steps=anneal_steps, mesh=mesh))
    if metrics is not None:
        metrics.log("flow_vi_ff", likelihood=likelihood, pretrain=pretrain, n_couplings=n_couplings,
                    smc_stages=n_stages, n_forward=res.n_forward, wall_seconds=wall)
    return res, z_true, data, wall


def psis_certify_flow_ff(pipe: FullFieldPipeline, flow_res, data: torch.Tensor,
                         likelihood: str = "rom_nn", *, noise_sigma: float = 1e-3,
                         n_draws: int = 4096, base_scale: float = 1.0,
                         generator: Optional[torch.Generator] = None, mesh=None,
                         metrics: Optional[MetricsLogger] = None):
    """``psis_certify_ff`` for a flow fit: the flow's exact log densities
    make the k-hat gate and the weighted moments apply to it. Draws from
    ``generator``, else seed 7."""
    gen = _gen(pipe, generator, 7)
    data = torch.as_tensor(data, dtype=pipe.prior.mean.dtype, device=pipe.device)
    misfit_b = gaussian_misfit(pipe.batched_forward_fn(likelihood), data, noise_sigma)
    res = flow_psis_certify(misfit_b, pipe.prior, flow_res, gen, n_draws=n_draws,
                            base_scale=base_scale, mesh=mesh)
    if metrics is not None:
        metrics.log("psis_flow_ff", likelihood=likelihood, n_draws=n_draws, k_hat=res.k_hat,
                    ess=res.ess, reliable=res.reliable)
    return res


def run_neutra_inversion_ff(pipe: FullFieldPipeline, flow_res, data: torch.Tensor,
                            likelihood: str = "rom_nn", *, noise_sigma: float = 1e-3,
                            z_true: Optional[torch.Tensor] = None, n_chains: int = 1024,
                            n_steps: int = 2000, n_burn: int = 1000, beta: float = 0.3,
                            thin: int = 1, generator: Optional[torch.Generator] = None,
                            metrics: Optional[MetricsLogger] = None) -> InversionResult:
    """Flow-preconditioned pCN on the exact full-field posterior
    (``infer/flow.py`` run_neutra_pcn). Draws from ``generator``, else seed
    11. Returns an InversionResult with the diagnostics of the pushed
    coefficient samples."""
    gen = _gen(pipe, generator, 11)
    dtype = pipe.prior.mean.dtype
    data = torch.as_tensor(data, dtype=dtype, device=pipe.device)
    z_true = torch.zeros_like(pipe.prior.mean) if z_true is None else z_true
    misfit_b = gaussian_misfit(pipe.batched_forward_fn(likelihood), data, noise_sigma)
    out, wall = _timed(pipe.device, lambda: run_neutra_pcn(
        flow_res, misfit_b, pipe.prior, gen, n_chains=n_chains, n_steps=n_steps, n_burn=n_burn,
        beta=beta, thin=thin))
    ess, ess_t, rh = ess_bulk(out.samples), ess_tail(out.samples), split_rhat(out.samples)
    n_total = out.samples.shape[0] * out.samples.shape[1]
    res = InversionResult(result=out, theta_true=z_true, data=data, ess=ess, rhat=rh,
                          wall_seconds=wall, samples_per_sec=n_total / wall,
                          ess_per_sec=float(torch.min(ess)) / wall, ess_tail=ess_t)
    if metrics is not None:
        metrics.log("neutra_ff", likelihood=likelihood, n_chains=n_chains, n_steps=n_steps,
                    rhat_split_max=float(torch.max(rh)), ess_bulk_min=float(torch.min(ess)),
                    accept_rate=float(torch.mean(out.accept_rate)), wall_seconds=wall)
    return res
