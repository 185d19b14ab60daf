"""High-level pipeline API.

``build_pipeline`` runs the offline stack (mesh -> stencil FOM -> batched
FOM snapshots through K1, K3r or K4r / K4c -> host-f64 POD and Galerkin projection ->
reduced preconditioner P0 -> ROM-error dataset -> tanh MLP trained with
Adam) on one device. ``run_inversion`` runs single-temperature pCN on the
``rom`` or ``rom_nn`` likelihood, or delayed-acceptance pCN (``da_pcn``):
subchains on the ``da_coarse`` surrogate corrected against the ``fom``
likelihood (or ``rom``), one batched FOM solve per outer step. Nothing moves
between devices on its own: asking for ``device="cuda"`` without a card
raises.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP.md item: pcn on the ``fom`` likelihood, the other samplers, the
MALA inner kernel of da_pcn, the ``high``/``fast`` online precision tiers,
box priors and the unknown-noise potential. Chains start from prior draws;
the other initialisations are ROADMAP.md queue 1, item 20.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.config import PipelineConfig
from bayesianinferencedl_tpu_torch.data.datasets import ErrorDataset, generate_error_dataset
from bayesianinferencedl_tpu_torch.fem.solve import pcg_fom
from bayesianinferencedl_tpu_torch.infer.delayed_acceptance import DAResult, run_da_pcn_segmented
from bayesianinferencedl_tpu_torch.infer.diagnostics import ess_bulk, ess_tail, split_rhat
from bayesianinferencedl_tpu_torch.infer.pcn import PCNResult, gaussian_misfit, run_pcn
from bayesianinferencedl_tpu_torch.infer.priors import BoxPrior, GaussianPrior
from bayesianinferencedl_tpu_torch.models.corrected import CorrectedForward
from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
from bayesianinferencedl_tpu_torch.models.surrogate import TrainedSurrogate, train_surrogate
from bayesianinferencedl_tpu_torch.ops.pcg_stencil import solve_fom_stencil
from bayesianinferencedl_tpu_torch.rom.galerkin import ReducedOperator
from bayesianinferencedl_tpu_torch.rom.pod import pod_basis_host
from bayesianinferencedl_tpu_torch.rom.snapshots import sample_log_uniform
from bayesianinferencedl_tpu_torch.utils.device import resolve_device
from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger
from bayesianinferencedl_tpu_torch.utils.ppc import ppc_chi2_pvalue

# the untimed warm-up run that precedes the timed one: pcn runs
# 2 * _WARMUP_STEPS steps (_WARMUP_STEPS burn-in); da_pcn runs _WARMUP_DA
# (outer steps, burn-in), each a subchain and a batched FOM solve, enough to
# build the kernels and allocate
_WARMUP_STEPS = 20
_WARMUP_DA = (2, 1)
_AUDIT_MAX = 1024  # kept states re-solved by the FOM iteration audit


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _set_online_precision(kind: str) -> None:
    """ROMConfig.online_precision. "highest" = full fp32 matmuls, with TF32
    off explicitly. The other tiers are TPU MXU pass counts (bf16x3, bf16)
    with no faithful torch counterpart yet."""
    if kind != "highest":
        raise NotImplementedError(
            f"online_precision={kind!r} (TPU bf16x3 / bf16 MXU passes) is not ported; "
            "it does not map onto TF32 — see ROADMAP.md §3 (precision tiers)"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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

    @property
    def device(self) -> torch.device:
        return self.rom.Ahat.device

    def batched_forward_fn(self, likelihood: str) -> Callable:
        """(C, d) log-conductivities -> (C, n_obs) observables for the chain
        hot loop: ``fom`` observes one batched FOM solve (tol ``fin.cg_tol``,
        cap ``fin.cg_maxiter``, ``make_fom_solver``); ``rom`` and ``rom_nn``
        go through the factorisation-free reduced PCG."""
        if likelihood == "fom":
            solve = make_fom_solver(self.fin, tol=self.fin.cg_tol, maxiter=self.fin.cg_maxiter)
            return lambda thetas: self.fin.op.observe(solve(torch.exp(thetas)))
        if likelihood not in ("rom", "rom_nn"):
            raise ValueError(f"unknown likelihood {likelihood!r}")
        ff = self.rom.fast_forward(self.P0, self.rom_pcg_iters)
        if likelihood == "rom":
            return lambda thetas: ff(torch.exp(thetas))
        return lambda thetas: ff(torch.exp(thetas)) + self.surrogate.predict(thetas)

    def forward_fn(self, likelihood: str) -> Callable:
        """theta (d,) -> observables (n_obs,)."""
        fb = self.batched_forward_fn(likelihood)
        return lambda theta: fb(theta[None])[0]


def make_prior(cfg_prior, dtype=torch.float32, device="cuda"):
    """PriorConfig -> prior object (log-normal k: Gaussian on theta = log k),
    on ``device`` (the card unless the caller asks for "cpu")."""
    if cfg_prior.kind == "gaussian":
        return GaussianPrior.iid(cfg_prior.dim, mean=cfg_prior.mean, sigma=cfg_prior.sigma,
                                 dtype=dtype, device=device)
    return BoxPrior.create(cfg_prior.dim, low=cfg_prior.low, high=cfg_prior.high, kind=cfg_prior.kind)


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
    _set_online_precision(cfg.rom.online_precision)

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
    rom_fwd = rom.fast_forward(P0, rom_pcg_iters)

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
        rom_pcg_iters=rom_pcg_iters,
    )


@dataclass
class InversionResult:
    result: Union[PCNResult, DAResult]
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


def _child(gen: torch.Generator) -> torch.Generator:
    """A fresh generator seeded from ``gen``'s stream."""
    seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device).item())
    return torch.Generator(device=gen.device).manual_seed(seed)


def run_inversion(
    pipe: Pipeline,
    *,
    likelihood: Optional[str] = None,
    sampler: Optional[str] = None,
    theta_true: Optional[torch.Tensor] = None,
    data: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    metrics: Optional[MetricsLogger] = None,
) -> InversionResult:
    """Bayesian inversion with batched chains on pipe's device: ``pcn`` on
    the rom/rom_nn likelihood, or ``da_pcn`` (delayed acceptance: subchains
    of ``cfg.subchain`` pCN steps on the ``cfg.da_coarse`` surrogate,
    Metropolis-corrected against ``likelihood``, in segments of 64 outer
    steps for fom and 512 otherwise; n_steps and n_burn count outer steps).

    data=None: theta_true is drawn from the prior (or given) and the noisy
    observations are simulated with one FOM solve. data=(n_obs,): invert
    those observations as they are. An untimed warm-up run precedes the
    timed run, which uses a fresh generator and is timed with CUDA events on
    a card. fom-likelihood runs re-solve up to 1,024 kept states and report
    the solver's iteration audit."""
    log = metrics or MetricsLogger()
    cfg = pipe.config.mcmc
    like = likelihood or cfg.likelihood
    smp = sampler or cfg.sampler
    if smp not in ("pcn", "da_pcn"):
        raise NotImplementedError(
            f"sampler {smp!r} is not ported yet (pt_pcn: ROADMAP.md queue 1, item 11; "
            "the others: items 17-21)"
        )
    if smp == "pcn" and like == "fom":
        raise NotImplementedError(
            "pcn on the fom likelihood runs in segments (run_pcn_segmented), which is not "
            "ported yet: ROADMAP.md queue 1, item 10; sampler='da_pcn' gives the fom posterior"
        )
    if smp == "da_pcn" and like == cfg.da_coarse:
        raise ValueError(
            f"sampler='da_pcn' with likelihood == da_coarse ({like!r}) is degenerate: the outer "
            "correction always accepts and each kept sample costs subchain + 1 evaluations of "
            "the same model. Set likelihood='fom' (the exact target) or use sampler='pcn'."
        )
    if cfg.infer_noise:
        raise NotImplementedError("infer_noise (marginal_misfit) is not ported yet: ROADMAP.md queue 1, item 10")
    fwd_b = pipe.batched_forward_fn(like)
    dev = pipe.device
    dtype = pipe.prior.mean.dtype
    _set_online_precision(pipe.config.rom.online_precision)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(cfg.seed)

    if data is not None:
        data = torch.as_tensor(data, dtype=dtype, device=dev)
        n_obs = pipe.fin.op.n_obs
        if tuple(data.shape) != (n_obs,):
            raise ValueError(f"external data must have shape ({n_obs},), got {tuple(data.shape)}")
        if theta_true is None:
            theta_true = pipe.prior.mean
    else:
        if theta_true is None:
            theta_true = pipe.prior.sample(gen)
        y_true = pipe.fin.forward(torch.exp(pipe.prior.to_theta(theta_true)))
        data = y_true + cfg.noise_sigma * torch.randn(y_true.shape, generator=gen, dtype=dtype, device=dev)

    misfit_b = gaussian_misfit(fwd_b, data, cfg.noise_sigma)
    theta0 = pipe.prior.sample(gen, (cfg.n_chains,))
    if smp == "pcn":
        warm = (2 * _WARMUP_STEPS, _WARMUP_STEPS)
        run = lambda g, n_steps, n_burn: run_pcn(
            misfit_b, pipe.prior, theta0, g, n_steps=n_steps, n_burn=n_burn,
            beta=cfg.beta, thin=cfg.thin,
        )
    else:
        warm = _WARMUP_DA
        misfit_c = gaussian_misfit(pipe.batched_forward_fn(cfg.da_coarse), data, cfg.noise_sigma)
        segment = 64 if like == "fom" else 512
        run = lambda g, n_steps, n_burn: run_da_pcn_segmented(
            misfit_b, misfit_c, pipe.prior, theta0, g, n_steps=n_steps, n_burn=n_burn,
            beta=cfg.beta, subchain=cfg.subchain, segment=segment, inner=cfg.da_inner,
        )

    run(_child(gen), min(cfg.n_steps, warm[0]), min(cfg.n_burn, warm[1]))
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

    ppc = None
    if T > 0:
        ppc = ppc_chi2_pvalue(fwd_b, res.samples, data, cfg.noise_sigma, _child(gen))
        log.log("ppc", **ppc)

    n_kept = T * C
    out = InversionResult(
        result=res, theta_true=theta_true, data=data, ess=ess, rhat=r,
        wall_seconds=wall, samples_per_sec=n_kept / wall,
        ess_per_sec=float(torch.min(ess)) / wall, ess_tail=ess_t, ppc=ppc,
        fom_iter_cap=cap, fom_iter_max=it_max, fom_hit_cap_frac=hit_frac,
    )
    extra = {}
    if smp == "da_pcn":
        extra = dict(inner_accept_rate=float(torch.mean(res.inner_accept_rate)),
                     n_fine_evals=res.n_fine_evals, subchain=cfg.subchain)
    log.log(
        "inversion", likelihood=like, sampler=smp, wall_seconds=wall,
        samples_per_sec=out.samples_per_sec, ess_min=float(torch.min(ess)),
        ess_tail_min=float(torch.min(ess_t)), ess_per_sec=out.ess_per_sec,
        accept_rate=float(torch.mean(res.accept_rate)), rhat_max=float(torch.max(r)), **extra,
    )
    return out
