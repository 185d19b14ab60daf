"""Typed configuration objects, the port's own copy of the JAX package's
``config.py``: the same frozen dataclasses, fields and defaults, so one
config dict means the same pipeline on both sides (the tests hold
``PipelineConfig()`` equal field for field). The field comments describe the
reference's measured behaviour; options the port does not run yet raise
``NotImplementedError`` where they are used.

Every stage of the pipeline is parameterized by a frozen dataclass that
serializes to/from plain dicts so it can be embedded in every checkpoint and
metrics record for reproducibility.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _asdict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


@dataclass(frozen=True)
class MeshConfig:
    """Thermal-fin mesh resolution. ``resolution`` n gives cell size h=0.25/n."""

    resolution: int = 4

    def to_dict(self):
        return _asdict(self)


@dataclass(frozen=True)
class FEMConfig:
    """Full-order model configuration (SURVEY.md §7 stage 2).

    biot: Robin boundary coefficient Bi on the exterior boundary.
    cg_tol / cg_maxiter: batched Jacobi-PCG stopping controls; the iteration
        budget is fixed per-batch (vmap-uniform) with an early-exit predicate
        on the batch-max residual.
    refine_steps: rounds of f32-solve + high-precision-residual iterative
        refinement used to push accuracy below plain-f32 PCG (SURVEY.md §7
        "Hard parts" #1).
    """

    biot: float = 0.1
    cg_tol: float = 1e-10
    cg_maxiter: int = 2000
    refine_steps: int = 0
    dtype: str = "float32"

    def to_dict(self):
        return _asdict(self)


@dataclass(frozen=True)
class ROMConfig:
    """Reduced-order model configuration (SURVEY.md §7 stage 3).

    online_precision: "highest" (full f32 online solves; default), "high"
    (3-pass bf16x3 CG matmuls: measured 1.6x chain throughput with solver
    error ~6e-4 — below the surrogate's own ~4e-4-1e-3 validation error —
    and posterior means matching "highest" to Monte-Carlo precision), or
    "fast" (single-pass bf16, ~2.6x; the NN surrogate is trained on the same
    path and absorbs most of the systematic solver error, but the residual
    ~1e-3-scale bias shifts tight posteriors — measured full-pipeline
    posterior KS 0.05-0.3 at 1e-3 observation noise. Opt-in for exploratory
    runs or noise >= ~1e-2; keep "highest"/"high" for final posteriors).
    """

    n_snapshots: int = 256
    basis_size: int = 40
    method: str = "pod"  # "pod" | "greedy"
    greedy_candidates: int = 256
    online_precision: str = "highest"  # "highest" | "high" | "fast"
    # deployed reduced-PCG iteration count; 0 = auto max(15, r/2) — the
    # measured posterior-accuracy knee at the production 1e-3 noise
    # (api.build_pipeline; artifacts/iter_frontier_r4.json). The knee
    # trades corrected-forward headroom for throughput: at r=40 the
    # 20-iter holdout corrected error is ~4e-4 (vs 8.8e-5 at 30 iters) —
    # still under the 1e-3 noise floor. For tighter instruments
    # (mcmc.noise_sigma < 5e-4) build_pipeline auto-bumps the 0-default to
    # 3r/4 with a warning (advisor r4); set online_iters explicitly to
    # override. The surrogate trains on whatever path is deployed, so
    # under-converged solves leave k-rough error the NN cannot learn
    # (scripts/iter_frontier.py).
    online_iters: int = 0
    seed: int = 0

    def to_dict(self):
        return _asdict(self)


@dataclass(frozen=True)
class SurrogateConfig:
    """ROM-error NN surrogate (SURVEY.md §7 stage 4; reference: Keras MLP)."""

    hidden: Tuple[int, ...] = (64, 64)
    activation: str = "tanh"
    learning_rate: float = 1e-3
    batch_size: int = 128
    epochs: int = 500
    n_train: int = 1024
    seed: int = 0

    def to_dict(self):
        return _asdict(self)


@dataclass(frozen=True)
class PriorConfig:
    """Prior over conductivities (SURVEY.md A.5).

    kind="gaussian": theta = log k ~ N(mean, sigma^2 I) (log-normal k).
    kind="uniform" / "log_uniform": k_i ~ U[low, high] (resp. log k_i
    uniform on [log low, log high]), realized as the probit push-forward of
    a standard Gaussian so pCN's reference measure stays exactly Gaussian
    (infer.priors.BoxPrior); mean/sigma are ignored.
    """

    mean: float = 0.0
    sigma: float = 0.6
    dim: int = 5
    kind: str = "gaussian"  # "gaussian" | "uniform" | "log_uniform"
    low: float = 0.1
    high: float = 10.0

    def to_dict(self):
        return _asdict(self)


@dataclass(frozen=True)
class MCMCConfig:
    """MCMC configuration (SURVEY.md §7 stage 5).

    sampler: "pcn" (prior-referenced, adaptive per-chain beta),
             "laplace_mh" (independence MH with the Laplace approximation as
             proposal), "gpcn" (pCN wrt the Laplace reference measure), or
             "pt_pcn" (parallel-tempered pCN — the exact sampler for
             multimodal posteriors; n_chains then counts COLD chains and
             total compute is n_temps x n_chains misfits per step), or
             "da_pcn" (delayed acceptance: subchains of cheap `da_coarse`
             pCN steps corrected against the exact `likelihood` potential —
             the FOM posterior at ~1/subchain of the FOM evaluations;
             n_steps/n_burn then count OUTER steps), or "pt_da_pcn"
             (tempered delayed acceptance: the exact `likelihood` posterior
             on a MULTIMODAL problem — DA subchains per temperature level,
             swaps on the carried fine misfits), or "mala" (prior-
             preconditioned Metropolis-adjusted Langevin on autodiff
             gradients of the misfit — FOM gradients are exact adjoints via
             custom_linear_solve), or "mala_lap" (MALA preconditioned with
             the Laplace approximation computed at the MAP — posterior-
             covariance steps, exact on non-Gaussian posteriors where the
             laplace_mh independence sampler mixes poorly), or "pt_mala"
             (MALA within every temperature level + replica exchange — pays
             over pt_pcn only when cold-level autocorrelation is
             within-basin dominated, i.e. high-dimensional targets; on the
             5-param fin it measured +7% ESS at 2.3x cost, see
             docs/SAMPLERS.md), or "hmc"/"hmc_lap" (jittered-trajectory
             Hamiltonian Monte Carlo, prior- or Laplace-preconditioned —
             hmc_leap fused gradient passes per trajectory buy multi-step
             moves; measured ~9x MALA's ESS per gradient evaluation at
             d=16, infer/hmc.py), or "mlda_pcn" (multilevel delayed
             acceptance through a mesh-resolution hierarchy; infer/mlda.py).
    n_temps / lambda_min: temperature-ladder controls for pt_pcn
             (geometric inverse temperatures lambda_min .. 1).
    adapt_ladder: tune the ladder itself during burn-in (stochastic
             approximation driving every adjacent pair's swap acceptance
             toward 0.234, per chain group; the geometric ladder is then
             only the starting point — infer/tempering.py). Frozen after
             burn-in, so post-burn invariance is exact.
    subchain / da_coarse: delayed-acceptance controls (inner steps per fine
             correction; the surrogate likelihood screening proposals).
    mlda_resolution / mlda_subchain: sampler="mlda_pcn" (multilevel delayed
             acceptance, infer/mlda.py) controls: the MID rung is the FOM at
             mesh resolution mlda_resolution (< the pipeline's resolution),
             screened by `subchain` base (da_coarse surrogate) steps per mid
             step and `mlda_subchain` mid steps per fine correction.
    """

    n_chains: int = 1024
    n_steps: int = 10_000
    n_burn: int = 1_000
    beta: float = 0.25
    noise_sigma: float = 1e-3
    # infer_noise: treat the observation noise sigma as UNKNOWN — integrate
    # it out analytically under the conjugate prior
    # sigma^2 ~ InvGamma(2, noise_sigma^2) (infer/pcn.py marginal_misfit)
    # instead of conditioning on noise_sigma, which then softens from a hard
    # assumption into a prior scale guess (E[sigma^2] = noise_sigma^2,
    # infinite prior variance). Every sampler runs unchanged on the marginal
    # potential; the sigma posterior (conjugate InvGamma given theta) is
    # recovered per kept draw and reported in
    # InversionResult.noise_sigma_post. With m = n_obs observations and a
    # parameter count near m, the residual carries few noise dof, so the
    # sigma posterior stays prior-influenced — that is the honest width.
    infer_noise: bool = False
    likelihood: str = "rom_nn"  # "fom" | "rom" | "rom_nn"
    sampler: str = "pcn"  # pcn | laplace_mh | gpcn | pt_pcn | pt_mala | da_pcn | pt_da_pcn | mala | mala_lap
    seed: int = 0
    thin: int = 1
    n_temps: int = 4
    lambda_min: float = 0.05
    adapt_ladder: bool = False
    # DA coarse steps per fine correction. 64 = the r5 measured deployment
    # (artifacts/da_frontier_r5.json): one batched FOM correction costs
    # ~75x a rom_nn subchain step, so longer subchains amortize it almost
    # for free while DA stays EXACT for every S — ESS/s on the 1e-2 fin
    # posterior: S=8 909, S=32 5.3k, S=64 9.1k (10.0x, deployed), S=128
    # 15.9x, S=256 17.4x but ESS/kept already 0.90 (the one-ESS-per-outer-
    # step ceiling) with coarse cost visible. S=64 keeps 1.6x headroom
    # below the knee and half S=128's subchain drift exposure for weaker
    # surrogates (outer acceptance was 0.998 throughout HERE because the
    # NN-corrected ROM is accurate; a biased surrogate pays more drift per
    # subchain step — see mlda_vs_da_r3.json for the weak-surrogate regime).
    subchain: int = 64
    da_coarse: str = "rom_nn"
    # DA subchain kernel for da_pcn AND pt_da_pcn: "pcn" (random walk) or
    # "mala" (gradient-informed — better subchain decorrelation per fine
    # evaluation; infer/mala.py. Initial step size is then mala_step.)
    da_inner: str = "pcn"
    mala_step: float = 0.1  # initial MALA/HMC step size h (adapted per chain)
    mlda_resolution: int = 2  # mid-rung FOM mesh resolution (mlda_pcn)
    mlda_subchain: int = 4  # mid-rung steps per fine correction (mlda_pcn)
    # hmc / hmc_lap (infer/hmc.py): leapfrog steps per trajectory (each costs
    # one fused forward+reverse likelihood pass) and the +-20%-default
    # trajectory-length jitter breaking periodic-orbit resonances
    hmc_leap: int = 8
    hmc_jitter: float = 0.2

    def to_dict(self):
        return _asdict(self)


@dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout. The chain/snapshot batch axis is sharded over
    ``axis_name`` across all visible devices (ICI within a slice)."""

    axis_name: str = "devices"
    n_devices: Optional[int] = None  # None -> every visible device

    def to_dict(self):
        return _asdict(self)


@dataclass(frozen=True)
class PipelineConfig:
    """Everything needed for the full end-to-end inversion pipeline."""

    mesh: MeshConfig = field(default_factory=MeshConfig)
    fem: FEMConfig = field(default_factory=FEMConfig)
    rom: ROMConfig = field(default_factory=ROMConfig)
    surrogate: SurrogateConfig = field(default_factory=SurrogateConfig)
    prior: PriorConfig = field(default_factory=PriorConfig)
    mcmc: MCMCConfig = field(default_factory=MCMCConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def to_dict(self):
        return _asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PipelineConfig":
        return cls(
            mesh=MeshConfig(**d.get("mesh", {})),
            fem=FEMConfig(**d.get("fem", {})),
            rom=ROMConfig(**{k: (tuple(v) if k == "hidden" else v) for k, v in d.get("rom", {}).items()}),
            surrogate=SurrogateConfig(
                **{k: (tuple(v) if k == "hidden" else v) for k, v in d.get("surrogate", {}).items()}
            ),
            prior=PriorConfig(**d.get("prior", {})),
            mcmc=MCMCConfig(**d.get("mcmc", {})),
            parallel=ParallelConfig(**d.get("parallel", {})),
        )
