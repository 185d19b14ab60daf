"""The sharded runners: chains, snapshots, training shards and the
approximation layer's Monte Carlo axes over the ranks of a 1-D mesh
(``parallel/mesh.py``).

Every rank calls the same function with the same arguments. A family whose
chains (or chain groups) never talk runs the port's single-device runner on
the rank's block of the chain axis, with the rank's generator
(``mesh.rank_generator``, the counterpart of the reference's ``fold_in(key,
axis_index)``), and gathers every output on its chain axis in rank order, as
the reference's ``out_specs`` P(axis) / P(None, axis) do: every rank returns
the whole result, so the diagnostics downstream run unchanged. The tempered
families' swap rates are means over the ranks. Pre-drawn draws for the whole
batch may be passed: each rank takes its own chains' rows (the normals'
chain axis is their second last, every other draw's its last), which is what
holds a world of n to a world of 1.

The segmented forms run the port's segmented runners on the shard: chain
states, adapted step sizes and ladders carry across segments on each rank
exactly as they do on one device.

A world of 1 is the unsharded run bit for bit: rank 0 draws from the
caller's generator, and a gather or mean over one rank is a copy. Across
world sizes the stencil kernels' last bits may differ, since each rank
solves its own batch.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.parallel.mesh import (
    gather_rows,
    mean_all,
    rank_generator,
    rank_of,
    shard_rows,
    size_of,
)

MEAN = "mean"  # a gather spec: the mean over the ranks

# gather specs: field -> its chain axis, MEAN, or a nested spec; fields left
# out (counts, static tuples) are the same on every rank and pass through
_PCN = {"state": {"theta": 0, "phi": 0, "n_accept": 0}, "samples": 1, "phi_trace": 1,
        "accept_rate": 0, "beta": 0}
_MALA = {"state": {"y": 0, "nlp": 0, "phi": 0, "grad": 0, "n_accept": 0}, "samples": 1,
         "phi_trace": 1, "accept_rate": 0, "step": 0}
_DA = {"state": {"theta": 0, "phi_f": 0, "phi_c": 0, "n_accept": 0}, "samples": 1, "phi_trace": 1,
       "accept_rate": 0, "inner_accept_rate": 0, "beta": 0}
_MLDA = {"state": {"theta": 0, "phi": 0, "phi_sub": 0, "rate_stack": 1}, "samples": 1,
         "phi_trace": 1, "accept_rate": 0, "level_rates": 1, "beta": 0}
# tempered results: every (K, G...) field on its group axis, the swap rate a mean
_PT_FIELDS = ("samples", "phi_trace", "accept_rate", "inner_accept_rate", "beta", "step", "theta",
              "lambdas", "phi_level_mean", "phi2_level_mean", "ss_level_mean")
_PT = {**{f: 1 for f in _PT_FIELDS}, "swap_rate": MEAN}
_D_AXIS_DRAWS = ("normals", "eps")  # draws with a trailing parameter axis


def _gather(mesh: DeviceMesh, res, spec: dict):
    """res (a NamedTuple) with its fields gathered as ``spec`` says."""
    out = {}
    for name, how in spec.items():
        if not hasattr(res, name):
            continue
        v = getattr(res, name)
        if isinstance(how, dict):
            out[name] = _gather(mesh, v, how)
        elif how == MEAN:
            out[name] = mean_all(mesh, v)
        else:
            out[name] = gather_rows(mesh, v, how)
    return res._replace(**out)


def _rows(mesh: DeviceMesh, x, axis: int):
    """The rank's rows of a whole-batch tensor (tuples, lists and dicts of
    them too), or None."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _draw_rows(mesh, k, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_rows(mesh, v, axis) for v in x)
    return shard_rows(mesh, x, x.dim() + axis if axis < 0 else axis)


def _draw_rows(mesh: DeviceMesh, name: str, x):
    return _rows(mesh, x, -2 if name in _D_AXIS_DRAWS else -1)


def _draws(mesh: DeviceMesh, draws: dict) -> dict:
    return {k: _draw_rows(mesh, k, v) for k, v in draws.items()}


def _per_chain(mesh: DeviceMesh, v):
    """A scalar passes; a per-chain tensor (..., C) gives the rank's block
    of its last axis."""
    return v if not torch.is_tensor(v) or v.dim() == 0 else shard_rows(mesh, v, v.dim() - 1)


def _run_chains(mesh, runner: Callable, theta0, gen, spec: dict, *, draws: dict, chain_axis: int = 0,
                args: tuple = (), **kw):
    """runner(*args, theta0 block, rank generator, **kw, **rank draws), its
    result gathered by spec."""
    theta_l = shard_rows(mesh, theta0, chain_axis)
    res = runner(*args, theta_l, rank_generator(gen, mesh), **kw, **_draws(mesh, draws))
    return _gather(mesh, res, spec)


# --- chain-independent families ---------------------------------------------------


def sharded_pcn(mesh: DeviceMesh, misfit_fn: Callable, prior: GaussianPrior, theta0: torch.Tensor,
                gen: Optional[torch.Generator] = None, *, n_steps: int, n_burn: int = 0, beta=0.25,
                thin: int = 1, adapt_t0=0.0, normals=None, uniforms=None):
    """pCN (``infer.pcn.run_pcn``) with the chain batch (C divisible by the
    world size) sharded over the mesh; beta scalar or per-chain (C,)."""
    from bayesianinferencedl_tpu_torch.infer.pcn import run_pcn

    return _run_chains(mesh, run_pcn, theta0, gen, _PCN, args=(misfit_fn, prior),
                       draws=dict(normals=normals, uniforms=uniforms), n_steps=n_steps,
                       n_burn=n_burn, beta=_per_chain(mesh, beta), thin=thin,
                       adapt_t0=float(adapt_t0))


def sharded_pcn_segmented(mesh: DeviceMesh, misfit_fn: Callable, prior: GaussianPrior,
                          theta0: torch.Tensor, gen: Optional[torch.Generator] = None, *,
                          n_steps: int, n_burn: int = 0, beta=0.25, segment: int = 64,
                          normals=None, uniforms=None):
    """``run_pcn_segmented`` on each rank's chains, gathered."""
    from bayesianinferencedl_tpu_torch.infer.pcn import run_pcn_segmented

    return _run_chains(mesh, run_pcn_segmented, theta0, gen, _PCN, args=(misfit_fn, prior),
                       draws=dict(normals=normals, uniforms=uniforms), n_steps=n_steps,
                       n_burn=n_burn, beta=_per_chain(mesh, beta), segment=segment)


def sharded_mala(mesh: DeviceMesh, misfit_fn: Callable, prior: GaussianPrior, theta0: torch.Tensor,
                 gen: Optional[torch.Generator] = None, *, n_steps: int, n_burn: int = 0, step=0.1,
                 thin: int = 1, adapt_t0=0.0, ref=None, normals=None, uniforms=None):
    """Preconditioned MALA (``infer.mala.run_mala``), chains sharded; the
    gradients are each rank's own chains'."""
    from bayesianinferencedl_tpu_torch.infer.mala import run_mala

    return _run_chains(mesh, run_mala, theta0, gen, _MALA, args=(misfit_fn, prior),
                       draws=dict(normals=normals, uniforms=uniforms), n_steps=n_steps,
                       n_burn=n_burn, step=_per_chain(mesh, step), thin=thin,
                       adapt_t0=float(adapt_t0), ref=ref)


def sharded_mala_segmented(mesh: DeviceMesh, misfit_fn: Callable, prior: GaussianPrior,
                           theta0: torch.Tensor, gen: Optional[torch.Generator] = None, *,
                           n_steps: int, n_burn: int = 0, step=0.1, segment: int = 32, ref=None,
                           normals=None, uniforms=None):
    """``run_mala_segmented`` on each rank's chains, gathered."""
    from bayesianinferencedl_tpu_torch.infer.mala import run_mala_segmented

    return _run_chains(mesh, run_mala_segmented, theta0, gen, _MALA, args=(misfit_fn, prior),
                       draws=dict(normals=normals, uniforms=uniforms), n_steps=n_steps,
                       n_burn=n_burn, step=_per_chain(mesh, step), segment=segment, ref=ref)


def sharded_hmc(mesh: DeviceMesh, misfit_fn: Callable, prior: GaussianPrior, theta0: torch.Tensor,
                gen: Optional[torch.Generator] = None, *, n_steps: int, n_burn: int = 0, step=0.1,
                n_leap: int = 8, jitter: float = 0.2, thin: int = 1, adapt_t0=0.0, ref=None,
                normals=None, jitters=None, uniforms=None):
    """Jittered-trajectory HMC (``infer.hmc.run_hmc``), chains sharded."""
    from bayesianinferencedl_tpu_torch.infer.hmc import run_hmc

    return _run_chains(mesh, run_hmc, theta0, gen, _MALA, args=(misfit_fn, prior),
                       draws=dict(normals=normals, jitters=jitters, uniforms=uniforms),
                       n_steps=n_steps, n_burn=n_burn, step=_per_chain(mesh, step), n_leap=n_leap,
                       jitter=jitter, thin=thin, adapt_t0=float(adapt_t0), ref=ref)


def sharded_hmc_segmented(mesh: DeviceMesh, misfit_fn: Callable, prior: GaussianPrior,
                          theta0: torch.Tensor, gen: Optional[torch.Generator] = None, *,
                          n_steps: int, n_burn: int = 0, step=0.1, n_leap: int = 8,
                          jitter: float = 0.2, segment=None, ref=None, normals=None, jitters=None,
                          uniforms=None):
    """``run_hmc_segmented`` on each rank's chains, gathered; segment=None
    is max(1, 32 // n_leap) trajectories."""
    from bayesianinferencedl_tpu_torch.infer.hmc import run_hmc_segmented

    return _run_chains(mesh, run_hmc_segmented, theta0, gen, _MALA, args=(misfit_fn, prior),
                       draws=dict(normals=normals, jitters=jitters, uniforms=uniforms),
                       n_steps=n_steps, n_burn=n_burn, step=_per_chain(mesh, step), n_leap=n_leap,
                       jitter=jitter, segment=segment or max(1, 32 // n_leap), ref=ref)


def sharded_lis_pcn(mesh: DeviceMesh, misfit_fn: Callable, prior: GaussianPrior, lis,
                    theta0: torch.Tensor, gen: Optional[torch.Generator] = None, *, n_steps: int,
                    n_burn: int = 0, beta=0.5, thin: int = 1, adapt_t0=0.0, normals=None,
                    uniforms=None):
    """Likelihood-informed-subspace pCN (``infer.lis.run_lis_pcn``), chains
    sharded; the LIS basis is the same on every rank."""
    from bayesianinferencedl_tpu_torch.infer.lis import run_lis_pcn

    return _run_chains(mesh, run_lis_pcn, theta0, gen, _PCN, args=(misfit_fn, prior, lis),
                       draws=dict(normals=normals, uniforms=uniforms), n_steps=n_steps,
                       n_burn=n_burn, beta=_per_chain(mesh, beta), thin=thin,
                       adapt_t0=float(adapt_t0))


def sharded_lis_pcn_segmented(mesh: DeviceMesh, misfit_fn: Callable, prior: GaussianPrior, lis,
                              theta0: torch.Tensor, gen: Optional[torch.Generator] = None, *,
                              n_steps: int, n_burn: int = 0, beta=0.5, segment: int = 64,
                              normals=None, uniforms=None):
    """``run_lis_pcn_segmented`` on each rank's chains, gathered."""
    from bayesianinferencedl_tpu_torch.infer.lis import run_lis_pcn_segmented

    return _run_chains(mesh, run_lis_pcn_segmented, theta0, gen, _PCN,
                       args=(misfit_fn, prior, lis), draws=dict(normals=normals, uniforms=uniforms),
                       n_steps=n_steps, n_burn=n_burn, beta=_per_chain(mesh, beta), segment=segment)


def sharded_da_pcn(mesh: DeviceMesh, misfit_fine: Callable, misfit_coarse: Callable,
                   prior: GaussianPrior, theta0: torch.Tensor, gen: Optional[torch.Generator] = None,
                   *, n_steps: int, n_burn: int = 0, beta=0.25, subchain: int = 8, adapt_t0=0.0,
                   inner: str = "pcn", normals=None, uniforms=None, outer_uniforms=None):
    """Delayed-acceptance pCN (``infer.delayed_acceptance.run_da_pcn``),
    chains sharded: each rank runs its own batched fine evaluations."""
    from bayesianinferencedl_tpu_torch.infer.delayed_acceptance import run_da_pcn

    return _run_chains(mesh, run_da_pcn, theta0, gen, _DA, args=(misfit_fine, misfit_coarse, prior),
                       draws=dict(normals=normals, uniforms=uniforms, outer_uniforms=outer_uniforms),
                       n_steps=n_steps, n_burn=n_burn, beta=_per_chain(mesh, beta),
                       subchain=subchain, adapt_t0=float(adapt_t0), inner=inner)


def sharded_da_pcn_segmented(mesh: DeviceMesh, misfit_fine: Callable, misfit_coarse: Callable,
                             prior: GaussianPrior, theta0: torch.Tensor,
                             gen: Optional[torch.Generator] = None, *, n_steps: int,
                             n_burn: int = 0, beta=0.25, subchain: int = 8, segment: int = 64,
                             inner: str = "pcn", normals=None, uniforms=None, outer_uniforms=None):
    """``run_da_pcn_segmented`` on each rank's chains, gathered."""
    from bayesianinferencedl_tpu_torch.infer.delayed_acceptance import run_da_pcn_segmented

    return _run_chains(mesh, run_da_pcn_segmented, theta0, gen, _DA,
                       args=(misfit_fine, misfit_coarse, prior),
                       draws=dict(normals=normals, uniforms=uniforms, outer_uniforms=outer_uniforms),
                       n_steps=n_steps, n_burn=n_burn, beta=_per_chain(mesh, beta),
                       subchain=subchain, segment=segment, inner=inner)


def _group_axis(theta0: torch.Tensor) -> int:
    """A tempered run's theta0 is (G, d) cold inits or (K, G, d) states."""
    return 0 if theta0.dim() == 2 else 1


def sharded_pt_pcn(mesh: DeviceMesh, misfit_fn: Callable, prior: GaussianPrior,
                   theta0: torch.Tensor, gen: Optional[torch.Generator] = None, *, n_steps: int,
                   n_burn: int = 0, beta=0.25, n_temps: int = 4, lambda_min: float = 0.05,
                   adapt_ladder: bool = False, ladder=None, normals=None, uniforms=None,
                   swap_uniforms=None):
    """Parallel-tempered pCN (``infer.tempering.run_pt_pcn``) with the chain
    groups sharded: each rank holds the whole K-level ladder of its groups,
    swaps stay on the rank, and the swap rate is the mean over the ranks.
    beta and ladder: scalars, (K,), or per group (K, G)."""
    from bayesianinferencedl_tpu_torch.infer.tempering import run_pt_pcn

    return _run_chains(mesh, run_pt_pcn, theta0, gen, _PT, args=(misfit_fn, prior),
                       chain_axis=_group_axis(theta0),
                       draws=dict(normals=normals, uniforms=uniforms, swap_uniforms=swap_uniforms),
                       n_steps=n_steps, n_burn=n_burn, beta=_per_group(mesh, beta),
                       n_temps=n_temps, lambda_min=lambda_min, adapt_ladder=adapt_ladder,
                       ladder=_per_group(mesh, ladder))


def _per_group(mesh: DeviceMesh, v):
    """A scalar, None or (K,) passes; (K, G) gives the rank's groups."""
    return shard_rows(mesh, v, 1) if torch.is_tensor(v) and v.dim() == 2 else v


def sharded_pt_mala(mesh: DeviceMesh, misfit_fn: Callable, prior: GaussianPrior,
                    theta0: torch.Tensor, gen: Optional[torch.Generator] = None, *, n_steps: int,
                    n_burn: int = 0, step=0.1, n_temps: int = 4, lambda_min: float = 0.05,
                    adapt_ladder: bool = False, normals=None, uniforms=None, swap_uniforms=None):
    """Tempered MALA (``infer.tempering.run_pt_mala``) with the chain groups
    sharded, as ``sharded_pt_pcn``."""
    from bayesianinferencedl_tpu_torch.infer.tempering import run_pt_mala

    return _run_chains(mesh, run_pt_mala, theta0, gen, _PT, args=(misfit_fn, prior),
                       chain_axis=_group_axis(theta0),
                       draws=dict(normals=normals, uniforms=uniforms, swap_uniforms=swap_uniforms),
                       n_steps=n_steps, n_burn=n_burn, step=_per_group(mesh, step),
                       n_temps=n_temps, lambda_min=lambda_min, adapt_ladder=adapt_ladder)


def sharded_pt_da(mesh: DeviceMesh, misfit_fine: Callable, misfit_coarse: Callable,
                  prior: GaussianPrior, theta0: torch.Tensor, gen: Optional[torch.Generator] = None,
                  *, n_steps: int, n_burn: int = 0, beta=0.25, subchain: int = 8, n_temps: int = 4,
                  lambda_min: float = 0.05, adapt_t0=0.0, inner: str = "pcn",
                  adapt_ladder: bool = False, ladder=None, normals=None, uniforms=None,
                  outer_uniforms=None, swap_uniforms=None):
    """Tempered delayed acceptance (``infer.tempering.run_pt_da``) with the
    chain groups sharded, as ``sharded_pt_pcn``."""
    from bayesianinferencedl_tpu_torch.infer.tempering import run_pt_da

    return _run_chains(mesh, run_pt_da, theta0, gen, _PT, args=(misfit_fine, misfit_coarse, prior),
                       chain_axis=_group_axis(theta0),
                       draws=dict(normals=normals, uniforms=uniforms, outer_uniforms=outer_uniforms,
                                  swap_uniforms=swap_uniforms),
                       n_steps=n_steps, n_burn=n_burn, beta=_per_group(mesh, beta),
                       subchain=subchain, n_temps=n_temps, lambda_min=lambda_min,
                       adapt_t0=float(adapt_t0), inner=inner, adapt_ladder=adapt_ladder,
                       ladder=_per_group(mesh, ladder))


def sharded_pt_da_segmented(mesh: DeviceMesh, misfit_fine: Callable, misfit_coarse: Callable,
                            prior: GaussianPrior, theta0: torch.Tensor,
                            gen: Optional[torch.Generator] = None, *, n_steps: int,
                            n_burn: int = 0, beta=0.25, subchain: int = 8, n_temps: int = 4,
                            lambda_min: float = 0.05, segment: int = 32, inner: str = "pcn",
                            adapt_ladder: bool = False, ladder=None, normals=None, uniforms=None,
                            outer_uniforms=None, swap_uniforms=None):
    """``run_pt_da_segmented`` on each rank's chain groups, gathered; the
    per-level states, betas and ladders carry across segments on each rank."""
    from bayesianinferencedl_tpu_torch.infer.tempering import run_pt_da_segmented

    return _run_chains(mesh, run_pt_da_segmented, theta0, gen, _PT,
                       args=(misfit_fine, misfit_coarse, prior), chain_axis=_group_axis(theta0),
                       draws=dict(normals=normals, uniforms=uniforms, outer_uniforms=outer_uniforms,
                                  swap_uniforms=swap_uniforms),
                       n_steps=n_steps, n_burn=n_burn, beta=_per_group(mesh, beta),
                       subchain=subchain, n_temps=n_temps, lambda_min=lambda_min, segment=segment,
                       inner=inner, adapt_ladder=adapt_ladder, ladder=_per_group(mesh, ladder))


def sharded_mlda(mesh: DeviceMesh, misfits: tuple, prior: GaussianPrior, theta0: torch.Tensor,
                 gen: Optional[torch.Generator] = None, *, n_steps: int, n_burn: int = 0, beta=0.25,
                 subchains: tuple = (8, 4), adapt_t0=0.0, inner: str = "pcn", normals=None,
                 uniforms=None):
    """Multilevel delayed acceptance (``infer.mlda.run_mlda``), chains
    sharded: every rung's batch evaluations are the rank's own."""
    from bayesianinferencedl_tpu_torch.infer.mlda import run_mlda

    return _run_chains(mesh, run_mlda, theta0, gen, _MLDA, args=(misfits, prior),
                       draws=dict(normals=normals, uniforms=uniforms), n_steps=n_steps,
                       n_burn=n_burn, beta=_per_chain(mesh, beta), subchains=subchains,
                       adapt_t0=float(adapt_t0), inner=inner)


def sharded_mlda_segmented(mesh: DeviceMesh, misfits: tuple, prior: GaussianPrior,
                           theta0: torch.Tensor, gen: Optional[torch.Generator] = None, *,
                           n_steps: int, n_burn: int = 0, beta=0.25, subchains: tuple = (8, 4),
                           segment: int = 32, inner: str = "pcn", normals=None, uniforms=None):
    """``run_mlda_segmented`` on each rank's chains, gathered."""
    from bayesianinferencedl_tpu_torch.infer.mlda import run_mlda_segmented

    return _run_chains(mesh, run_mlda_segmented, theta0, gen, _MLDA, args=(misfits, prior),
                       draws=dict(normals=normals, uniforms=uniforms), n_steps=n_steps,
                       n_burn=n_burn, beta=_per_chain(mesh, beta), subchains=subchains,
                       segment=segment, inner=inner)


# --- snapshots, training shards, row-sharded sweeps ---------------------------


def sharded_snapshots(mesh: DeviceMesh, op, ks: torch.Tensor, *, tol: float = 1e-10,
                      maxiter: int = 3000) -> torch.Tensor:
    """FOM snapshots (N, n) with the sample axis (N divisible by the world
    size) sharded: each rank solves its block by the route an unsharded
    sweep takes, the stencil kernels for a float32 stencil operator
    (``ops.pcg_stencil.solve_fom_stencil``: K3r, or K4r / K4c on the
    largest meshes), else the plain PCG of ``rom.snapshots.generate_snapshots``
    (float64, the ELL layout); then the blocks are gathered in rank order."""
    from bayesianinferencedl_tpu_torch.models.five_param import on_kernels
    from bayesianinferencedl_tpu_torch.ops.pcg_stencil import solve_fom_stencil
    from bayesianinferencedl_tpu_torch.rom.snapshots import generate_snapshots

    k_l = shard_rows(mesh, torch.as_tensor(ks, dtype=op.dtype, device=op.device), 0)
    if on_kernels(op):
        S = solve_fom_stencil(op, k_l, tol=tol, maxiter=maxiter)[0]
    else:
        S = generate_snapshots(op, k_l, tol=tol, maxiter=maxiter)
    return gather_rows(mesh, S, 0)


def sharded_rows_fn(mesh: Optional[DeviceMesh], fn: Callable) -> Callable:
    """fn over a batch (B, ...) with B divisible by the world size, each
    rank evaluating its block and the blocks gathered in rank order (the
    reference's sweeps over a row-sharded ensemble or draw batch); fn itself
    for mesh=None."""
    if mesh is None:
        return fn
    return lambda x: gather_rows(mesh, fn(shard_rows(mesh, x, 0)), 0)


def dp_train_step(mesh: DeviceMesh, mlp, params, opt_state, xb: torch.Tensor, yb: torch.Tensor,
                  lr: float):
    """One data-parallel surrogate training step: each rank's loss
    mean((mlp(x) - y)^2) and its gradient on its block of the batch, the
    gradients all-reduced to their mean over the ranks (the reference divides
    its psum by the world size), then the same Adam update on every rank.
    params: the leaves [W0, b0, ...] loaded into mlp (its own ``params()``
    are updated in place). Returns (params, opt_state, loss), the loss the
    mean over the ranks."""
    from bayesianinferencedl_tpu_torch.models.surrogate import adam_update

    leaves = mlp.params()
    with torch.no_grad():
        for p, q in zip(leaves, params):
            if p is not q:
                p.copy_(q)
    x_l, y_l = shard_rows(mesh, xb, 0), shard_rows(mesh, yb, 0)
    with torch.enable_grad():
        loss = torch.mean((mlp(x_l) - y_l) ** 2)
        grads = torch.autograd.grad(loss, leaves)
    loss, *grads = mean_all(mesh, [loss.detach(), *grads])
    opt_state = adam_update(leaves, grads, opt_state, lr)
    return leaves, opt_state, loss


# --- families with collectives inside the step --------------------------------


def sharded_smc(mesh: DeviceMesh, misfit_fn: Callable, prior: GaussianPrior,
                gen: Optional[torch.Generator] = None, *, n_particles: int = 4096,
                n_mutations: int = 5, ess_target: float = 0.5, beta: float = 0.5,
                max_stages: int = 64):
    """Island SMC: one tempered-SMC population of n_particles / world size
    per rank (``infer.smc.run_smc``, the rank's generator). Islands never
    talk during the run; then one gather of the island log Z gives the
    combined estimate logsumexp(lz) - log(n_islands), the mean in Z of
    unbiased estimates. Returns (SMCResult, lz): the islands as the result's
    groups (particles (n_islands, N / n_islands, d), the per-stage
    diagnostics (max_stages, n_islands)), its log_evidence the combined
    estimate."""
    from bayesianinferencedl_tpu_torch.infer.smc import run_smc

    n = size_of(mesh)
    if n_particles % n:
        raise ValueError(f"n_particles {n_particles} not divisible by mesh size {n}")
    res = run_smc(misfit_fn, prior, rank_generator(gen, mesh), n_particles=n_particles // n,
                  n_mutations=n_mutations, ess_target=ess_target, beta=beta, max_stages=max_stages)
    res = _gather(mesh, res, {"particles": 0, "phi": 0, "log_evidence": 0, "n_stages": 0,
                              "lambdas": 1, "ess_frac": 1, "accept_rate": 1, "beta": 0})
    lz = res.log_evidence
    return res._replace(log_evidence=torch.logsumexp(lz, 0) - math.log(n)), lz


def sharded_hmc_chees(mesh: DeviceMesh, misfit_fn: Callable, prior: GaussianPrior,
                      theta0: torch.Tensor, gen: Optional[torch.Generator] = None, *,
                      n_steps: int, n_burn: int = 0, step=0.1,
                      leap_candidates=(1, 2, 4, 8, 16, 32), jitter: float = 0.2,
                      n_adapt: int = 24, n_meas: int = 24, thin: int = 1, ref=None, draws=None):
    """ChEES-tuned HMC (``infer.hmc.run_hmc_chees``) with the chains
    sharded: in each probe the centring mean, the criterion and the accept
    rate are means over the ranks, so every rank picks the same n_leap; the
    chain states and per-chain step sizes stay sharded throughout. draws:
    run_hmc_chees's dict for the whole batch. Returns (MALAResult, info)."""
    from bayesianinferencedl_tpu_torch.infer.hmc import run_hmc_chees

    res, info = run_hmc_chees(misfit_fn, prior, shard_rows(mesh, theta0, 0), rank_generator(gen, mesh),
                              n_steps=n_steps, n_burn=n_burn, step=_per_chain(mesh, step),
                              leap_candidates=leap_candidates, jitter=jitter, n_adapt=n_adapt,
                              n_meas=n_meas, thin=thin, ref=ref,
                              draws=None if draws is None else _rows(mesh, draws, -1), group=mesh)
    return _gather(mesh, res, _MALA), info


def sharded_advi(mesh: DeviceMesh, misfit_fn: Callable, prior: GaussianPrior,
                 gen: Optional[torch.Generator] = None, *, n_steps: int = 1500, n_mc: int = 256,
                 rank: str = "full", lr: float = 0.05, lr_decay: float = 0.05, theta0=None,
                 ref=None, segment=None, eps=None):
    """ADVI (``infer.vi.run_advi``) with the Monte Carlo draws sharded: each
    rank integrates n_mc / world size draws (its rows of eps (n_steps, n_mc,
    d), else its generator's), and the loss and gradients are all-reduced to
    their means before the replicated Adam update. Returns run_advi's
    VIResult, the ELBO trace the mean over the ranks."""
    from bayesianinferencedl_tpu_torch.infer.vi import run_advi

    n = size_of(mesh)
    if n_mc % n:
        raise ValueError(f"n_mc={n_mc} must divide by mesh size {n}")
    res = run_advi(misfit_fn, prior, rank_generator(gen, mesh), n_steps=n_steps, n_mc=n_mc // n,
                   rank=rank, lr=lr, lr_decay=lr_decay, theta0=theta0, ref=ref, segment=segment,
                   eps=_rows(mesh, eps, -2), group=mesh)
    return res._replace(n_forward=n_mc * n_steps)


def sharded_flow_vi(mesh: DeviceMesh, misfit_fn: Callable, prior: GaussianPrior,
                    gen: Optional[torch.Generator] = None, *, n_couplings: int = 6,
                    hidden: int = 32, n_steps: int = 3000, n_mc: int = 256, lr: float = 0.01,
                    lr_decay: float = 0.05, anneal_steps=None, lambda0: float = 0.05, ref=None,
                    segment=None, n_summary: int = 4096, params=None, eps=None, summary_Z=None):
    """Flow-VI (``infer.flow.run_flow_vi``) with the Monte Carlo draws
    sharded, as ``sharded_advi``. The flow's initial couplings (without
    params) and the summary draws come from gen on every rank alike, before
    the rank's step draws. Returns run_flow_vi's FlowVIResult."""
    from bayesianinferencedl_tpu_torch.infer.flow import _flow_to_train, run_flow_vi

    n = size_of(mesh)
    if n_mc % n:
        raise ValueError(f"n_mc={n_mc} must divide by mesh size {n}")
    d = prior.dim
    dtype, dev = prior.mean.dtype, prior.mean.device
    flow0 = _flow_to_train(params, d, n_couplings, hidden, gen, dtype, dev)
    if summary_Z is None:
        summary_Z = torch.randn((n_summary, d), generator=gen, dtype=dtype, device=dev)
    res = run_flow_vi(misfit_fn, prior, rank_generator(gen, mesh), n_couplings=n_couplings,
                      hidden=hidden, n_steps=n_steps, n_mc=n_mc // n, lr=lr, lr_decay=lr_decay,
                      anneal_steps=anneal_steps, lambda0=lambda0, ref=ref, params=flow0,
                      n_summary=n_summary, segment=segment, eps=_rows(mesh, eps, -2),
                      summary_Z=summary_Z, group=mesh)
    return res._replace(n_forward=n_mc * n_steps)


def sharded_svgd(mesh: DeviceMesh, misfit_fn: Callable, prior: GaussianPrior,
                 gen: Optional[torch.Generator] = None, *, n_particles: int = 512,
                 n_steps: int = 800, lr: float = 0.05, lr_decay: float = 0.05, anneal_steps=None,
                 theta0=None, ref=None, segment=None):
    """SVGD (``infer.svgd.run_svgd``) with the particles sharded: each rank
    runs the differentiable forward and reverse pass on its block, then the
    (J, d) ensemble and its scores are gathered in rank order each step so
    every rank forms the same full-ensemble Stein direction (the median
    bandwidth sees the unsharded row order) and keeps its own rows. Without
    theta0 the initial ensemble is drawn whole from gen on every rank, as
    ``run_svgd`` draws it. Returns run_svgd's SVGDResult over the whole
    ensemble."""
    from bayesianinferencedl_tpu_torch.infer.svgd import run_svgd
    from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul

    n = size_of(mesh)
    if theta0 is None:
        ref_mean, ref_chol = ref if ref is not None else (prior.mean, prior.chol)
        Y = torch.randn((n_particles, prior.dim), generator=gen, dtype=prior.mean.dtype,
                        device=prior.mean.device)
        with fp32_matmul():
            theta0 = ref_mean + Y @ ref_chol.T
    J = int(theta0.shape[0])
    if J % n:
        raise ValueError(f"n_particles={J} must divide by mesh size {n}")
    res = run_svgd(misfit_fn, prior, None, n_particles=J // n, n_steps=n_steps, lr=lr,
                   lr_decay=lr_decay, anneal_steps=anneal_steps, theta0=shard_rows(mesh, theta0, 0),
                   ref=ref, segment=segment, group=mesh)
    particles = gather_rows(mesh, res.particles, 0)
    return res._replace(particles=particles, mean=torch.mean(particles, dim=0),
                        std=torch.std(particles, dim=0, correction=0))
