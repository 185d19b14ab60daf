"""Disk-checkpointed chain runs with exact resume.

Each runner here is the segmented run of its sampler (``infer.segmented.
drive_segments``, the loop of ``run_pcn_segmented`` and its kin) with a
checkpoint after every segment: one npz (``utils.checkpoint``) holding the
chain state, the adapted step sizes (and ladder), the raw accept counts and
the state of the run's ``torch.Generator``, and beside it
``<ckpt_path>.samples_<step>.npz`` with the segment's kept samples and
misfits. A killed run started again with the same arguments and
``resume=True`` reloads the last checkpoint, its samples and the generator
state, and continues the identical random stream: its samples, final state
and accept accounting equal an uninterrupted run's bit for bit, and an
uninterrupted run equals the sampler's segmented run on the same generator.

The file is the port's own (a JAX chain checkpoint holds threefry keys and
does not resume here). Its leaves, in order: the runner's carry in the
order of its ``layout`` (name, dtype), the counts of the rates present
(their names and dtypes in the meta, in the runner's rate order), then the
generator state as uint8. The meta holds the step reached, the segments
run, the kept steps and the steps at which sample files were written.

Runners: ``run_pcn_checkpointed``, ``run_mala_checkpointed``,
``run_hmc_checkpointed``, ``run_da_checkpointed``, ``run_pt_checkpointed``
and ``run_pt_da_checkpointed`` (the tempered two refuse an odd segment).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.infer.delayed_acceptance import DAResult, DAState, run_da_pcn
from bayesianinferencedl_tpu_torch.infer.hmc import run_hmc
from bayesianinferencedl_tpu_torch.infer.mala import MALAResult, MALAState, frame, run_mala
from bayesianinferencedl_tpu_torch.infer.pcn import PCNResult, PCNState, run_pcn
from bayesianinferencedl_tpu_torch.infer.segmented import (
    RateSpec,
    SegmentProgress,
    accept_rate_spec,
    drive_segments,
    inner_accept_rate_spec,
    swap_rate_spec,
)
from bayesianinferencedl_tpu_torch.infer.tempering import PTDAResult, PTResult, run_pt_da, run_pt_pcn
from bayesianinferencedl_tpu_torch.utils.checkpoint import load_checkpoint, np_dtype, read_meta, save_checkpoint
from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

Layout = Sequence[Tuple[str, torch.dtype]]


def _run_checkpointed(
    tag: str,
    seg: Callable,
    carry: Dict[str, torch.Tensor],
    layout: Layout,
    gen: torch.Generator,
    *,
    n_steps: int,
    n_burn: int,
    segment: int,
    rates: Dict[str, RateSpec],
    ckpt_path: str,
    resume: bool,
    metrics: Optional[MetricsLogger],
    log_accept: Callable,
):
    """The one skeleton behind every runner here: ``drive_segments`` over
    seg(carry, this, burn, start) -> (res, carry), a checkpoint after each
    segment, and a resume from the last one. carry maps the layout's names
    to tensors once a segment has run. Returns (carry, samples, phis,
    rates_out, progress)."""
    log = metrics or MetricsLogger()
    device = next(iter(carry.values())).device
    pr = SegmentProgress()
    chunk_steps: list = []
    if resume and os.path.exists(ckpt_path):
        meta = read_meta(ckpt_path)
        counted = meta["counts"]
        exemplar = ([(name, None, np_dtype(dt)) for name, dt in layout]
                    + [(f"count.{name}", None, np.dtype(dt)) for name, dt in counted]
                    + [("generator", None, np.uint8)])
        leaves, _ = load_checkpoint(ckpt_path, exemplar)
        on_dev = lambda a: torch.from_numpy(a).to(device)
        carry = {name: on_dev(leaves[name]) for name, _ in layout}
        pr.counts = {name: on_dev(leaves[f"count.{name}"]) for name, _ in counted}
        gen.set_state(torch.from_numpy(leaves["generator"]))
        pr.done, pr.n_segments, pr.total_kept = meta["step"], meta["n_segments"], meta["accept_steps"]
        chunk_steps = list(meta["chunk_steps"])
        for s in chunk_steps:
            with np.load(f"{ckpt_path}.samples_{s}.npz") as z:
                pr.s_chunks.append(on_dev(z["samples"]))
                pr.p_chunks.append(on_dev(z["phis"]))
        log.log(f"{tag}chain_resume", step=pr.done, chunks=len(pr.s_chunks))
        if pr.done >= n_steps and not pr.s_chunks:
            raise ValueError(f"{ckpt_path} holds a finished {pr.done}-step run with no kept sample")

    def save(pr: SegmentProgress, carry, res) -> None:
        if res.samples.shape[0] > 0:
            np.savez_compressed(f"{ckpt_path}.samples_{pr.done}.npz",
                                samples=res.samples.detach().cpu().numpy(),
                                phis=res.phi_trace.detach().cpu().numpy())
            chunk_steps.append(pr.done)
        counted = [name for name in rates if pr.counts.get(name) is not None]
        save_checkpoint(
            ckpt_path,
            [carry[name] for name, _ in layout] + [pr.counts[name] for name in counted]
            + [gen.get_state()],
            meta={"step": pr.done, "n_segments": pr.n_segments, "accept_steps": pr.total_kept,
                  "chunk_steps": chunk_steps,
                  "counts": [[name, str(np_dtype(pr.counts[name].dtype))] for name in counted]},
        )
        log.log(f"{tag}chain_checkpoint", step=pr.done, **log_accept(res))

    _, carry, samples, phis, rates_out, _ = drive_segments(
        seg, carry, n_steps=n_steps, n_burn=n_burn, segment=segment, rates=rates, progress=pr,
        on_segment=save)
    return carry, samples, phis, rates_out, pr


def _betas(beta, theta0: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(beta, dtype=theta0.dtype, device=theta0.device).expand(theta0.shape[:-1])


def run_pcn_checkpointed(
    misfit_fn: Callable,
    prior,
    theta0: torch.Tensor,
    gen: torch.Generator,
    *,
    n_steps: int,
    n_burn: int = 0,
    beta=0.25,
    segment: int = 1000,
    ckpt_path: str = "chain_ckpt.npz",
    resume: bool = True,
    metrics: Optional[MetricsLogger] = None,
) -> PCNResult:
    """``run_pcn_segmented`` with a checkpoint after every segment and exact
    resume (module docstring): chain states, misfits, accept counts and
    adapted per-chain betas."""
    dt = theta0.dtype

    def seg(c, this, burn, start):
        res = run_pcn(misfit_fn, prior, c["theta"], gen, n_steps=this, n_burn=burn, beta=c["beta"],
                      adapt_t0=float(start))
        s = res.state
        return res, {"theta": s.theta, "phi": s.phi, "n_accept": s.n_accept, "beta": res.beta}

    layout = [("theta", dt), ("phi", dt), ("n_accept", torch.int32), ("beta", dt)]
    c, samples, phis, rates, _ = _run_checkpointed(
        "", seg, {"theta": theta0, "beta": _betas(beta, theta0)}, layout, gen, n_steps=n_steps,
        n_burn=n_burn, segment=segment, rates={"accept": accept_rate_spec()}, ckpt_path=ckpt_path,
        resume=resume, metrics=metrics,
        log_accept=lambda res: {"accept": float(torch.mean(res.accept_rate))})
    return PCNResult(state=PCNState(c["theta"], c["phi"], c["n_accept"]), samples=samples,
                     phi_trace=phis, accept_rate=rates["accept"], beta=c["beta"])


def _gradient_checkpointed(run_fn, run_kw: dict, tag: str, misfit_fn, prior, theta0, gen, *,
                           n_steps, n_burn, step, segment, ref, ckpt_path, resume,
                           metrics) -> MALAResult:
    """The checkpointed run of a whitened-frame gradient sampler (run_mala or
    run_hmc, both returning MALAResult): the working-coordinate states and
    the adapted step sizes carry across segments, as ``mala.segmented``
    carries them; the last state is kept for the result."""
    dt = theta0.dtype
    to_theta, _ = frame(*(ref if ref is not None else (prior.mean, prior.chol)))

    def seg(c, this, burn, start):
        res = run_fn(misfit_fn, prior, c["theta"], gen, n_steps=this, n_burn=burn, step=c["step"],
                     thin=1, adapt=True, adapt_t0=float(start), ref=ref, **run_kw)
        return res, {"theta": to_theta(res.state.y), "step": res.step, **res.state._asdict()}

    layout = [("theta", dt), ("step", dt), ("y", dt), ("nlp", dt), ("phi", dt), ("grad", dt),
              ("n_accept", torch.int32)]
    c, samples, phis, rates, _ = _run_checkpointed(
        f"{tag}_", seg, {"theta": theta0, "step": _betas(step, theta0)}, layout, gen,
        n_steps=n_steps, n_burn=n_burn, segment=segment, rates={"accept": accept_rate_spec()},
        ckpt_path=ckpt_path, resume=resume, metrics=metrics,
        log_accept=lambda res: {"accept": float(torch.mean(res.accept_rate))})
    state = MALAState(*(c[f] for f in MALAState._fields))
    return MALAResult(state=state, samples=samples, phi_trace=phis, accept_rate=rates["accept"],
                      step=c["step"])


def run_mala_checkpointed(
    misfit_fn: Callable,
    prior,
    theta0: torch.Tensor,
    gen: torch.Generator,
    *,
    n_steps: int,
    n_burn: int = 0,
    step=0.1,
    segment: int = 1000,
    ref: Optional[tuple] = None,
    ckpt_path: str = "mala_chain_ckpt.npz",
    resume: bool = True,
    metrics: Optional[MetricsLogger] = None,
) -> MALAResult:
    """Preconditioned MALA (``run_mala``) checkpointed after every segment,
    with exact resume: working-coordinate states, adapted per-chain step
    sizes, accept counts and the generator state."""
    return _gradient_checkpointed(run_mala, {}, "mala", misfit_fn, prior, theta0, gen,
                                  n_steps=n_steps, n_burn=n_burn, step=step, segment=segment,
                                  ref=ref, ckpt_path=ckpt_path, resume=resume, metrics=metrics)


def run_hmc_checkpointed(
    misfit_fn: Callable,
    prior,
    theta0: torch.Tensor,
    gen: torch.Generator,
    *,
    n_steps: int,
    n_burn: int = 0,
    step=0.1,
    n_leap: int = 8,
    jitter: float = 0.2,
    segment: int = 500,
    ref: Optional[tuple] = None,
    ckpt_path: str = "hmc_chain_ckpt.npz",
    resume: bool = True,
    metrics: Optional[MetricsLogger] = None,
) -> MALAResult:
    """Jittered-trajectory HMC (``run_hmc``; n_steps count trajectories)
    under ``run_mala_checkpointed``'s contract."""
    return _gradient_checkpointed(run_hmc, {"n_leap": n_leap, "jitter": jitter}, "hmc", misfit_fn,
                                  prior, theta0, gen, n_steps=n_steps, n_burn=n_burn, step=step,
                                  segment=segment, ref=ref, ckpt_path=ckpt_path, resume=resume,
                                  metrics=metrics)


def run_da_checkpointed(
    misfit_fine: Callable,
    misfit_coarse: Callable,
    prior,
    theta0: torch.Tensor,
    gen: torch.Generator,
    *,
    n_steps: int,
    n_burn: int = 0,
    beta=0.25,
    subchain: int = 8,
    segment: int = 200,
    inner: str = "pcn",
    ckpt_path: str = "da_chain_ckpt.npz",
    resume: bool = True,
    metrics: Optional[MetricsLogger] = None,
) -> DAResult:
    """Delayed-acceptance pCN (``run_da_pcn_segmented``; n_steps count
    outer steps, each one batched fine evaluation) checkpointed after every
    segment, with exact resume: the runs with a full-order solve in every
    outer step are the long ones worth protecting."""
    dt = theta0.dtype

    def seg(c, this, burn, start):
        res = run_da_pcn(misfit_fine, misfit_coarse, prior, c["theta"], gen, n_steps=this,
                         n_burn=burn, beta=c["beta"], subchain=subchain, adapt_t0=float(start),
                         inner=inner)
        return res, {**res.state._asdict(), "beta": res.beta}

    layout = [("theta", dt), ("phi_f", dt), ("phi_c", dt), ("n_accept", torch.int32), ("beta", dt)]
    c, samples, phis, rates, _ = _run_checkpointed(
        "da_", seg, {"theta": theta0, "beta": _betas(beta, theta0)}, layout, gen, n_steps=n_steps,
        n_burn=n_burn, segment=segment,
        rates={"accept": accept_rate_spec(), "inner": inner_accept_rate_spec(subchain)},
        ckpt_path=ckpt_path, resume=resume, metrics=metrics,
        log_accept=lambda res: {"outer_accept": float(torch.mean(res.accept_rate))})
    return DAResult(state=DAState(*(c[f] for f in DAState._fields)), samples=samples,
                    phi_trace=phis, accept_rate=rates["accept"], inner_accept_rate=rates["inner"],
                    beta=c["beta"], n_fine_evals=n_steps + (n_steps + segment - 1) // segment)


def _per_kept(get) -> RateSpec:
    """A post-burn level mean, accumulated as the rates are."""
    return (get, lambda kept: kept, lambda total: max(total, 1))


_PT_LEVEL_RATES = {
    "phi_mean": _per_kept(lambda r: r.phi_level_mean),
    "phi2_mean": _per_kept(lambda r: r.phi2_level_mean),
    "ss_mean": _per_kept(lambda r: r.ss_level_mean),
}


def _pt_layout(dt: torch.dtype) -> Layout:
    return [("theta", dt), ("beta", dt), ("lambdas", dt)]


def _check_even(segment: int) -> None:
    if segment % 2:
        raise ValueError(f"segment must be even for exact swap accounting, got {segment}")


def run_pt_checkpointed(
    misfit_fn: Callable,
    prior,
    theta0: torch.Tensor,
    gen: torch.Generator,
    *,
    n_steps: int,
    n_burn: int = 0,
    beta=0.25,
    n_temps: int = 4,
    lambda_min: float = 0.05,
    segment: int = 1000,
    adapt_ladder: bool = False,
    ckpt_path: str = "pt_chain_ckpt.npz",
    resume: bool = True,
    metrics: Optional[MetricsLogger] = None,
) -> PTResult:
    """Parallel-tempered pCN (``run_pt_pcn``) from (G, d) cold inits in
    segments, checkpointed after every segment, with exact resume: the
    (K, G, d) level states, the adapted per-level betas, the ladder, the
    swap and level accumulators and the generator state. segment must be
    even (exact swap accounting)."""
    _check_even(segment)

    def seg(c, this, burn, start):
        res = run_pt_pcn(misfit_fn, prior, c["theta"], gen, n_steps=this, n_burn=burn,
                         beta=c["beta"], n_temps=n_temps, lambda_min=lambda_min,
                         adapt_t0=float(start), adapt_ladder=adapt_ladder, ladder=c["lambdas"])
        return res, {"theta": res.theta, "beta": res.beta, "lambdas": res.lambdas}

    c, samples, phis, rates, _ = _run_checkpointed(
        "pt_", seg, {"theta": theta0, "beta": beta, "lambdas": None}, _pt_layout(theta0.dtype), gen,
        n_steps=n_steps, n_burn=n_burn, segment=segment,
        rates={"accept": accept_rate_spec(), "swap": swap_rate_spec(), **_PT_LEVEL_RATES},
        ckpt_path=ckpt_path, resume=resume, metrics=metrics,
        log_accept=lambda res: {"accept_cold": float(torch.mean(res.accept_rate[-1]))})
    return PTResult(samples=samples, phi_trace=phis, accept_rate=rates["accept"],
                    swap_rate=rates["swap"], beta=c["beta"], theta=c["theta"], lambdas=c["lambdas"],
                    phi_level_mean=rates["phi_mean"], phi2_level_mean=rates["phi2_mean"],
                    ss_level_mean=rates["ss_mean"])


def run_pt_da_checkpointed(
    misfit_fine: Callable,
    misfit_coarse: Callable,
    prior,
    theta0: torch.Tensor,
    gen: torch.Generator,
    *,
    n_steps: int,
    n_burn: int = 0,
    beta=0.25,
    subchain: int = 8,
    n_temps: int = 4,
    lambda_min: float = 0.05,
    segment: int = 32,
    inner: str = "pcn",
    adapt_ladder: bool = False,
    ckpt_path: str = "ptda_chain_ckpt.npz",
    resume: bool = True,
    metrics: Optional[MetricsLogger] = None,
) -> PTDAResult:
    """Tempered delayed acceptance (``run_pt_da_segmented``; n_steps count
    outer steps) checkpointed after every segment, with exact resume, as
    ``run_pt_checkpointed``. segment must be even."""
    _check_even(segment)

    def seg(c, this, burn, start):
        res = run_pt_da(misfit_fine, misfit_coarse, prior, c["theta"], gen, n_steps=this,
                        n_burn=burn, beta=c["beta"], subchain=subchain, n_temps=n_temps,
                        lambda_min=lambda_min, adapt_t0=float(start), inner=inner,
                        adapt_ladder=adapt_ladder, ladder=c["lambdas"])
        return res, {"theta": res.theta, "beta": res.beta, "lambdas": res.lambdas}

    c, samples, phis, rates, _ = _run_checkpointed(
        "ptda_", seg, {"theta": theta0, "beta": beta, "lambdas": None}, _pt_layout(theta0.dtype), gen,
        n_steps=n_steps, n_burn=n_burn, segment=segment,
        rates={"accept": accept_rate_spec(), "inner": inner_accept_rate_spec(subchain),
               "swap": swap_rate_spec(), **_PT_LEVEL_RATES},
        ckpt_path=ckpt_path, resume=resume, metrics=metrics,
        log_accept=lambda res: {"outer_accept_cold": float(torch.mean(res.accept_rate[-1]))})
    return PTDAResult(samples=samples, phi_trace=phis, accept_rate=rates["accept"],
                      inner_accept_rate=rates["inner"], swap_rate=rates["swap"], beta=c["beta"],
                      theta=c["theta"], n_fine_evals=n_steps + (n_steps + segment - 1) // segment,
                      lambdas=c["lambdas"], phi_level_mean=rates["phi_mean"],
                      phi2_level_mean=rates["phi2_mean"], ss_level_mean=rates["ss_mean"])
