"""Command-line interface of the port: the reference CLI's FOM commands
(BASELINE configs 1-3) and ``invert``, with its flags and JSON keys plus
``--device`` (default ``cuda``; ``cpu`` runs the plain kernel versions).

    python -m bayesianinferencedl_tpu_torch.cli fom --resolution 32
    python -m bayesianinferencedl_tpu_torch.cli snapshots --resolution 32 --n 256
    python -m bayesianinferencedl_tpu_torch.cli rom --resolution 32 --n-snapshots 256 --r 40

``fom`` is one differentiable plain-torch solve (``FiveParamFin.solve``);
``snapshots`` and ``rom`` solve their batches through ``make_fom_solver``:
K1, K3r or, from res22 up, K4r / K4c in float32, the plain PCG in float64. Each
prints one JSON line.

    python -m bayesianinferencedl_tpu_torch.cli invert --device cuda

builds the pipeline (every FOM solve through K1, K3r or K4r / K4c, by the mesh size)
and runs pCN on the rom_nn likelihood, then prints one JSON line with the
keys of the reference CLI's ``invert``.

    python -m bayesianinferencedl_tpu_torch.cli invert --sampler da_pcn \
        --likelihood fom --resolution 8 --noise 1e-2 --steps 500 --burn 150

runs delayed acceptance on the exact FOM likelihood (``--subchain`` rom_nn
pCN steps per batched FOM correction; steps count outer steps) and adds the
FOM iteration audit (``fom_iter_audit``, as the reference nests it) and the
outer and inner accept rates to the line; ``--sampler pcn --likelihood fom``
runs pCN on it in segments. ``--sampler pt_pcn`` (rom, rom_nn) and
``--sampler pt_da_pcn`` run ``--n-temps`` levels from ``--lambda-min``
(``--adapt-ladder`` tunes the ladder in burn-in) and add ``log_evidence``
and ``log_evidence_std``; ``--infer-noise`` integrates the noise out and
adds ``noise_sigma_post``. ``invert --data obs.npz`` inverts
the observations ``fom --save-obs`` wrote (``theta_true`` is then null);
``--dtype float64`` builds the pipeline in float64, with FOM solves at tol
1e-10 under a cap of 4,000 (the plain PCG). The Laplace-seeded samplers
(``laplace_mh``, ``gpcn``, ``mala_lap``, ``hmc_lap``), the gradient samplers
(``mala``, ``hmc``: ``--mala-step`` is the initial step size, ``--hmc-leap``
the trajectory length, 0 for ChEES) and ``pt_mala`` run as well;
``--da-inner mala`` gives the DA samplers MALA subchains, and ``--sampler
mlda_pcn --likelihood fom`` runs multilevel delayed acceptance with the FOM
at ``--mlda-resolution`` as the mid rung (``--mlda-subchain`` mid steps per
fine correction). ``--sensors design.npz`` inverts the pointwise sensors of
a ``design --out`` file instead of the subfin averages; ``--predict-at X,Y``
(repeatable) adds the posterior prediction of the temperature there and
``--predict-out f.npz`` saves the whole field's (one batched FOM solve over
256 thinned draws).

    python -m bayesianinferencedl_tpu_torch.cli design --resolution 4 --sensors 3 --out d.npz
    python -m bayesianinferencedl_tpu_torch.cli sbc --resolution 4 --datasets 32 --sbc-chains 31

``design`` places pointwise sensors by greedy expected information gain
(``infer/oed.py``); ``sbc`` calibrates a sampler by simulation-based
calibration (``api.run_sbc_check``), each with the reference's flags and
keys. ``rom --method greedy`` builds the greedy basis instead of POD.

    python -m bayesianinferencedl_tpu_torch.cli map --resolution 4 --noise 1e-3

builds the pipeline and prints the MAP (8-start BFGS on the differentiable
forward) with the Laplace approximation's standard deviations, as the
reference's ``map`` does; ``--psis K`` certifies the Laplace fit by
Pareto-smoothed importance sampling (one batched forward of K draws).

    python -m bayesianinferencedl_tpu_torch.cli eki --resolution 4 --noise 1e-2
    python -m bayesianinferencedl_tpu_torch.cli vi --resolution 4 --psis 4096
    python -m bayesianinferencedl_tpu_torch.cli svgd --resolution 4
    python -m bayesianinferencedl_tpu_torch.cli evidence --resolution 4 --likelihood fom

run the approximation layer on a fresh build: ensemble Kalman inversion,
ADVI, SVGD (``--psis K`` certifies the fit, for EKI and SVGD its
moment-matched Gaussian) and the log evidence by tempered SMC, each with
the reference's flags and JSON keys. ``invert --init eki|vi`` starts the
chains from an EKI ensemble or an ADVI fit.

    python -m bayesianinferencedl_tpu_torch.cli vi --resolution 4 --flow 6 --psis 8192 --neutra 2000

fits a normalizing flow with 6 coupling layers instead (tempered SMC
distilled by maximum likelihood; ``--flow-pretrain none`` runs annealed
reverse-KL flow-VI over ``--steps``), certifies it by PSIS through a base
widened by ``--psis-widen`` and samples the exact posterior by
flow-preconditioned pCN over ``--neutra`` steps (256 chains, half burn-in).

    python -m bayesianinferencedl_tpu_torch.cli surrogate --resolution 4 --out sur.npz

builds the pipeline and checks the corrected model's autograd gradient
against central differences (BASELINE config 4), printing the reference's
keys; ``--out`` saves (MLP params, Ahat, V) in the JAX package's npz
layout. ``pipeline`` is ``invert``. Every command that builds takes
``--prior uniform|log_uniform`` with ``--prior-low`` / ``--prior-high`` (the
box on k; samples live in the probit coordinates, the JSON reports log k)
and ``--online-precision highest|high|fast`` (the reduced solves' tier: full
fp32, bf16x3, one bf16 pass).

    python -m bayesianinferencedl_tpu_torch.cli invert --sampler pt_pcn --shard

splits the chains over every card, one process (rank) a card on
torch.distributed (``parallel/``): rank 0 builds the pipeline, every rank
loads its save onto its own card, and rank 0 alone prints and writes files.
``--shard N`` takes N ranks (with ``--device cpu``, N gloo ranks); on one
card bare ``--shard`` does nothing, as the reference's. ``invert``,
``pipeline``, ``evidence`` (one SMC island a rank), ``invert-ff`` and
``evidence-ff`` take it; a process that torchrun started joins its world.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", help="torch device; cpu runs the plain kernel versions")
    p.add_argument("--resolution", type=int, default=4)
    p.add_argument("--biot", type=float, default=0.1)
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--metrics", type=str, default=None, help="JSONL metrics path")
    p.add_argument("--seed", type=int, default=0)


def _dtype(args) -> torch.dtype:
    return torch.float64 if args.dtype == "float64" else torch.float32


def _cg_maxiter(args) -> int:
    """The reference CLI's FOM iteration cap: max(480, 120 * resolution) in
    float32 (its Jacobi-PCG needs ~85 x resolution iterations at tol 1e-7),
    4,000 in float64 (tol 1e-10)."""
    if args.dtype == "float64":
        return 4000
    return max(480, 120 * args.resolution)


def _fin(args):
    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin

    return FiveParamFin.create(
        resolution=args.resolution, biot=args.biot, dtype=_dtype(args), device=args.device,
        cg_tol=1e-10 if args.dtype == "float64" else 1e-7, cg_maxiter=_cg_maxiter(args),
    )


def _parse_points(specs):
    """["X,Y", ...] (the --predict-at values) -> (P, 2) array, or None."""
    if not specs:
        return None
    pts = []
    for s in specs:
        try:
            x, y = (float(v) for v in s.split(","))
        except ValueError:
            raise SystemExit(f"--predict-at expects 'X,Y', got {s!r}")
        pts.append((x, y))
    return np.asarray(pts)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cmd_fom(args) -> None:
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    log = MetricsLogger(args.metrics, run_config=vars(args))
    fin = _fin(args)
    dev = fin.op.device
    k = torch.tensor(args.k, dtype=_dtype(args), device=dev)
    with log.timer("solve_warmup"):
        fin.solve(k)
        _sync(dev)
    t0 = time.perf_counter()
    u = fin.solve(k)
    _sync(dev)
    log.log("solve", seconds=time.perf_counter() - t0, n_dof=fin.op.n_dof)
    y = fin.qoi(u).cpu().numpy()
    if args.save_obs:
        # observation file for `invert --data` (the noiseless forward)
        np.savez(args.save_obs, data=y, k_true=k.cpu().numpy())
        log.log("saved_obs", path=args.save_obs)
    print(json.dumps({"qoi": y.tolist(), "n_dof": fin.op.n_dof}))


def cmd_snapshots(args) -> None:
    from bayesianinferencedl_tpu_torch.api import make_fom_solver
    from bayesianinferencedl_tpu_torch.rom.snapshots import sample_log_uniform
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    log = MetricsLogger(args.metrics, run_config=vars(args))
    fin = _fin(args)
    dev = fin.op.device
    solver = make_fom_solver(fin, tol=fin.cg_tol, maxiter=fin.cg_maxiter)
    ks = sample_log_uniform(torch.Generator(device=dev).manual_seed(args.seed), args.n, dtype=_dtype(args))
    with log.timer("snapshots_warmup"):  # builds the kernel; one sample
        solver(ks[:1])
        _sync(dev)
    t0 = time.perf_counter()
    S = solver(ks)
    _sync(dev)
    dt = time.perf_counter() - t0
    log.log("snapshots", seconds=dt, solves_per_sec=args.n / dt)
    if args.out:
        np.savez_compressed(args.out, snapshots=S.cpu().numpy(), ks=ks.cpu().numpy())
    print(json.dumps({"n": args.n, "seconds": dt, "fom_solves_per_sec": args.n / dt}))


def cmd_rom(args) -> None:
    from bayesianinferencedl_tpu_torch.api import make_fom_solver
    from bayesianinferencedl_tpu_torch.rom.galerkin import ReducedOperator
    from bayesianinferencedl_tpu_torch.rom.greedy import greedy_basis, orthonormalize_host
    from bayesianinferencedl_tpu_torch.rom.pod import pod_basis_host
    from bayesianinferencedl_tpu_torch.rom.snapshots import sample_log_uniform
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    log = MetricsLogger(args.metrics, run_config=vars(args))
    fin = _fin(args)
    dev, dt = fin.op.device, _dtype(args)
    solver = make_fom_solver(fin, tol=fin.cg_tol, maxiter=fin.cg_maxiter)
    ks = sample_log_uniform(torch.Generator(device=dev).manual_seed(args.seed), args.n_snapshots, dtype=dt)
    if args.method == "greedy":
        gres = greedy_basis(fin.op, ks, args.r, solve=lambda k: solver(k[None])[0])
        V = orthonormalize_host(gres.snapshots)  # offline f64, as the POD path
    else:
        V, _ = pod_basis_host(solver(ks), args.r)
    rom = ReducedOperator.project_host(fin.host, args.biot, V, dtype=dt, device=dev)

    k_test = sample_log_uniform(torch.Generator(device=dev).manual_seed(args.seed + 1), 64, dtype=dt)
    y_fom = fin.op.observe(solver(k_test))
    y_rom = rom.forward(k_test)
    rel = float(torch.linalg.norm(y_rom - y_fom) / torch.linalg.norm(y_fom))
    log.log("rom_rel_err", value=rel, r=args.r, method=args.method)
    if args.out:
        np.savez_compressed(args.out, V=np.asarray(V))
    print(json.dumps({"r": args.r, "method": args.method, "rel_err_vs_fom": rel}))


def _pipeline_config(args, mcmc):
    """The PipelineConfig of the building commands from their flags (the
    reference's, with its ``_prior_config``)."""
    from bayesianinferencedl_tpu_torch.config import (
        FEMConfig, MeshConfig, PipelineConfig, PriorConfig, ROMConfig, SurrogateConfig,
    )

    return PipelineConfig(
        mesh=MeshConfig(resolution=args.resolution),
        fem=FEMConfig(biot=args.biot, cg_tol=1e-10 if args.dtype == "float64" else 1e-7,
                      cg_maxiter=_cg_maxiter(args) if args.cg_maxiter is None else args.cg_maxiter),
        rom=ROMConfig(
            n_snapshots=args.n_snapshots, basis_size=args.r, seed=args.seed,
            online_precision=args.online_precision,
        ),
        surrogate=SurrogateConfig(n_train=args.n_train, epochs=args.epochs, seed=args.seed),
        mcmc=mcmc,
        prior=PriorConfig(mean=args.prior_mean, sigma=args.prior_sigma, dim=5, kind=args.prior,
                          low=args.prior_low, high=args.prior_high),
    )


def cmd_surrogate(args) -> None:
    """BASELINE config 4: the build, then the corrected model's autograd
    gradient of 0.5 ||G~(theta) - G~(0)||^2 at theta = 0.1 against central
    differences (eps 1e-3 in float32, 1e-6 in float64)."""
    from bayesianinferencedl_tpu_torch.api import build_pipeline
    from bayesianinferencedl_tpu_torch.config import MCMCConfig
    from bayesianinferencedl_tpu_torch.utils.checkpoint import save_checkpoint
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    log = MetricsLogger(args.metrics)
    cfg = _pipeline_config(args, MCMCConfig())
    dt = _dtype(args)
    pipe = build_pipeline(cfg, device=args.device, dtype=dt, metrics=log)
    corrected = lambda t: pipe.corrected(t[None], differentiable=True)[0]
    theta0 = torch.zeros(5, dtype=dt, device=pipe.device)
    with torch.no_grad():
        d = corrected(theta0)
    f = lambda t: 0.5 * torch.sum((corrected(t) - d) ** 2)
    t = (theta0 + 0.1).requires_grad_(True)
    (g,) = torch.autograd.grad(f(t), t)
    eps = 1e-3 if args.dtype == "float32" else 1e-6
    fd = []
    with torch.no_grad():
        for i in range(5):
            e = torch.zeros(5, dtype=dt, device=pipe.device)
            e[i] = eps
            fd.append((float(f(theta0 + 0.1 + e)) - float(f(theta0 + 0.1 - e))) / (2 * eps))
    fd = torch.tensor(fd, dtype=dt, device=pipe.device)
    gd_err = float(torch.max(torch.abs(g - fd) / (torch.abs(g) + 1e-8)))
    log.log("gradcheck", rel_err=gd_err)
    if args.out:
        # the reference's (params, Ahat, V) tuple, its leaves in that order
        save_checkpoint(args.out, [a for W, b in pipe.surrogate.params for a in (W, b)]
                        + [pipe.rom.Ahat, pipe.rom.V], meta=cfg.to_dict())
    s = log.summary()
    print(json.dumps({
        "rom_rel_err": s["rom_rel_err"]["value"],
        "corrected_rel_err": s["corrected_rel_err"]["value"],
        "gradcheck_rel_err": gd_err,
    }))


def _sensor_fin(args, cfg, log):
    """``invert --sensors``: the fin whose observables are the saved
    design's pointwise sensors (``infer.oed.with_sensor_qoi``)."""
    from bayesianinferencedl_tpu_torch.infer.oed import with_sensor_qoi
    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin

    dz = np.load(args.sensors)
    if int(dz["resolution"]) != args.resolution:
        raise SystemExit(f"--sensors design was made at resolution {int(dz['resolution'])}, "
                         f"but --resolution is {args.resolution}")
    fin = FiveParamFin.create(resolution=args.resolution, biot=args.biot, dtype=_dtype(args),
                              device=args.device, cg_tol=cfg.fem.cg_tol, cg_maxiter=cfg.fem.cg_maxiter)
    log.log("sensor_design", path=args.sensors, n_obs=int(dz["node_ids"].shape[0]))
    return with_sensor_qoi(fin, dz["node_ids"])


def cmd_invert(args) -> None:
    from bayesianinferencedl_tpu_torch.config import MCMCConfig
    from bayesianinferencedl_tpu_torch.api import build_pipeline, run_inversion
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    log = MetricsLogger(args.metrics)
    cfg = _pipeline_config(args, MCMCConfig(
            n_chains=args.chains, n_steps=args.steps, n_burn=args.burn, beta=args.beta,
            noise_sigma=args.noise, likelihood=args.likelihood, sampler=args.sampler,
            seed=args.seed, n_temps=args.n_temps, lambda_min=args.lambda_min,
            adapt_ladder=args.adapt_ladder, subchain=args.subchain, da_coarse=args.da_coarse,
            da_inner=args.da_inner, mlda_resolution=args.mlda_resolution,
            mlda_subchain=args.mlda_subchain, infer_noise=args.infer_noise, hmc_leap=args.hmc_leap,
            mala_step=args.mala_step,
        ))
    fin = _sensor_fin(args, cfg, log) if args.sensors else None
    pipe = _shared_pipeline(args, lambda: build_pipeline(cfg, device=args.device, dtype=_dtype(args),
                                                         metrics=log, fin=fin), fin)
    obs = None
    if args.data:
        obs = torch.as_tensor(np.load(args.data)["data"])
        log.log("external_data", path=args.data, n_obs=int(obs.shape[0]))
    inv = run_inversion(pipe, init=args.init, data=obs, metrics=log, mesh=getattr(args, "mesh", None))
    post_mean = pipe.prior.to_theta(inv.result.samples).mean(dim=(0, 1))
    out = {
        "likelihood": args.likelihood,
        "sampler": args.sampler,
        "prior": args.prior,
        "samples_per_sec": inv.samples_per_sec,
        "ess_min": float(torch.min(inv.ess)),
        "ess_tail_min": float(torch.min(inv.ess_tail)),
        "ess_per_sec": inv.ess_per_sec,
        "accept_rate": float(torch.mean(inv.result.accept_rate)),
        "rhat_split_max": float(torch.max(inv.rhat)),
        "posterior_mean_log_k": post_mean.cpu().tolist(),
        # external data: the truth is unknown
        "theta_true": None if obs is not None else pipe.prior.to_theta(inv.theta_true).cpu().tolist(),
    }
    if inv.ppc is not None:
        out["ppc_p_value"] = inv.ppc["p_value"]
    if args.sampler in ("da_pcn", "pt_da_pcn"):
        out["outer_accept"] = out["accept_rate"]
        out["inner_accept"] = float(torch.mean(inv.result.inner_accept_rate))
    if inv.fom_iter_cap is not None:
        out["fom_iter_audit"] = {"cap": inv.fom_iter_cap, "max_iters": inv.fom_iter_max,
                                 "hit_cap_frac": inv.fom_hit_cap_frac}
    if inv.log_evidence is not None:
        # stepping-stone over the ladder; differences across --likelihood runs
        # on the same data and seed are log Bayes factors
        out["log_evidence"] = inv.log_evidence
        out["log_evidence_std"] = inv.log_evidence_std
    if inv.noise_sigma_post is not None:
        out["noise_sigma_post"] = inv.noise_sigma_post
    if args.predict_at or args.predict_out:
        from bayesianinferencedl_tpu_torch.api import predict_temperature

        # the aleatoric part of a new reading: the configured noise, or the
        # posterior median sigma when the noise was inferred
        sig = args.noise if inv.noise_sigma_post is None else inv.noise_sigma_post["sigma_q50"]
        pred = predict_temperature(pipe, inv.result.samples, points=_parse_points(args.predict_at),
                                   noise_sigma=sig)
        if args.predict_at:
            out["predictions"] = pred.summary_rows()
        if args.predict_out:
            pred.save_npz(args.predict_out)
            out["prediction_field"] = args.predict_out
        log.log("predict", n_draws=pred.n_draws, points=len(pred.summary_rows()))
    print(json.dumps(out))


def cmd_pipeline(args) -> None:
    cmd_invert(args)


def cmd_map(args) -> None:
    """Deterministic inversion: the MAP point and the Laplace approximation's
    standard deviations (the reference's ``map``)."""
    from bayesianinferencedl_tpu_torch.api import _child, build_pipeline
    from bayesianinferencedl_tpu_torch.config import MCMCConfig
    from bayesianinferencedl_tpu_torch.infer.map import find_map_multistart, laplace_approximation
    from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit, marginal_misfit
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    if args.psis and args.infer_noise:
        raise SystemExit(
            "--psis with --infer-noise is unsupported: the sigma-marginal "
            "potential needs its own importance target"
        )
    log = MetricsLogger(args.metrics)
    pipe = build_pipeline(_pipeline_config(args, MCMCConfig(noise_sigma=args.noise)),
                          device=args.device, dtype=_dtype(args), metrics=log)
    dev, dt = pipe.device, _dtype(args)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    # working coordinates: log k under the gaussian prior (to_theta is the
    # identity), z under a box prior; the forward composes to_theta, as in
    # run_inversion
    x_true = pipe.prior.sample(gen)
    data = pipe.fin.forward(torch.exp(pipe.prior.to_theta(x_true)))
    data = data + args.noise * torch.randn(data.shape, generator=gen, dtype=dt, device=dev)
    fwd = pipe.working_forward_fn(args.likelihood, differentiable=True)
    b0 = float(args.noise) ** 2
    if args.infer_noise:  # the MAP of the sigma-marginal potential
        misfit = marginal_misfit(fwd, data, a0=2.0, b0=b0)
    else:
        misfit = gaussian_misfit(fwd, data, args.noise)
    x_map, nlp = find_map_multistart(misfit, pipe.prior, _child(gen), n_starts=8)
    sig_lap = args.noise
    if args.infer_noise:  # Laplace at the plug-in conditional-mode scale (run_inversion's rule)
        with torch.no_grad():
            r_map = fwd(x_map[None])[0] - data
        sig_lap = float(np.sqrt((b0 + 0.5 * float(torch.sum(r_map * r_map)))
                                / (2.0 + 0.5 * r_map.shape[-1])))
    lap = laplace_approximation(fwd, data, sig_lap, pipe.prior, x_map)
    theta_map = pipe.prior.to_theta(x_map).detach().cpu().numpy()
    rec = {
        "theta_map": theta_map.tolist(),
        "theta_true": pipe.prior.to_theta(x_true).cpu().numpy().tolist(),
        "laplace_sd_working": np.sqrt(np.diag(lap.cov.cpu().numpy())).tolist(),
        "k_map": np.exp(theta_map).tolist(),
        "nlp": float(nlp),
        "prior": args.prior,
        **({"noise_sigma_plugin": sig_lap} if args.infer_noise else {}),
    }
    if args.psis:
        # certify the Laplace fit: does the local quadratic cover the posterior?
        from bayesianinferencedl_tpu_torch.api import psis_certify

        cert = psis_certify(pipe, lap.mean, lap.chol, data, args.likelihood, n_draws=args.psis,
                            generator=torch.Generator(device=dev).manual_seed(args.seed + 2),
                            metrics=log)
        rec["psis"] = _psis_record(args.psis, cert)
    print(json.dumps(rec))


def _psis_record(n_draws: int, cert, corrected_mean=None) -> dict:
    """The ``psis`` block of the reference's JSON lines: the corrected mean
    in working coordinates and the evidence, or (``vi``) the corrected mean
    of log k."""
    rec = {"n_draws": n_draws, "k_hat": round(cert.k_hat, 3), "reliable": cert.reliable,
           "ess": round(cert.ess, 1)}
    if corrected_mean is not None:
        rec["corrected_mean_log_k"] = corrected_mean
    else:
        rec["corrected_mean_working"] = cert.mean.tolist()
        rec["log_evidence"] = round(cert.log_evidence, 4)
    return rec


def _build_for(args):
    """The pipeline of an approximation command (its flags: the noise, the
    likelihood and the seed fill MCMCConfig), the metrics logger and the
    external data, if any."""
    from bayesianinferencedl_tpu_torch.api import build_pipeline
    from bayesianinferencedl_tpu_torch.config import MCMCConfig
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    log = MetricsLogger(args.metrics, run_config=vars(args))
    mcmc = MCMCConfig(noise_sigma=args.noise, likelihood=args.likelihood, seed=args.seed)
    pipe = _shared_pipeline(args, lambda: build_pipeline(
        _pipeline_config(args, mcmc), device=args.device, dtype=_dtype(args), metrics=log))
    obs = None
    if getattr(args, "data", None):
        obs = torch.as_tensor(np.load(args.data)["data"])
    return pipe, log, obs


def _moment_psis(args, pipe, ens: torch.Tensor, data) -> dict:
    """eki / svgd --psis: certify the ensemble's moment-matched Gaussian."""
    from bayesianinferencedl_tpu_torch.api import psis_certify

    e = ens.double().cpu().numpy()
    cov = np.cov(e.T) + 1e-12 * np.eye(e.shape[1])
    dt, dev = pipe.prior.mean.dtype, pipe.device
    cert = psis_certify(
        pipe, torch.tensor(e.mean(axis=0), dtype=dt, device=dev),
        torch.tensor(np.linalg.cholesky(cov), dtype=dt, device=dev), data, args.likelihood,
        n_draws=args.psis, generator=torch.Generator(device=dev).manual_seed(args.seed + 2),
    )
    return _psis_record(args.psis, cert)


def _summary(pipe, draws: torch.Tensor, theta_true, wall: float) -> dict:
    """The keys every approximation command prints: the posterior mean and
    sd of log k over the draws, the truth and the mean absolute error."""
    th = pipe.prior.to_theta(draws)
    mean = th.mean(dim=0).double().cpu().numpy()
    truth = pipe.prior.to_theta(theta_true).double().cpu().numpy()
    return {
        "wall_seconds": round(wall, 3),
        "posterior_mean_log_k": mean.tolist(),
        "posterior_std_log_k": th.std(dim=0, correction=0).double().cpu().numpy().tolist(),
        "theta_true": truth.tolist(),
        "mean_abs_err": round(float(np.abs(mean - truth).mean()), 5),
    }


def cmd_eki(args) -> None:
    """Derivative-free ensemble Kalman inversion (api.run_eki_inversion): a
    posterior approximation in ~10-20 batched forwards, exact in the
    linear-Gaussian limit."""
    from bayesianinferencedl_tpu_torch.api import run_eki_inversion

    pipe, log, obs = _build_for(args)
    res, theta_true, data, wall = run_eki_inversion(
        pipe, args.likelihood, n_ensemble=args.ensemble, ess_target=args.ess_target, data=obs,
        generator=torch.Generator(device=pipe.device).manual_seed(args.seed), metrics=log,
    )
    rec = {"likelihood": args.likelihood, "n_ensemble": args.ensemble, "n_iters": len(res.ts) - 1,
           "n_forward_evals": res.n_forward, **_summary(pipe, res.ensemble, theta_true, wall),
           "misfit_trace": [round(x, 2) for x in res.misfit_trace],
           "tempering_knots": [round(t, 5) for t in res.ts]}
    if args.psis:
        rec["psis"] = _moment_psis(args, pipe, res.ensemble, data)
    print(json.dumps(rec))


def _cmd_vi_flow(args, pipe, obs, log) -> None:
    """``vi --flow N``: the normalizing flow (api.run_flow_vi_inversion).
    --flow-pretrain smc distills a tempered-SMC population by maximum
    likelihood (--steps and --lr unused: no refinement); none runs annealed
    reverse-KL flow-VI over --steps at --lr. --psis certifies the flow
    through a base widened by --psis-widen; --neutra runs NeuTra pCN on 256
    chains with half the steps burn-in."""
    from bayesianinferencedl_tpu_torch.api import (
        psis_certify_flow, run_flow_vi_inversion, run_neutra_inversion,
    )
    from bayesianinferencedl_tpu_torch.infer.flow import flow_sample

    dev = pipe.device
    gen = lambda k: torch.Generator(device=dev).manual_seed(args.seed + k)
    res, theta_true, data, wall = run_flow_vi_inversion(
        pipe, args.likelihood, n_couplings=args.flow, pretrain=args.flow_pretrain,
        n_steps=args.steps if args.flow_pretrain == "none" else None, n_mc=args.mc, lr=args.lr,
        data=obs, generator=gen(0), metrics=log,
    )
    rec = {"likelihood": args.likelihood,
           "family": f"flow (couplings={args.flow}, pretrain={args.flow_pretrain})",
           "n_forward_evals": res.n_forward,
           **_summary(pipe, flow_sample(res, gen(1), (4096,)), theta_true, wall)}
    if args.psis:
        cert = psis_certify_flow(pipe, res, data, args.likelihood, n_draws=args.psis,
                                 base_scale=args.psis_widen, generator=gen(2), metrics=log)
        w = np.exp(cert.log_weights - cert.log_weights.max())
        w /= w.sum()
        th = pipe.prior.to_theta(cert.samples).double().cpu().numpy()
        rec["psis"] = {"n_draws": args.psis, "base_scale": args.psis_widen,
                       **_psis_record(args.psis, cert, corrected_mean=(w @ th).tolist())}
    if args.neutra:
        inv = run_neutra_inversion(pipe, res, data, args.likelihood, theta_true=theta_true, n_chains=256,
                                   n_steps=args.neutra, n_burn=args.neutra // 2, generator=gen(3),
                                   metrics=log)
        s = inv.result.samples
        rec["neutra"] = {
            "n_steps": args.neutra,
            "rhat_split_max": round(float(torch.max(inv.rhat)), 4),
            "ess_bulk_min": round(float(torch.min(inv.ess)), 1),
            "accept_rate": round(float(torch.mean(inv.result.accept_rate)), 3),
            "posterior_mean_log_k": pipe.prior.to_theta(s.reshape(-1, s.shape[-1])).mean(dim=0)
            .double().cpu().numpy().tolist(),
            "wall_seconds": round(inv.wall_seconds, 3),
        }
    print(json.dumps(rec))


def cmd_vi(args) -> None:
    """Gradient-based variational approximation (api.run_vi_inversion,
    ADVI): q = N(mu, L L^T) by stochastic ELBO ascent, exact where the
    posterior is Gaussian in the whitened frame; with --flow N a
    normalizing flow instead (_cmd_vi_flow). Without --flow, --neutra and
    --psis-widen are ignored, as in the reference."""
    from bayesianinferencedl_tpu_torch.api import psis_certify, run_vi_inversion
    from bayesianinferencedl_tpu_torch.infer.vi import vi_sample

    pipe, log, obs = _build_for(args)
    if args.flow > 0:
        _cmd_vi_flow(args, pipe, obs, log)
        return
    dev = pipe.device
    res, theta_true, data, wall = run_vi_inversion(
        pipe, args.likelihood, rank=args.rank, n_steps=args.steps, n_mc=args.mc, lr=args.lr,
        data=obs, generator=torch.Generator(device=dev).manual_seed(args.seed), metrics=log,
    )
    draws = vi_sample(res, torch.Generator(device=dev).manual_seed(args.seed + 1), (4096,))
    elbo = res.elbo_trace.double().cpu().numpy()
    rec = {"likelihood": args.likelihood, "rank": args.rank, "n_steps": args.steps, "n_mc": args.mc,
           "n_forward_evals": res.n_forward, **_summary(pipe, draws, theta_true, wall),
           "elbo_first_last": [round(float(elbo[:50].mean()), 2), round(float(elbo[-50:].mean()), 2)]}
    if args.psis:
        cert = psis_certify(pipe, res.theta_mean, res.theta_chol, data, args.likelihood,
                            n_draws=args.psis,
                            generator=torch.Generator(device=dev).manual_seed(args.seed + 2),
                            metrics=log)
        # the importance-weighted mean of log k: the draws pushed through to_theta
        w = np.exp(cert.log_weights - cert.log_weights.max())
        w /= w.sum()
        th = pipe.prior.to_theta(cert.samples).double().cpu().numpy()
        rec["psis"] = _psis_record(args.psis, cert, corrected_mean=(w @ th).tolist())
    print(json.dumps(rec))


def cmd_svgd(args) -> None:
    """Particle-transport approximation (api.run_svgd_inversion, SVGD):
    gradient-based and nonparametric, biased at finite J."""
    from bayesianinferencedl_tpu_torch.api import run_svgd_inversion

    pipe, log, obs = _build_for(args)
    res, theta_true, data, wall = run_svgd_inversion(
        pipe, args.likelihood, n_particles=args.particles, n_steps=args.steps, lr=args.lr,
        anneal_steps=args.anneal if args.anneal >= 0 else None, data=obs,
        generator=torch.Generator(device=pipe.device).manual_seed(args.seed),
        segment=args.segment or None, metrics=log,
    )
    tr = res.misfit_trace.double().cpu().numpy()
    rec = {"likelihood": args.likelihood, "n_particles": args.particles, "n_steps": args.steps,
           "n_forward_evals": res.n_forward, **_summary(pipe, res.particles, theta_true, wall),
           "misfit_first_last": [round(float(tr[0]), 2), round(float(tr[-1]), 2)]}
    if args.psis:
        # SVGD fits no density: certify the terminal ensemble's moment-matched Gaussian
        rec["psis"] = _moment_psis(args, pipe, res.particles, data)
    print(json.dumps(rec))


def cmd_evidence(args) -> None:
    """The model evidence by adaptive tempered SMC (api.run_smc_evidence):
    run once per --likelihood on the same --seed and difference the
    outputs for log Bayes factors."""
    from bayesianinferencedl_tpu_torch.api import run_smc_evidence

    pipe, log, _ = _build_for(args)
    ev = run_smc_evidence(pipe, n_particles=args.particles, n_groups=args.groups,
                          n_mutations=args.mutations, ess_target=args.ess_target,
                          mesh=getattr(args, "mesh", None), metrics=log)
    print(json.dumps({
        "likelihood": args.likelihood,
        "estimator": "smc (adaptive tempered, unbiased in Z)",
        "log_evidence": ev.log_evidence,
        "log_evidence_std": ev.log_evidence_std,
        "n_stages": ev.n_stages.cpu().tolist(),
        "n_particles": args.particles,
        "posterior_mean_log_k": pipe.prior.to_theta(ev.particles).mean(dim=0).cpu().tolist(),
        "theta_true": pipe.prior.to_theta(ev.theta_true).cpu().tolist(),
        "wall_seconds": ev.wall_seconds,
    }))


def cmd_sbc(args) -> None:
    """Simulation-based calibration of a sampler and likelihood on a fresh
    build (api.run_sbc_check): rank uniformity catches a wrong posterior (a
    mis-scaled noise, a biased surrogate, a broken proposal), which R-hat
    cannot."""
    from bayesianinferencedl_tpu_torch.api import build_pipeline, run_sbc_check
    from bayesianinferencedl_tpu_torch.config import MCMCConfig
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    log = MetricsLogger(args.metrics)
    mcmc = MCMCConfig(noise_sigma=args.noise, likelihood=args.likelihood, seed=args.seed)
    pipe = build_pipeline(_pipeline_config(args, mcmc), device=args.device, dtype=_dtype(args),
                          metrics=log)
    res = run_sbc_check(
        pipe, args.likelihood, n_datasets=args.datasets, n_chains=args.sbc_chains,
        n_steps=args.steps, n_burn=args.burn, n_bins=args.bins, sampler=args.sampler,
        step=args.mala_step, n_leap=args.hmc_leap, n_temps=args.temps, lambda_min=args.lambda_min,
        seed=args.seed, metrics=log,
    )
    p = res.p_values.cpu().numpy()
    print(json.dumps({
        "likelihood": args.likelihood,
        "sampler": args.sampler,
        "prior": args.prior,
        "noise_sigma": args.noise,
        "n_datasets": args.datasets,
        "n_posterior_draws": res.n_draws,
        "p_values": [round(float(v), 5) for v in p],
        "p_min": round(float(p.min()), 5),
        "calibrated": bool(p.min() > 0.005),
        "rank_counts": res.counts.cpu().numpy().tolist(),
        "accept_rate": round(float(res.accept_rate.mean()), 4),
    }))


_SHARD_HELP = ("split the chains (evidence: one SMC island a rank) over N ranks, one process a "
               "card, rank 0 alone printing and writing files; bare --shard takes every card and "
               "does nothing on one, as the reference; with --device cpu, N gloo ranks")


def _add_shard(p: argparse.ArgumentParser) -> None:
    p.add_argument("--shard", nargs="?", type=int, const=0, default=None, metavar="N",
                   help=_SHARD_HELP)


def _n_ranks(args) -> int:
    """The world --shard asks for: N, or bare every card (1 on the CPU)."""
    if getattr(args, "shard", None) is None:
        return 1
    if args.shard > 0:
        return args.shard
    return torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1


def _rank_main(mesh, argv: list) -> None:
    """One rank of a --shard run: the command on the rank's card with the
    mesh; every rank but 0 runs silent, with no metrics or output files."""
    from bayesianinferencedl_tpu_torch.parallel.mesh import rank_of

    args = _parser().parse_args(argv)
    args.mesh = mesh
    if torch.device(args.device).type == "cuda":
        args.device = f"cuda:{torch.cuda.current_device()}"
    if rank_of(mesh) == 0:
        args.fn(args)
        return
    for k in ("metrics", "out", "predict_out"):
        if hasattr(args, k):
            setattr(args, k, None)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        args.fn(args)


def _shared_pipeline(args, build, fin=None):
    """build()'s pipeline, the same bits on every rank of a --shard run:
    rank 0 builds and saves it, then every rank loads the file onto its own
    card (``Pipeline.save`` / ``Pipeline.load``), with ``fin`` (a sensor
    design's, made on each rank) in place of the config's. Without a mesh,
    build()."""
    mesh = getattr(args, "mesh", None)
    if mesh is None:
        return build()
    import shutil
    import tempfile

    import torch.distributed as dist

    from bayesianinferencedl_tpu_torch.api import Pipeline
    from bayesianinferencedl_tpu_torch.parallel.mesh import rank_of

    g = mesh.get_group()
    box = [tempfile.mkdtemp(prefix="bidl_pipe_") if rank_of(mesh) == 0 else None]
    dist.broadcast_object_list(box, src=dist.get_global_rank(g, 0), group=g)
    path = os.path.join(box[0], "pipeline.npz")
    if rank_of(mesh) == 0:
        build().save(path)
    dist.barrier(group=g)
    pipe = Pipeline.load(path, device=args.device, dtype=_dtype(args))
    dist.barrier(group=g)
    if rank_of(mesh) == 0:
        shutil.rmtree(box[0])
    return pipe if fin is None else dataclasses.replace(pipe, fin=fin)


def _build_ff(args, log):
    from bayesianinferencedl_tpu_torch.api_full_field import build_full_field_pipeline

    return build_full_field_pipeline(
        resolution=args.resolution, biot=args.biot, dtype=_dtype(args), ell=args.ell,
        sigma=args.sigma, n_features=args.n_features, n_snapshots=args.n_snapshots,
        basis_size=args.r, k_basis_size=args.k_basis, basis=args.basis, n_train=args.n_train,
        surrogate_steps=args.epochs * 10, seed=args.seed, metrics=log, device=args.device,
    )


def _load_obs(args, log=None):
    if not getattr(args, "data", None):
        return None
    obs = torch.as_tensor(np.load(args.data)["data"])
    if log is not None:
        log.log("external_data", path=args.data, n_obs=int(obs.shape[-1]))
    return obs


def cmd_invert_ff(args) -> None:
    """Full-field (nodal conductivity) inversion in RFF coefficient space
    (api_full_field): the build, the sampler, the data-space fit of the
    posterior mean against the prior mean's, and the PPC."""
    from bayesianinferencedl_tpu_torch.api_full_field import (
        predict_temperature_ff,
        run_full_field_inversion,
    )
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger
    from bayesianinferencedl_tpu_torch.utils.ppc import noise_posterior, ppc_chi2_pvalue, ppc_shape_pvalue

    log = MetricsLogger(args.metrics, run_config=vars(args))
    pipe = _build_ff(args, log)
    obs = _load_obs(args, log)
    dev = pipe.device
    res, z_true, data, ess, r, wall = run_full_field_inversion(
        pipe, likelihood=args.likelihood, sampler=args.sampler, data=obs, n_chains=args.chains,
        n_steps=args.steps, n_burn=args.burn, beta=args.beta, noise_sigma=args.noise,
        n_temps=args.n_temps, lambda_min=args.lambda_min, subchain=args.subchain,
        da_inner=args.da_inner, adapt_ladder=args.adapt_ladder,
        mlda_resolution=args.mlda_resolution, mlda_subchain=args.mlda_subchain,
        hmc_leap=args.hmc_leap, mala_step=args.mala_step, lis_points=args.lis_points,
        lis_rank=args.lis_rank, lis_tol=args.lis_tol, infer_noise=args.infer_noise,
        generator=torch.Generator(device=dev).manual_seed(args.seed),
        mesh=getattr(args, "mesh", None), metrics=log,
    )
    z_post = res.samples.mean(dim=(0, 1))
    fwd = pipe.forward_fn(args.likelihood)
    fit_post = float(torch.linalg.norm(fwd(z_post) - data))
    fit_prior = float(torch.linalg.norm(fwd(torch.zeros_like(z_post)) - data))
    ppc = sigma_post = None
    if res.samples.shape[0]:
        fwd_b = pipe.batched_forward_fn(args.likelihood)
        g = lambda k: torch.Generator(device=dev).manual_seed(args.seed + k)
        if args.infer_noise:
            # an unknown noise: the scale-free shape PPC and the conjugate sigma posterior
            ppc = ppc_shape_pvalue(fwd_b, res.samples, data, g(101))
            _, sigma_post = noise_posterior(fwd_b, res.samples, data, g(102), a0=2.0,
                                            b0=float(args.noise) ** 2)
        else:
            ppc = ppc_chi2_pvalue(fwd_b, res.samples, data, args.noise, g(101))
    # with n_obs << n_features the field is identified in a few data
    # directions only: the data-space fit is the recovery metric
    out = {
        "likelihood": args.likelihood,
        "sampler": args.sampler,
        "n_features": args.n_features,
        "samples_per_sec": res.samples.shape[0] * res.samples.shape[1] / wall,
        "ess_min": float(torch.min(ess)),
        "accept_rate": float(torch.mean(res.accept_rate)),
        "rhat_split_max": float(torch.max(r)),
        "data_misfit_posterior_mean": fit_post,
        "data_misfit_prior_mean": fit_prior,
        "ppc_p_value": ppc["p_value"] if ppc else None,
        **({"noise_sigma_post": sigma_post} if sigma_post is not None else {}),
    }
    if args.predict_at or args.predict_out:
        sig = args.noise if sigma_post is None else sigma_post["sigma_q50"]
        pred = predict_temperature_ff(pipe, res.samples, points=_parse_points(args.predict_at),
                                      noise_sigma=sig)
        if args.predict_at:
            out["predictions"] = pred.summary_rows()
        if args.predict_out:
            pred.save_npz(args.predict_out)
            out["prediction_field"] = args.predict_out
        log.log("predict", n_draws=pred.n_draws, points=len(pred.summary_rows()))
    print(json.dumps(out))


def cmd_sbc_ff(args) -> None:
    """Simulation-based calibration of the full-field sampler stack
    (api_full_field.run_sbc_check_ff): J synthetic M-dimensional
    inversions, rank uniformity per coefficient, the minimum p-value gated
    on the Sidak threshold 1 - (1 - alpha)^(1/M)."""
    from bayesianinferencedl_tpu_torch.api_full_field import run_sbc_check_ff
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    log = MetricsLogger(args.metrics, run_config=vars(args))
    pipe = _build_ff(args, log)
    res = run_sbc_check_ff(
        pipe, args.likelihood, noise_sigma=args.noise, n_datasets=args.datasets,
        n_chains=args.sbc_chains, n_steps=args.steps, n_burn=args.burn, n_bins=args.bins,
        sampler=args.sampler, step=args.mala_step, n_leap=args.hmc_leap, n_temps=args.temps,
        lambda_min=args.lambda_min, seed=args.seed, metrics=log,
    )
    p = res.p_values.double().cpu().numpy()
    d = p.shape[0]
    sidak = 1.0 - (1.0 - 0.01) ** (1.0 / d)
    p_min = float(p.min())
    print(json.dumps({
        "likelihood": args.likelihood,
        "sampler": args.sampler,
        "noise_sigma": args.noise,
        "n_features": d,
        "n_datasets": args.datasets,
        "n_posterior_draws": res.n_draws,
        "p_min": round(p_min, 6),
        "sidak_threshold_alpha01": round(sidak, 6),
        "n_below_sidak": int((p < sidak).sum()),
        "calibrated": bool(p_min > sidak),
        "accept_rate": round(float(res.accept_rate.double().mean()), 4),
    }))


def cmd_evidence_ff(args) -> None:
    """The log evidence of the full-field model by adaptive tempered SMC:
    run once per --likelihood on the same --seed and difference."""
    from bayesianinferencedl_tpu_torch.api_full_field import run_full_field_evidence
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    log = MetricsLogger(args.metrics, run_config=vars(args))
    pipe = _build_ff(args, log)
    ev = run_full_field_evidence(
        pipe, likelihood=args.likelihood, noise_sigma=args.noise, n_particles=args.particles,
        n_groups=args.groups, n_mutations=args.mutations, ess_target=args.ess_target,
        data=_load_obs(args), generator=torch.Generator(device=pipe.device).manual_seed(args.seed),
        mesh=getattr(args, "mesh", None), metrics=log,
    )
    print(json.dumps({
        "likelihood": args.likelihood,
        "n_features": args.n_features,
        "estimator": "smc (adaptive tempered, unbiased in Z)",
        "log_evidence": ev.log_evidence,
        "log_evidence_std": ev.log_evidence_std,
        "n_stages": ev.n_stages.cpu().tolist(),
        "n_particles": args.particles,
        "wall_seconds": ev.wall_seconds,
    }))


def cmd_select_ell(args) -> None:
    """The full-field prior's correlation length by model evidence
    (api_full_field.select_correlation_length): exact-FOM SMC Bayes factors
    on the same observations, pooled over --n-datasets experiments."""
    from bayesianinferencedl_tpu_torch.api_full_field import select_correlation_length
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    log = MetricsLogger(args.metrics, run_config=vars(args))
    obs = _load_obs(args)
    out = select_correlation_length(
        args.ells, resolution=args.resolution, biot=args.biot, dtype=_dtype(args),
        sigma=args.sigma, n_features=args.n_features, noise_sigma=args.noise,
        ell_true=args.ell_true, data=obs, n_datasets=args.n_datasets,
        n_particles=args.particles, n_groups=args.groups, n_mutations=args.mutations,
        max_stages=args.max_stages, cg_maxiter=_cg_maxiter(args), seed=args.seed, metrics=log,
        device=args.device,
    )
    rec = {k: out[k] for k in ("ells", "log_z", "log_z_std", "posterior", "ell_map")}
    rec["n_datasets"] = args.n_datasets if obs is None else int(out["data"].shape[0])
    print(json.dumps(rec))


def _add_ff_build(p: argparse.ArgumentParser) -> None:
    """The full-field build's flags (the reference's, with its defaults)."""
    _add_common(p)
    p.add_argument("--n-snapshots", type=int, default=256)
    p.add_argument("--r", type=int, default=40)
    p.add_argument("--k-basis", type=int, default=40)
    p.add_argument("--basis", choices=["pod", "greedy"], default="pod",
                   help="state basis: POD, or residual-indicator greedy selection over the snapshots")
    p.add_argument("--n-features", type=int, default=64)
    p.add_argument("--ell", type=float, default=1.0)
    p.add_argument("--sigma", type=float, default=0.5)
    p.add_argument("--n-train", type=int, default=1024)
    p.add_argument("--epochs", type=int, default=300, help="surrogate steps / 10")


def cmd_design(args) -> None:
    """Optimal sensor placement (infer/oed.py): greedy expected-information-
    gain selection of pointwise temperature sensors among the exterior
    boundary nodes, before any data; ``--out`` saves it for ``invert
    --sensors``."""
    from bayesianinferencedl_tpu_torch.api import make_prior
    from bayesianinferencedl_tpu_torch.config import PriorConfig
    from bayesianinferencedl_tpu_torch.infer.oed import design_sensors
    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    log = MetricsLogger(args.metrics)
    dt = _dtype(args)
    tol = 1e-11 if args.dtype == "float64" else 1e-7
    fin = FiveParamFin.create(resolution=args.resolution, biot=args.biot, dtype=dt, device=args.device,
                              cg_tol=tol)
    prior = make_prior(PriorConfig(mean=args.prior_mean, sigma=args.prior_sigma, dim=5, kind=args.prior,
                                   low=args.prior_low, high=args.prior_high), dt, fin.op.device)
    with log.timer("design"):
        design = design_sensors(fin, prior, n_sensors=args.sensors, noise_sigma=args.noise,
                                n_draws=args.draws,
                                gen=torch.Generator(device=fin.op.device).manual_seed(args.seed), tol=tol)
    log.log("design", n_candidates=int(design.candidates.shape[0]))
    if args.out:
        np.savez(args.out, node_ids=design.node_ids, xy=design.xy, eig_trace=design.eig_trace,
                 gains=design.gains, noise_sigma=args.noise, resolution=args.resolution)
        log.log("saved_design", path=args.out)
    print(json.dumps({
        "n_sensors": args.sensors,
        "node_ids": design.node_ids.tolist(),
        "xy": [[round(float(a), 6) for a in row] for row in design.xy],
        "eig_trace_nats": [round(float(v), 4) for v in design.eig_trace],
        "gains_nats": [round(float(v), 4) for v in design.gains],
        "n_candidates": int(design.candidates.shape[0]),
        "prior": args.prior,
    }))


def _add_prior(p: argparse.ArgumentParser) -> None:
    """The prior families: log-normal k (gaussian on log k), or uniform /
    log-uniform k on a box (the probit push-forward)."""
    p.add_argument("--prior", choices=["gaussian", "uniform", "log_uniform"], default="gaussian")
    p.add_argument("--prior-low", type=float, default=0.1, help="box prior lower bound on k")
    p.add_argument("--prior-high", type=float, default=10.0, help="box prior upper bound on k")
    p.add_argument("--prior-mean", type=float, default=0.0, help="gaussian prior mean of log k")
    p.add_argument("--prior-sigma", type=float, default=0.6, help="gaussian prior sd of log k")


def _add_build(p: argparse.ArgumentParser) -> None:
    """The offline build's flags, shared by ``invert`` and ``map``."""
    p.add_argument("--device", default="cuda", help="torch device; cpu runs the plain kernel versions")
    p.add_argument("--resolution", type=int, default=4)
    p.add_argument("--biot", type=float, default=0.1)
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32",
                   help="the pipeline's dtype; float64 solves the FOM at tol 1e-10")
    p.add_argument("--cg-maxiter", type=int, default=None,
                   help="iteration cap per FOM solve (default: the reference's max(480, 120 * "
                        "resolution) in float32, 4,000 in float64)")
    p.add_argument("--metrics", type=str, default=None, help="JSONL metrics path")
    p.add_argument("--seed", type=int, default=0)
    _add_prior(p)
    p.add_argument("--n-snapshots", type=int, default=256)
    p.add_argument("--r", type=int, default=40)
    p.add_argument("--n-train", type=int, default=1024)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--online-precision", choices=["highest", "high", "fast"], default="highest",
                   help="the reduced solves' matmul tier: full fp32, bf16x3 (high) or one bf16 "
                        "pass (fast); the surrogate is trained on the same tier")
    # the reference's building commands share --out; only surrogate writes it
    p.add_argument("--out", type=str, default=None,
                   help="surrogate: save (MLP params, Ahat, V) as an npz in the JAX package's "
                        "layout; the other commands ignore it, as the reference does")


def _add_invert(p: argparse.ArgumentParser) -> None:
    """The flags of ``invert`` (and ``pipeline``)."""
    _add_build(p)
    p.add_argument("--chains", type=int, default=1024)
    p.add_argument("--steps", type=int, default=10_000)
    p.add_argument("--burn", type=int, default=1_000)
    p.add_argument("--beta", type=float, default=0.25)
    p.add_argument("--noise", type=float, default=1e-3)
    p.add_argument("--likelihood", choices=["fom", "rom", "rom_nn"], default="rom_nn")
    p.add_argument(
        "--sampler",
        choices=["pcn", "laplace_mh", "gpcn", "pt_pcn", "pt_mala", "da_pcn", "pt_da_pcn",
                 "mlda_pcn", "mala", "mala_lap", "hmc", "hmc_lap"],
        default="pcn",
    )
    p.add_argument("--n-temps", type=int, default=4, help="pt_pcn ladder size")
    p.add_argument("--lambda-min", type=float, default=0.05, help="pt_pcn hottest level")
    p.add_argument("--adapt-ladder", action="store_true",
                   help="tune the PT ladder during burn-in (swap-rate targeting)")
    p.add_argument("--subchain", type=int, default=64, help="da_pcn inner steps per fine correction")
    p.add_argument("--da-coarse", choices=["rom", "rom_nn"], default="rom_nn")
    p.add_argument("--da-inner", choices=["pcn", "mala"], default="pcn",
                   help="da_pcn subchain kernel (mala = gradient-informed)")
    p.add_argument("--mlda-resolution", type=int, default=2, help="mlda_pcn mid-rung FOM mesh resolution")
    p.add_argument("--mlda-subchain", type=int, default=4, help="mlda_pcn mid-rung steps per fine correction")
    p.add_argument("--hmc-leap", type=int, default=8,
                   help="hmc leapfrog steps per trajectory; 0 = auto (cross-chain ChEES "
                        "trajectory tuning, rom/rom_nn likelihoods)")
    p.add_argument("--mala-step", type=float, default=0.1,
                   help="initial MALA/HMC step size (adapted per chain in burn-in)")
    p.add_argument("--data", type=str, default=None,
                   help="observation npz (key 'data', as `fom --save-obs` writes) to invert "
                        "instead of synthetic data")
    p.add_argument("--infer-noise", action="store_true",
                   help="treat the observation noise as unknown: integrate sigma out under a "
                        "conjugate InvGamma(2, noise^2) prior; --noise becomes the prior's scale "
                        "and the sigma posterior is reported")
    p.add_argument("--init", choices=["prior", "eki", "vi"], default="prior",
                   help="chain starts: prior draws, an EKI ensemble (~10 batched forwards) or "
                        "draws from a short full-rank ADVI fit; unimodal posteriors only")
    p.add_argument("--sensors", type=str, default=None,
                   help="design npz from `design --out`: invert its pointwise sensor observables "
                        "instead of the five subfin averages")
    _add_shard(p)
    p.add_argument("--predict-at", action="append", default=None, metavar="X,Y",
                   help="the posterior predictive temperature at a point (repeatable; exact P1 "
                        "interpolation of a batched FOM solve over the posterior)")
    p.add_argument("--predict-out", type=str, default=None,
                   help="save the posterior temperature-field prediction (mean, sd, quantiles "
                        "per mesh node) as npz")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bayesianinferencedl_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("fom", help="config 1: single FOM solve")
    _add_common(p)
    p.add_argument("--k", type=float, nargs=5, default=[1.0, 1.0, 1.0, 1.0, 1.0])
    p.add_argument("--save-obs", type=str, default=None,
                   help="write the QoI vector as an observation npz for `invert --data`")
    p.set_defaults(fn=cmd_fom)

    p = sub.add_parser("snapshots", help="config 2: batched FOM solves")
    _add_common(p)
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--out", type=str, default=None)
    p.set_defaults(fn=cmd_snapshots)

    p = sub.add_parser("rom", help="config 3: reduced basis + rel-err")
    _add_common(p)
    p.add_argument("--n-snapshots", type=int, default=256)
    p.add_argument("--r", type=int, default=40)
    p.add_argument("--method", choices=["pod", "greedy"], default="pod")
    p.add_argument("--out", type=str, default=None)
    p.set_defaults(fn=cmd_rom)

    p = sub.add_parser("surrogate", help="config 4: build + the corrected model's gradient check")
    _add_build(p)
    p.set_defaults(fn=cmd_surrogate)

    for name, fn, help_ in (("invert", cmd_invert, "offline build + pCN inversion"),
                            ("pipeline", cmd_pipeline, "invert, under the reference's other name")):
        p = sub.add_parser(name, help=help_)
        _add_invert(p)
        p.set_defaults(fn=fn)

    p = sub.add_parser("map", help="MAP point + Laplace credible intervals")
    _add_build(p)
    p.add_argument("--noise", type=float, default=1e-3)
    p.add_argument("--likelihood", choices=["fom", "rom", "rom_nn"], default="rom_nn")
    p.add_argument("--infer-noise", action="store_true",
                   help="MAP under the sigma-marginalised potential (InvGamma(2, noise^2) prior); "
                        "Laplace intervals at the plug-in conditional-mode noise scale")
    p.add_argument("--psis", type=int, default=0, metavar="K",
                   help="certify the Laplace fit by Pareto-smoothed importance sampling with K "
                        "draws (the k-hat gate and the corrected mean; fixed noise only)")
    p.set_defaults(fn=cmd_map)

    psis_help = ("certify the moment-matched ensemble Gaussian by Pareto-smoothed importance "
                 "sampling with K draws (the k-hat gate and the corrected mean)")
    data_help = "observation npz (key 'data'): external measurements"
    p = sub.add_parser("eki", help="ensemble Kalman inversion: a derivative-free approximation")
    _add_build(p)
    p.add_argument("--noise", type=float, default=1e-2)
    p.add_argument("--likelihood", choices=["fom", "rom", "rom_nn"], default="rom_nn")
    p.add_argument("--ensemble", type=int, default=1024, help="ensemble size J")
    p.add_argument("--ess-target", type=float, default=0.5,
                   help="tempering-increment ESS fraction controlling the adaptive step")
    p.add_argument("--data", type=str, default=None, help=data_help)
    p.add_argument("--psis", type=int, default=0, metavar="K", help=psis_help)
    p.set_defaults(fn=cmd_eki)

    p = sub.add_parser("vi", help="ADVI: a Gaussian variational approximation")
    _add_build(p)
    p.add_argument("--noise", type=float, default=1e-2)
    p.add_argument("--likelihood", choices=["fom", "rom", "rom_nn"], default="rom_nn")
    p.add_argument("--rank", choices=["full", "meanfield"], default="full",
                   help="variational family: dense Cholesky or diagonal")
    p.add_argument("--steps", type=int, default=1500, help="Adam steps on the ELBO")
    p.add_argument("--mc", type=int, default=32, help="Monte Carlo draws per step")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--psis", type=int, default=0, metavar="K",
                   help="certify the fit by Pareto-smoothed importance sampling with K draws: "
                        "k-hat (< 0.7: the fit covers the posterior) and the corrected mean")
    p.add_argument("--data", type=str, default=None, help=data_help)
    p.add_argument("--flow", type=int, default=0, metavar="N",
                   help="fit a normalizing flow with N coupling layers instead of the Gaussian family")
    p.add_argument("--flow-pretrain", choices=["smc", "none"], default="smc",
                   help="smc: distill a tempered-SMC population (multimodal-safe); none: annealed "
                   "reverse-KL flow-VI over --steps (unimodal targets)")
    p.add_argument("--neutra", type=int, default=0, metavar="STEPS",
                   help="after the flow fit, flow-preconditioned pCN for STEPS steps (exact)")
    p.add_argument("--psis-widen", type=float, default=1.0, metavar="S",
                   help="certify the flow through its base widened to N(0, S^2 I)")
    p.set_defaults(fn=cmd_vi)

    p = sub.add_parser("svgd", help="Stein variational gradient descent: a particle approximation")
    _add_build(p)
    p.add_argument("--noise", type=float, default=1e-2)
    p.add_argument("--likelihood", choices=["fom", "rom", "rom_nn"], default="rom_nn")
    p.add_argument("--particles", type=int, default=512, help="ensemble size J")
    p.add_argument("--steps", type=int, default=800, help="Stein/Adam transport steps")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--anneal", type=int, default=-1, metavar="N",
                   help="likelihood ramp length (default steps // 2; 0 disables it)")
    p.add_argument("--data", type=str, default=None, help=data_help)
    p.add_argument("--psis", type=int, default=0, metavar="K", help=psis_help)
    p.add_argument("--segment", type=int, default=0, metavar="S",
                   help="the reference's scan chunk size (0 = auto); one eager loop runs every "
                   "step, so it changes nothing")
    p.set_defaults(fn=cmd_svgd)

    p = sub.add_parser("sbc", help="simulation-based calibration of a sampler and likelihood")
    _add_build(p)
    p.add_argument("--noise", type=float, default=1e-2)
    p.add_argument("--likelihood", choices=["fom", "rom", "rom_nn"], default="rom_nn")
    p.add_argument("--sampler", choices=["pcn", "mala", "hmc", "pt_pcn"], default="pcn",
                   help="the kernel under calibration")
    p.add_argument("--mala-step", type=float, default=0.1)
    p.add_argument("--hmc-leap", type=int, default=8)
    p.add_argument("--temps", type=int, default=5, help="pt_pcn ladder size")
    p.add_argument("--lambda-min", type=float, default=0.02, help="pt_pcn ladder floor")
    p.add_argument("--datasets", type=int, default=128, help="synthetic inversions J")
    p.add_argument("--sbc-chains", type=int, default=31,
                   help="chains per dataset C (posterior draws per rank; C + 1 must divide by --bins)")
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--burn", type=int, default=400)
    p.add_argument("--bins", type=int, default=8, help="rank-histogram bins")
    p.set_defaults(fn=cmd_sbc)

    p = sub.add_parser("design", help="optimal sensor placement: greedy max-information pointwise sensors")
    _add_common(p)
    _add_prior(p)
    p.add_argument("--sensors", type=int, default=5, help="sensors to place")
    p.add_argument("--noise", type=float, default=1e-2, help="assumed sensor noise")
    p.add_argument("--draws", type=int, default=16, help="prior draws for the EIG expectation")
    p.add_argument("--out", type=str, default=None,
                   help="save the design as npz (node_ids, xy, eig) for `invert --sensors`")
    p.set_defaults(fn=cmd_design)

    p = sub.add_parser("evidence", help="the log evidence by adaptive tempered SMC")
    _add_build(p)
    p.add_argument("--noise", type=float, default=1e-3)
    p.add_argument("--likelihood", choices=["fom", "rom", "rom_nn"], default="rom_nn")
    p.add_argument("--particles", type=int, default=4096, help="total SMC population")
    p.add_argument("--groups", type=int, default=8, help="independent populations (error bar)")
    p.add_argument("--mutations", type=int, default=5, help="pCN sweeps per tempering stage")
    p.add_argument("--ess-target", type=float, default=0.5, help="ESS/N kept per stage")
    _add_shard(p)
    p.set_defaults(fn=cmd_evidence)

    p = sub.add_parser("invert-ff", help="full-field (nodal k) inversion")
    _add_ff_build(p)
    p.add_argument("--chains", type=int, default=1024)
    p.add_argument("--steps", type=int, default=5000)
    p.add_argument("--burn", type=int, default=1000)
    p.add_argument("--beta", type=float, default=0.3)
    p.add_argument("--noise", type=float, default=1e-3)
    p.add_argument("--likelihood", choices=["fom", "rom", "rom_nn"], default="rom_nn")
    p.add_argument("--sampler", default="pcn",
                   choices=["pcn", "laplace_mh", "gpcn", "pt_pcn", "pt_mala", "da_pcn", "pt_da_pcn",
                            "mlda_pcn", "mala", "mala_lap", "hmc", "hmc_lap", "lis_pcn"])
    p.add_argument("--n-temps", type=int, default=5)
    p.add_argument("--lambda-min", type=float, default=0.02)
    p.add_argument("--adapt-ladder", action="store_true", help="tune the PT ladder in burn-in")
    # 64, as the reference CLI passes, while run_full_field_inversion defaults to 8
    p.add_argument("--subchain", type=int, default=64)
    p.add_argument("--da-inner", choices=["pcn", "mala"], default="pcn")
    p.add_argument("--mlda-resolution", type=int, default=2, help="mlda_pcn mid-rung mesh")
    p.add_argument("--mlda-subchain", type=int, default=4,
                   help="mlda_pcn mid-rung steps per fine correction")
    p.add_argument("--hmc-leap", type=int, default=8, help="leapfrog steps; 0 = ChEES (rom/rom_nn)")
    p.add_argument("--mala-step", type=float, default=0.1, help="initial MALA/HMC step size")
    p.add_argument("--lis-points", type=int, default=16, help="lis_pcn: Jacobian points")
    p.add_argument("--lis-rank", type=int, default=None, help="lis_pcn: cap on the subspace rank")
    p.add_argument("--lis-tol", type=float, default=0.1, help="lis_pcn: eigenvalue cutoff")
    p.add_argument("--data", type=str, default=None, help=data_help)
    p.add_argument("--infer-noise", action="store_true",
                   help="integrate the noise out under InvGamma(2, noise^2); report its posterior")
    _add_shard(p)
    p.add_argument("--predict-at", action="append", default=None, metavar="X,Y",
                   help="posterior-predictive temperature at a point (repeatable)")
    p.add_argument("--predict-out", type=str, default=None,
                   help="save the posterior temperature-field prediction as npz")
    p.set_defaults(fn=cmd_invert_ff)

    p = sub.add_parser("sbc-ff", help="simulation-based calibration of the full-field sampler stack")
    _add_ff_build(p)
    p.add_argument("--noise", type=float, default=1e-2)
    p.add_argument("--likelihood", choices=["fom", "rom", "rom_nn"], default="rom_nn")
    p.add_argument("--sampler", choices=["pcn", "mala", "hmc", "pt_pcn"], default="pcn")
    p.add_argument("--mala-step", type=float, default=0.1)
    p.add_argument("--hmc-leap", type=int, default=8)
    p.add_argument("--temps", type=int, default=5)
    p.add_argument("--lambda-min", type=float, default=0.02)
    p.add_argument("--datasets", type=int, default=128)
    p.add_argument("--sbc-chains", type=int, default=31)
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--burn", type=int, default=1000)
    p.add_argument("--bins", type=int, default=8)
    p.set_defaults(fn=cmd_sbc_ff)

    p = sub.add_parser("evidence-ff", help="full-field model evidence (adaptive tempered SMC)")
    _add_ff_build(p)
    p.add_argument("--noise", type=float, default=1e-3)
    p.add_argument("--likelihood", choices=["fom", "rom", "rom_nn"], default="rom_nn")
    p.add_argument("--particles", type=int, default=4096, help="total SMC population")
    p.add_argument("--groups", type=int, default=8, help="independent populations (error bar)")
    p.add_argument("--mutations", type=int, default=5, help="pCN sweeps per tempering stage")
    p.add_argument("--ess-target", type=float, default=0.5, help="ESS/N kept per stage")
    p.add_argument("--data", type=str, default=None, help=data_help)
    _add_shard(p)
    p.set_defaults(fn=cmd_evidence_ff)

    p = sub.add_parser("select-ell", help="the full-field prior's correlation length by evidence")
    _add_common(p)
    p.add_argument("--ells", type=float, nargs="+", required=True, help="candidate lengths")
    p.add_argument("--n-features", type=int, default=64)
    p.add_argument("--sigma", type=float, default=0.5)
    p.add_argument("--noise", type=float, default=1e-2)
    p.add_argument("--ell-true", type=float, default=None,
                   help="simulate observations from this ell (omit with --data)")
    p.add_argument("--n-datasets", type=int, default=1,
                   help="independent simulated experiments pooled (log Z summed)")
    p.add_argument("--data", type=str, default=None,
                   help="observation npz (key 'data', shape (n_obs,) or (E, n_obs))")
    p.add_argument("--particles", type=int, default=4096)
    p.add_argument("--groups", type=int, default=8)
    p.add_argument("--mutations", type=int, default=5)
    p.add_argument("--max-stages", type=int, default=128)
    p.set_defaults(fn=cmd_select_ell)

    return ap


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if getattr(args, "shard", None) is not None and "WORLD_SIZE" in os.environ:
        from bayesianinferencedl_tpu_torch.parallel.mesh import device_mesh

        _rank_main(device_mesh(device=args.device), argv)  # a rank that torchrun started
    elif _n_ranks(args) > 1:
        from bayesianinferencedl_tpu_torch.parallel.mesh import launch

        launch(_rank_main, _n_ranks(args), argv, device=args.device)
    else:
        args.fn(args)


if __name__ == "__main__":
    main()
