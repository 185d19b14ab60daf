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
``--da-inner mala`` gives the DA samplers MALA subchains.

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
fp32, bf16x3, one bf16 pass). Flags the port does not support yet
(``mlda_pcn``, the greedy ROM basis) raise NotImplementedError naming their
ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import json
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
    from bayesianinferencedl_tpu_torch.rom.pod import pod_basis_host
    from bayesianinferencedl_tpu_torch.rom.snapshots import sample_log_uniform
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    if args.method == "greedy":
        raise NotImplementedError("rom --method greedy (rom/greedy.py) is not ported yet: "
                                  "ROADMAP.md queue 1, item 21")
    log = MetricsLogger(args.metrics, run_config=vars(args))
    fin = _fin(args)
    dev, dt = fin.op.device, _dtype(args)
    solver = make_fom_solver(fin, tol=fin.cg_tol, maxiter=fin.cg_maxiter)
    ks = sample_log_uniform(torch.Generator(device=dev).manual_seed(args.seed), args.n_snapshots, dtype=dt)
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
            da_inner=args.da_inner, infer_noise=args.infer_noise, hmc_leap=args.hmc_leap,
            mala_step=args.mala_step,
        ))
    pipe = build_pipeline(cfg, device=args.device, dtype=_dtype(args), metrics=log)
    obs = None
    if args.data:
        obs = torch.as_tensor(np.load(args.data)["data"])
        log.log("external_data", path=args.data, n_obs=int(obs.shape[0]))
    inv = run_inversion(pipe, init=args.init, data=obs, metrics=log)
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
    pipe = build_pipeline(_pipeline_config(args, mcmc), device=args.device, dtype=_dtype(args),
                          metrics=log)
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
        generator=torch.Generator(device=pipe.device).manual_seed(args.seed), metrics=log,
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
                          n_mutations=args.mutations, ess_target=args.ess_target, metrics=log)
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
    p.add_argument("--prior", choices=["gaussian", "uniform", "log_uniform"], default="gaussian")
    p.add_argument("--prior-low", type=float, default=0.1, help="box prior lower bound on k")
    p.add_argument("--prior-high", type=float, default=10.0, help="box prior upper bound on k")
    p.add_argument("--prior-mean", type=float, default=0.0, help="gaussian prior mean of log k")
    p.add_argument("--prior-sigma", type=float, default=0.6, help="gaussian prior sd of log k")
    p.add_argument("--n-snapshots", type=int, default=256)
    p.add_argument("--r", type=int, default=40)
    p.add_argument("--n-train", type=int, default=1024)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--online-precision", choices=["highest", "high", "fast"], default="highest",
                   help="the reduced solves' matmul tier: full fp32, bf16x3 (high) or one bf16 "
                        "pass (fast); the surrogate is trained on the same tier")


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


def main(argv=None) -> None:
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
    p.add_argument("--out", type=str, default=None,
                   help="save (MLP params, Ahat, V) as an npz in the JAX package's layout")
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
    p.set_defaults(fn=cmd_svgd)

    p = sub.add_parser("evidence", help="the log evidence by adaptive tempered SMC")
    _add_build(p)
    p.add_argument("--noise", type=float, default=1e-3)
    p.add_argument("--likelihood", choices=["fom", "rom", "rom_nn"], default="rom_nn")
    p.add_argument("--particles", type=int, default=4096, help="total SMC population")
    p.add_argument("--groups", type=int, default=8, help="independent populations (error bar)")
    p.add_argument("--mutations", type=int, default=5, help="pCN sweeps per tempering stage")
    p.add_argument("--ess-target", type=float, default=0.5, help="ESS/N kept per stage")
    p.set_defaults(fn=cmd_evidence)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
