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
outer and inner accept rates to the line. ``invert --data obs.npz`` inverts
the observations ``fom --save-obs`` wrote (``theta_true`` is then null);
``--dtype float64`` builds the pipeline in float64, with FOM solves at tol
1e-10 under a cap of 4,000 (the plain PCG).
Flags the port does not support yet (other samplers, pcn on the fom
likelihood, box priors, the bf16 precision tiers, the MALA inner kernel,
the greedy ROM basis) raise NotImplementedError naming their ROADMAP.md
item.
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


def cmd_invert(args) -> None:
    from bayesianinferencedl_tpu_torch.config import (
        FEMConfig, MCMCConfig, MeshConfig, PipelineConfig, PriorConfig, ROMConfig, SurrogateConfig,
    )
    from bayesianinferencedl_tpu_torch.api import build_pipeline, run_inversion
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    log = MetricsLogger(args.metrics)
    cfg = PipelineConfig(
        mesh=MeshConfig(resolution=args.resolution),
        fem=FEMConfig(biot=args.biot, cg_tol=1e-10 if args.dtype == "float64" else 1e-7,
                      cg_maxiter=_cg_maxiter(args) if args.cg_maxiter is None else args.cg_maxiter),
        rom=ROMConfig(
            n_snapshots=args.n_snapshots, basis_size=args.r, seed=args.seed,
            online_precision=args.online_precision,
        ),
        surrogate=SurrogateConfig(n_train=args.n_train, epochs=args.epochs, seed=args.seed),
        mcmc=MCMCConfig(
            n_chains=args.chains, n_steps=args.steps, n_burn=args.burn, beta=args.beta,
            noise_sigma=args.noise, likelihood=args.likelihood, sampler=args.sampler,
            seed=args.seed, subchain=args.subchain, da_coarse=args.da_coarse,
            da_inner=args.da_inner,
        ),
        prior=PriorConfig(mean=args.prior_mean, sigma=args.prior_sigma, dim=5, kind=args.prior),
    )
    pipe = build_pipeline(cfg, device=args.device, dtype=_dtype(args), metrics=log)
    obs = None
    if args.data:
        obs = torch.as_tensor(np.load(args.data)["data"])
        log.log("external_data", path=args.data, n_obs=int(obs.shape[0]))
    inv = run_inversion(pipe, data=obs, metrics=log)
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
    if args.sampler == "da_pcn":
        out["outer_accept"] = out["accept_rate"]
        out["inner_accept"] = float(torch.mean(inv.result.inner_accept_rate))
    if inv.fom_iter_cap is not None:
        out["fom_iter_audit"] = {"cap": inv.fom_iter_cap, "max_iters": inv.fom_iter_max,
                                 "hit_cap_frac": inv.fom_hit_cap_frac}
    print(json.dumps(out))


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

    p = sub.add_parser("invert", help="offline build + pCN inversion")
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
    p.add_argument("--prior-mean", type=float, default=0.0, help="gaussian prior mean of log k")
    p.add_argument("--prior-sigma", type=float, default=0.6, help="gaussian prior sd of log k")
    p.add_argument("--n-snapshots", type=int, default=256)
    p.add_argument("--r", type=int, default=40)
    p.add_argument("--n-train", type=int, default=1024)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--online-precision", choices=["highest", "high", "fast"], default="highest")
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
    p.add_argument("--subchain", type=int, default=64, help="da_pcn inner steps per fine correction")
    p.add_argument("--da-coarse", choices=["rom", "rom_nn"], default="rom_nn")
    p.add_argument("--da-inner", choices=["pcn", "mala"], default="pcn",
                   help="da_pcn subchain kernel (mala is not ported yet)")
    p.add_argument("--data", type=str, default=None,
                   help="observation npz (key 'data', as `fom --save-obs` writes) to invert "
                        "instead of synthetic data")
    p.set_defaults(fn=cmd_invert)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
