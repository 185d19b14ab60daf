"""Command-line interface of the port.

    python -m bayesianinferencedl_tpu_torch.cli invert --device cuda

builds the pipeline (every FOM solve through kernel K1, or K3 from res8 up)
and runs pCN on the rom_nn likelihood, then prints one JSON line with the
keys of the reference CLI's ``invert``.

    python -m bayesianinferencedl_tpu_torch.cli invert --sampler da_pcn \
        --likelihood fom --resolution 8 --noise 1e-2 --steps 500 --burn 150

runs delayed acceptance on the exact FOM likelihood (``--subchain`` rom_nn
pCN steps per batched FOM correction; steps count outer steps) and adds the
FOM iteration audit and the outer and inner accept rates to the line.
Flags the port does not support yet (other samplers, pcn on the fom
likelihood, box priors, the bf16 precision tiers, the MALA inner kernel)
raise NotImplementedError naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import json

import torch


def cmd_invert(args) -> None:
    from bayesianinferencedl_tpu_torch.config import (
        FEMConfig, MCMCConfig, MeshConfig, PipelineConfig, PriorConfig, ROMConfig, SurrogateConfig,
    )
    from bayesianinferencedl_tpu_torch.api import build_pipeline, run_inversion
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    log = MetricsLogger(args.metrics)
    cfg = PipelineConfig(
        mesh=MeshConfig(resolution=args.resolution),
        fem=FEMConfig(biot=args.biot, cg_tol=1e-7, cg_maxiter=args.cg_maxiter),
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
    pipe = build_pipeline(cfg, device=args.device, metrics=log)
    inv = run_inversion(pipe, metrics=log)
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
        "theta_true": pipe.prior.to_theta(inv.theta_true).cpu().tolist(),
    }
    if inv.ppc is not None:
        out["ppc_p_value"] = inv.ppc["p_value"]
    if args.sampler == "da_pcn":
        out["outer_accept"] = out["accept_rate"]
        out["inner_accept"] = float(torch.mean(inv.result.inner_accept_rate))
    if inv.fom_iter_cap is not None:
        out["fom_iter_cap"] = inv.fom_iter_cap
        out["fom_iter_max"] = inv.fom_iter_max
        out["fom_hit_cap_frac"] = inv.fom_hit_cap_frac
    print(json.dumps(out))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="bayesianinferencedl_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("invert", help="offline build + pCN inversion")
    p.add_argument("--device", default="cuda", help="torch device; cpu runs the plain kernel versions")
    p.add_argument("--resolution", type=int, default=4)
    p.add_argument("--biot", type=float, default=0.1)
    p.add_argument("--cg-maxiter", type=int, default=1500, help="iteration cap per FOM solve")
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
    p.set_defaults(fn=cmd_invert)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
