"""Every sharded family once at tiny shapes over a mesh, each family's seconds
written to stderr as it finishes: the quickest check that the multi-rank
paths start on a machine, and where their time goes.

    python -m bayesianinferencedl_tpu_torch.parallel.dryrun --devices N
    python -m bayesianinferencedl_tpu_torch.parallel.dryrun --devices 4 --device cpu

runs N ranks, one a card (``--device cpu``: N gloo ranks on the CPU), each
with 4 chains; N = 1 runs in this process. A line reads
``[dryrun +<s since start>s] <family>: <s>``, from rank 0; the last line of
the standard output is a JSON object of the families' seconds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from bayesianinferencedl_tpu_torch.parallel.mesh import device_mesh, launch, rank_of, size_of


def _tiny_pipeline(dev):
    from bayesianinferencedl_tpu_torch.api import build_pipeline
    from bayesianinferencedl_tpu_torch.config import (
        MCMCConfig, MeshConfig, PipelineConfig, ROMConfig, SurrogateConfig,
    )

    cfg = PipelineConfig(mesh=MeshConfig(resolution=1), rom=ROMConfig(n_snapshots=16, basis_size=6),
                         surrogate=SurrogateConfig(hidden=(16, 16), n_train=32, epochs=2),
                         mcmc=MCMCConfig(noise_sigma=1e-2))
    return build_pipeline(cfg, device=dev, dtype=torch.float32)


def dryrun(mesh, *, log: bool = True) -> dict:
    """Run every sharded family for a step or two on tiny shapes over the
    mesh (4 chains a rank), checking each result's shape and finiteness.
    Returns {family: seconds}; with log, rank 0 writes each to stderr as it
    finishes."""
    from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit
    from bayesianinferencedl_tpu_torch.models.surrogate import MLP, adam_init
    from bayesianinferencedl_tpu_torch.parallel import sharding as S
    from bayesianinferencedl_tpu_torch.parallel.domain import solve_fom_domain_sharded

    n, r = size_of(mesh), rank_of(mesh)
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) if mesh.device_type == "cuda" \
        else torch.device("cpu")
    t_start = time.perf_counter()
    secs, last = {}, [t_start]

    def mark(name, *tensors):
        for t in tensors:
            if not bool(torch.isfinite(t).all()):
                raise RuntimeError(f"dryrun {name}: non-finite result")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        secs[name] = round(now - last[0], 3)
        last[0] = now
        if log and r == 0:
            print(f"[dryrun +{now - t_start:6.1f}s] {name}: {secs[name]}s", file=sys.stderr, flush=True)

    pipe = _tiny_pipeline(dev)
    mark("tiny_pipeline_build")
    prior = pipe.prior
    fwd = pipe.working_forward_fn("rom_nn")
    fwd_d = pipe.working_forward_fn("rom_nn", differentiable=True)
    data = fwd(torch.zeros((1, 5), device=dev))[0]
    misfit = gaussian_misfit(fwd, data, 1e-2)
    misfit_d = gaussian_misfit(fwd_d, data, 1e-2)
    fine = lambda th: misfit(th) + 0.01 * torch.sum(th * th, -1)
    C = 4 * n
    gen = torch.Generator(device=dev).manual_seed(0)
    theta0 = prior.sample(gen, (C,))

    res = S.sharded_pcn(mesh, misfit, prior, theta0, gen, n_steps=1, beta=0.3)
    mlp = MLP((5, 32, 5), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    xb = torch.randn((8 * n, 5), generator=gen, device=dev)
    _, _, loss = S.dp_train_step(mesh, mlp, mlp.params(), adam_init(mlp.params()), xb, xb, 1e-3)
    mark("pcn_step+dp_train", res.samples, loss)

    u, _ = solve_fom_domain_sharded(mesh, pipe.fin.op, torch.ones(5, device=dev), tol=1e-5, maxiter=500)
    mark("fom_domain_decomposed", u)
    ks = torch.exp(torch.randn((2 * n, 5), generator=gen, device=dev) * 0.3)
    mark("snapshots", S.sharded_snapshots(mesh, pipe.fin.op, ks, tol=1e-6, maxiter=500))

    kw = dict(n_steps=3, n_burn=1)
    res = S.sharded_da_pcn(mesh, fine, misfit, prior, theta0, gen, beta=0.3, subchain=2, **kw)
    mark("da_pcn", res.samples)
    res = S.sharded_pt_pcn(mesh, misfit, prior, theta0, gen, n_temps=3, **kw)
    mark("pt_pcn", res.samples, res.swap_rate)
    res = S.sharded_pt_da_segmented(mesh, fine, misfit, prior, theta0, gen, subchain=2, n_temps=3,
                                    segment=2, **kw)
    mark("pt_da", res.samples)
    res = S.sharded_mlda_segmented(mesh, (misfit, fine, fine), prior, theta0, gen, subchains=(2, 2),
                                   segment=2, **kw)
    mark("mlda", res.samples)
    res = S.sharded_mala(mesh, misfit_d, prior, theta0, gen, step=0.05, **kw)
    mark("mala", res.samples)
    res = S.sharded_hmc(mesh, misfit_d, prior, theta0, gen, step=0.05, n_leap=2, **kw)
    mark("hmc", res.samples)
    res, _ = S.sharded_hmc_chees(mesh, misfit_d, prior, theta0, gen, n_steps=10, n_burn=8, step=0.05,
                                 leap_candidates=(1, 2), n_adapt=2, n_meas=2)
    mark("hmc_chees", res.samples)
    res = S.sharded_pt_mala(mesh, misfit_d, prior, theta0, gen, step=0.05, n_temps=3, **kw)
    mark("pt_mala", res.samples)
    res = S.sharded_lis_pcn_segmented(mesh, misfit, prior, _lis(fwd_d, prior, theta0), theta0, gen,
                                      segment=2, **kw)
    mark("lis_pcn", res.samples)

    from bayesianinferencedl_tpu_torch.infer.eki import run_eki
    from bayesianinferencedl_tpu_torch.infer.psis import psis_correct

    ens = run_eki(fwd, prior, data, 1e-2, gen, n_ensemble=C, max_iters=3, mesh=mesh)
    mark("eki", ens.ensemble)
    vi = S.sharded_advi(mesh, misfit_d, prior, gen, n_steps=2, n_mc=2 * n)
    mark("advi", vi.theta_mean)
    flow = S.sharded_flow_vi(mesh, misfit_d, prior, gen, n_couplings=2, hidden=8, n_steps=2, n_mc=2 * n,
                             n_summary=64)
    mark("flow_vi", flow.theta_mean)
    sv = S.sharded_svgd(mesh, misfit_d, prior, gen, n_particles=C, n_steps=2)
    mark("svgd", sv.particles)
    ps = psis_correct(misfit, prior, vi.theta_mean, vi.theta_chol, gen, n_draws=8 * n, mesh=mesh)
    mark("psis", torch.as_tensor(ps.mean))
    smc, lz = S.sharded_smc(mesh, misfit, prior, gen, n_particles=8 * n, n_mutations=1, max_stages=4)
    mark("smc", smc.particles, lz)
    return secs


def _lis(fwd_d, prior, pts):
    from bayesianinferencedl_tpu_torch.infer.lis import build_lis

    return build_lis(fwd_d, prior, pts[:2], 1e-2, rank_max=3)


def _rank(mesh) -> None:
    secs = dryrun(mesh)
    if rank_of(mesh) == 0:
        print(json.dumps({"world": size_of(mesh), "device": mesh.device_type, "families": secs}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="bayesianinferencedl_tpu_torch.parallel.dryrun")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks, one a card (default: every card; 1 on the CPU)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    n = args.devices or (torch.cuda.device_count() if args.device == "cuda" else 1)
    if n == 1:
        _rank(device_mesh(1, device=args.device))
    else:
        launch(_rank, n, device=args.device)


if __name__ == "__main__":
    main()
