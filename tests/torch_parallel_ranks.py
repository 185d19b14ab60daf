"""The rank bodies of the port's multi-rank CPU tests (``test_torch_parallel.py``,
``test_torch_domain_sharded.py``): each runs in every rank of a gloo world
started by ``parallel.mesh.launch`` and writes its results as npz files into
a directory the test reads. This module imports only torch, NumPy and the
port, so that a rank starts in seconds."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
from bayesianinferencedl_tpu_torch.parallel import sharding as S
from bayesianinferencedl_tpu_torch.parallel.mesh import gather_rows, halo_rows, rank_of, size_of

D, C, N_STEPS, N_BURN, SUB, K = 3, 8, 10, 4, 2, 3
F64 = dict(dtype=torch.float64, device="cpu")


def _flat(res, prefix="") -> dict:
    """The tensor leaves of a (nested) NamedTuple as numpy arrays."""
    out = {}
    for name, v in res._asdict().items():
        if hasattr(v, "_asdict"):
            out.update(_flat(v, f"{prefix}{name}."))
        elif torch.is_tensor(v):
            out[prefix + name] = v.detach().cpu().numpy()
    return out


def _save(out_dir: str, name: str, arrays: dict) -> None:
    np.savez(os.path.join(out_dir, name + ".npz"), **arrays)


def problem():
    """A nonlinear 3-parameter problem with a fine, a mid and a coarse
    misfit (batched, differentiable), the prior and an LIS basis."""
    from bayesianinferencedl_tpu_torch.infer.lis import build_lis
    from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit

    rng = np.random.default_rng(0)
    H = torch.tensor(rng.standard_normal((4, D)))
    data = torch.tensor(rng.standard_normal(4))
    fwd = lambda t, c=0.0: torch.tanh(t) @ H.T + c
    prior = GaussianPrior.iid(D, sigma=1.0, **F64)
    lis = build_lis(fwd, prior, torch.tensor(rng.standard_normal((4, D))), 0.5)
    return dict(prior=prior, lis=lis, fine=gaussian_misfit(fwd, data, 0.5),
                mid=gaussian_misfit(lambda t: fwd(t, 0.1), data, 0.5),
                coarse=gaussian_misfit(lambda t: fwd(t, 0.3), data, 0.5))


def _draws(seed: int, **shapes) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for k, shp in shapes.items():
        if isinstance(shp, list):
            out[k] = tuple(torch.tensor(rng.uniform(0.0, 1.0, s)) for s in shp)
        elif k in ("normals", "eps"):
            out[k] = torch.tensor(rng.standard_normal(shp))
        elif k == "jitters":
            out[k] = torch.tensor(rng.uniform(-1.0, 1.0, shp))
        else:
            out[k] = torch.tensor(rng.uniform(0.0, 1.0, shp))
    return out


def families(p) -> dict:
    """name -> (plain runner, its arguments after the mesh, keywords with
    the whole batch's draws): every chain-independent sharded family."""
    from bayesianinferencedl_tpu_torch.infer import (
        delayed_acceptance as da, hmc, lis, mala, mlda, pcn, tempering as pt,
    )

    n, b = N_STEPS, N_BURN
    rng = np.random.default_rng(1)
    th = torch.tensor(rng.normal(0.0, 0.8, (C, D)))
    pc = dict(normals=(n, C, D), uniforms=(n, C))
    hm = dict(normals=(n, C, D), jitters=(n, C), uniforms=(n, C))
    dd = dict(normals=(n, SUB, C, D), uniforms=(n, SUB, C), outer_uniforms=(n, C))
    ptd = dict(normals=(n, K, C, D), uniforms=(n, K, C), swap_uniforms=(n, K, C))
    ptdd = dict(normals=(n, SUB, K, C, D), uniforms=(n, SUB, K, C), outer_uniforms=(n, K, C),
                swap_uniforms=(n, K, C))
    ml = dict(normals=(n, SUB, SUB, C, D), uniforms=[(n, SUB, SUB, C), (n, SUB, C), (n, C)])
    kw = dict(n_steps=n, n_burn=b)
    f, c, pr = p["fine"], p["coarse"], p["prior"]
    return {
        "pcn": (pcn.run_pcn, (f, pr, th), dict(kw, beta=0.3, **_draws(2, **pc))),
        "pcn_segmented": (pcn.run_pcn_segmented, (f, pr, th), dict(kw, beta=0.3, segment=4,
                                                                   **_draws(3, **pc))),
        "mala": (mala.run_mala, (f, pr, th), dict(kw, step=0.2, **_draws(4, **pc))),
        "mala_segmented": (mala.run_mala_segmented, (f, pr, th),
                           dict(kw, step=0.2, segment=4, **_draws(5, **pc))),
        "hmc": (hmc.run_hmc, (f, pr, th), dict(kw, step=0.2, n_leap=3, **_draws(6, **hm))),
        "hmc_segmented": (hmc.run_hmc_segmented, (f, pr, th),
                          dict(kw, step=0.2, n_leap=3, segment=4, **_draws(7, **hm))),
        "lis_pcn": (lis.run_lis_pcn, (f, pr, p["lis"], th), dict(kw, beta=0.4, **_draws(8, **pc))),
        "lis_pcn_segmented": (lis.run_lis_pcn_segmented, (f, pr, p["lis"], th),
                              dict(kw, beta=0.4, segment=4, **_draws(9, **pc))),
        "da_pcn": (da.run_da_pcn, (f, c, pr, th), dict(kw, beta=0.3, subchain=SUB, **_draws(10, **dd))),
        "da_pcn_segmented": (da.run_da_pcn_segmented, (f, c, pr, th),
                             dict(kw, beta=0.3, subchain=SUB, segment=4, **_draws(11, **dd))),
        "pt_pcn": (pt.run_pt_pcn, (f, pr, th), dict(kw, beta=0.3, n_temps=K, lambda_min=0.1,
                                                    adapt_ladder=True, **_draws(12, **ptd))),
        "pt_mala": (pt.run_pt_mala, (f, pr, th), dict(kw, step=0.2, n_temps=K, lambda_min=0.1,
                                                      **_draws(13, **ptd))),
        "pt_da": (pt.run_pt_da, (f, c, pr, th), dict(kw, beta=0.3, subchain=SUB, n_temps=K,
                                                     lambda_min=0.1, **_draws(14, **ptdd))),
        "pt_da_segmented": (pt.run_pt_da_segmented, (f, c, pr, th),
                            dict(kw, beta=0.3, subchain=SUB, n_temps=K, lambda_min=0.1, segment=4,
                                 adapt_ladder=True, **_draws(15, **ptdd))),
        "mlda": (mlda.run_mlda, ((c, p["mid"], f), pr, th), dict(kw, beta=0.3, subchains=(SUB, SUB),
                                                                  **_draws(16, **ml))),
        "mlda_segmented": (mlda.run_mlda_segmented, ((c, p["mid"], f), pr, th),
                           dict(kw, beta=0.3, subchains=(SUB, SUB), segment=4, **_draws(17, **ml))),
    }


def _chees_draws(n_cands: int) -> dict:
    hm = lambda n, s: _draws(s, normals=(n, C, D), jitters=(n, C), uniforms=(n, C))
    return {"pre": hm(8, 30), "probes": [hm(8, 31 + i) for i in range(n_cands)], "main": hm(12, 40)}


def _pipeline(resolution: int):
    from bayesianinferencedl_tpu_torch.api import build_pipeline
    from bayesianinferencedl_tpu_torch.config import (
        FEMConfig, MCMCConfig, MeshConfig, PipelineConfig, ROMConfig, SurrogateConfig,
    )

    cfg = PipelineConfig(
        mesh=MeshConfig(resolution=resolution), fem=FEMConfig(biot=0.1, cg_tol=1e-6, cg_maxiter=300),
        rom=ROMConfig(n_snapshots=16, basis_size=6),
        surrogate=SurrogateConfig(hidden=(8, 8), n_train=32, epochs=2),
        mcmc=MCMCConfig(n_chains=C, n_steps=6, n_burn=2, noise_sigma=1e-2, likelihood="rom_nn",
                        subchain=SUB, da_coarse="rom", n_temps=K, mlda_resolution=1,
                        mlda_subchain=SUB))
    return build_pipeline(cfg, device="cpu", dtype=torch.float32)


# (sampler, likelihood, the sharded runner run_inversion must reach)
ROUTES = (("da_pcn", "rom_nn", "sharded_da_pcn_segmented"),
          ("pt_pcn", "rom_nn", "sharded_pt_pcn"),
          ("pt_da_pcn", "rom_nn", "sharded_pt_da_segmented"),
          ("pt_mala", "rom_nn", "sharded_pt_mala"),
          ("mlda_pcn", "fom", "sharded_mlda_segmented"))


def parallel_checks(mesh, out_dir: str) -> None:
    """Every check of test_torch_parallel.py that needs the ranks."""
    r, n = rank_of(mesh), size_of(mesh)
    t0 = time.perf_counter()
    secs = {}

    # the collectives themselves
    x = torch.full((2, 3), float(r), dtype=torch.float64)
    g = gather_rows(mesh, x, 0)
    u = torch.arange(4 * 3, dtype=torch.float64).reshape(4, 3) + 100.0 * r
    above, below = halo_rows(mesh, u)
    ok = {"gather": bool(torch.equal(g, torch.repeat_interleave(torch.arange(n, dtype=torch.float64), 2)
                                      [:, None].expand(2 * n, 3))),
          "halo_above": bool(torch.equal(above[0], u[-1] - 100.0) if r > 0 else not above.any()),
          "halo_below": bool(torch.equal(below[0], u[0] + 100.0) if r < n - 1 else not below.any()),
          "bool_gather": bool(gather_rows(mesh, torch.tensor([r % 2 == 0]), 0).tolist()
                              == [i % 2 == 0 for i in range(n)])}
    oks = gather_rows(mesh, torch.tensor([all(ok.values())]), 0)
    if r == 0:
        with open(os.path.join(out_dir, "collectives.json"), "w") as fh:
            json.dump({"every_rank": bool(oks.all()), **ok}, fh)

    # (a) the chain-independent families, sharded against the unsharded runner
    p = problem()
    fams = families(p)
    for i, (name, (plain, args, kw)) in enumerate(fams.items()):
        res = getattr(S, "sharded_" + name)(mesh, *args, None, **kw)
        if r == 0:
            _save(out_dir, f"fam_{name}_sharded", _flat(res))
        if r == i % n:  # the unsharded runs, spread over the ranks
            _save(out_dir, f"fam_{name}_plain", _flat(plain(*args, None, **kw)))
    secs["families"] = time.perf_counter() - t0

    # (b) one data-parallel training step, against the reference's in the test
    from bayesianinferencedl_tpu_torch.models.surrogate import MLP, adam_init

    rng = np.random.default_rng(5)
    W = [(rng.normal(0, 0.5, (5, 16)), rng.normal(0, 0.1, 16)), (rng.normal(0, 0.5, (16, 3)),
                                                                  rng.normal(0, 0.1, 3))]
    mlp = MLP.from_params([(torch.tensor(a), torch.tensor(b_)) for a, b_ in W])
    xb, yb = torch.tensor(rng.standard_normal((64, 5))), torch.tensor(rng.standard_normal((64, 3)))
    leaves, _, loss = S.dp_train_step(mesh, mlp, mlp.params(), adam_init(mlp.params()), xb, yb, 1e-3)
    if r == 0:
        _save(out_dir, "dp_train", {"loss": loss.numpy(), **{f"p{i}": q.detach().numpy()
                                                             for i, q in enumerate(leaves)}})

    # (c) snapshots: float64 res1 through the plain PCG, and float32 through the kernels' route
    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.ops.pcg_stencil import solve_fom_stencil

    ks = np.exp(np.random.default_rng(6).uniform(np.log(0.1), np.log(10.0), (16, 5)))
    fin64 = FiveParamFin.create(resolution=1, dtype=torch.float64, device="cpu")
    S64 = S.sharded_snapshots(mesh, fin64.op, torch.tensor(ks), tol=1e-12)
    fin32 = FiveParamFin.create(resolution=1, dtype=torch.float32, device="cpu")
    S32 = S.sharded_snapshots(mesh, fin32.op, torch.tensor(ks), tol=1e-6, maxiter=800)
    if r == 0:
        S32_plain = solve_fom_stencil(fin32.op, torch.tensor(ks, dtype=torch.float32), tol=1e-6,
                                      maxiter=800)[0]
        _save(out_dir, "snapshots", {"ks": ks, "S64": S64.numpy(), "S32": S32.numpy(),
                                     "S32_plain": S32_plain.numpy()})

    # (e) SVGD, ADVI, flow-VI and ChEES against their unsharded runs on the same draws
    from bayesianinferencedl_tpu_torch.infer.flow import run_flow_vi
    from bayesianinferencedl_tpu_torch.infer.hmc import run_hmc_chees
    from bayesianinferencedl_tpu_torch.infer.svgd import run_svgd
    from bayesianinferencedl_tpu_torch.infer.vi import run_advi

    f, pr = p["fine"], p["prior"]
    th0 = torch.tensor(np.random.default_rng(20).normal(0.0, 0.8, (16, D)))
    eps = torch.tensor(np.random.default_rng(21).standard_normal((12, 8, D)))
    Z = torch.tensor(np.random.default_rng(22).standard_normal((64, D)))
    cands = (1, 2, 4)
    runs = {
        "svgd": (lambda: S.sharded_svgd(mesh, f, pr, None, n_steps=12, theta0=th0),
                 lambda: run_svgd(f, pr, None, n_steps=12, theta0=th0)),
        "advi": (lambda: S.sharded_advi(mesh, f, pr, None, n_steps=12, n_mc=8, eps=eps),
                 lambda: run_advi(f, pr, None, n_steps=12, n_mc=8, eps=eps)),
        "chees": (lambda: S.sharded_hmc_chees(mesh, f, pr, th0[:C], None, n_steps=20, n_burn=16,
                                              step=0.2, leap_candidates=cands, n_adapt=4, n_meas=4,
                                              draws=_chees_draws(len(cands)))[0],
                  lambda: run_hmc_chees(f, pr, th0[:C], None, n_steps=20, n_burn=16, step=0.2,
                                        leap_candidates=cands, n_adapt=4, n_meas=4,
                                        draws=_chees_draws(len(cands)))[0]),
    }
    flow_kw = dict(n_couplings=2, hidden=4, n_steps=12, n_mc=8, n_summary=64, eps=eps, summary_Z=Z)
    g_flow = torch.Generator().manual_seed(23)
    flow_sh = S.sharded_flow_vi(mesh, f, pr, g_flow, **flow_kw)
    for name, (sharded, plain) in runs.items():
        res = sharded()
        if r == 0:
            _save(out_dir, f"approx_{name}_sharded", _flat(res))
            _save(out_dir, f"approx_{name}_plain", _flat(plain()))
    if r == 0:
        from bayesianinferencedl_tpu_torch.infer.flow import _flow_to_train

        flow0 = _flow_to_train(None, D, 2, 4, torch.Generator().manual_seed(23), torch.float64, "cpu")
        flow_pl = run_flow_vi(f, pr, None, params=flow0, **flow_kw)
        _save(out_dir, "approx_flow", {"elbo_sharded": flow_sh.elbo_trace.numpy(),
                                       "elbo_plain": flow_pl.elbo_trace.numpy(),
                                       "mean_sharded": flow_sh.theta_mean.numpy(),
                                       "mean_plain": flow_pl.theta_mean.numpy()})

    # (f) island SMC: island r is run_smc on rank r's generator
    from bayesianinferencedl_tpu_torch.infer.smc import run_smc
    from bayesianinferencedl_tpu_torch.parallel.mesh import rank_generator

    smc, lz = S.sharded_smc(mesh, f, pr, torch.Generator().manual_seed(9), n_particles=64,
                            n_mutations=2, max_stages=16)
    own = run_smc(f, pr, rank_generator(torch.Generator().manual_seed(9), mesh), n_particles=64 // n,
                  n_mutations=2, max_stages=16)
    same = gather_rows(mesh, torch.tensor([
        bool(torch.equal(smc.particles[r], own.particles[0]) and torch.equal(lz[r], own.log_evidence[0])
             and torch.equal(smc.lambdas[:, r], own.lambdas[:, 0]))]), 0)
    if r == 0:
        _save(out_dir, "smc", {"lz": lz.numpy(), "log_evidence": smc.log_evidence.numpy(),
                               "particles": smc.particles.numpy(), "n_stages": smc.n_stages.numpy(),
                               "islands_equal": same.numpy()})
    secs["approx"] = time.perf_counter() - t0

    # (g) run_inversion(mesh=) through the sharded runners
    from bayesianinferencedl_tpu_torch.api import run_inversion

    calls = {}

    def spy(name):
        real = getattr(S, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)

        return wrapped

    for _, _, name in ROUTES:
        setattr(S, name, spy(name))
    pipe = _pipeline(2)
    routes = {}
    for sampler, like, name in ROUTES:
        inv = run_inversion(pipe, sampler=sampler, likelihood=like, mesh=mesh,
                            generator=torch.Generator().manual_seed(3))
        routes[sampler] = {"calls": calls.get(name, 0), "shape": list(inv.result.samples.shape),
                           "finite": bool(torch.isfinite(inv.result.samples).all())}
    if r == 0:
        with open(os.path.join(out_dir, "routes.json"), "w") as fh:
            json.dump(routes, fh)
    secs["routes"] = time.perf_counter() - t0

    # (i) the dryrun over every family
    from bayesianinferencedl_tpu_torch.parallel.dryrun import dryrun

    fam_secs = dryrun(mesh, log=False)
    if r == 0:
        secs["total"] = time.perf_counter() - t0
        with open(os.path.join(out_dir, "dryrun.json"), "w") as fh:
            json.dump({"families": fam_secs, "seconds": secs}, fh)


def domain_checks(mesh, out_dir: str) -> None:
    """test_torch_domain_sharded.py's ranks: the split-grid solve of the
    affine and the nodal operator at res1 (25 grid rows padded to 32, 8 a
    rank: two ranks interior)."""
    from bayesianinferencedl_tpu_torch.fem.dia_nonaffine import NodalStencilOperator
    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.parallel.domain import solve_fom_domain_sharded

    fin = FiveParamFin.create(resolution=1, dtype=torch.float64, device="cpu")
    k = torch.tensor([0.4, 1.7, 3.1, 0.9, 1.2], dtype=torch.float64)
    u, it = solve_fom_domain_sharded(mesh, fin.op, k, tol=1e-12, maxiter=4000)
    u7, it7 = solve_fom_domain_sharded(mesh, fin.op, k, tol=1e-7)
    nodal = NodalStencilOperator.create(fin.mesh, fin.host, biot=0.1, dtype=torch.float64, device="cpu")
    kn = torch.exp(0.3 + 0.2 * torch.sin(torch.arange(nodal.n, dtype=torch.float64) / 7.0))
    un, itn = solve_fom_domain_sharded(mesh, nodal, kn, tol=1e-12, maxiter=4000)
    every = gather_rows(mesh, u[None], 0)
    if rank_of(mesh) == 0:
        _save(out_dir, "domain", {"u": u.numpy(), "iters": it.numpy(), "u7": u7.numpy(),
                                  "iters7": it7.numpy(), "un": un.numpy(), "iters_n": itn.numpy(),
                                  "kn": kn.numpy(), "same_on_every_rank": np.array(
                                      bool((every == every[0]).all()))})
