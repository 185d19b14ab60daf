#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bayesianinferencedl_tpu_torch) on one
NVIDIA GPU, from the root of a checkout:

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero with no result:

  0. device   require CUDA; print the card's name and power limit
  1. build    compile kernel K1 (csrc/pcg_stencil.cu) with nvcc
  2. K1       the kernel against its plain torch version on the card at res4,
              B = 256 log-uniform conductivities, m = 128, tol 1e-7,
              maxiter 1500: deflated, undeflated and warm-started. Per-sample
              relative L2 difference <= 1e-4, no sample at the cap, the
              deflated solutions within 1e-4 of a float64 direct solve, and
              iteration counts that show the preconditioner is the plain
              version's (see phase_kernel). Kernel and plain times by CUDA
              events, also at the build's batch sizes 1024 and 128
  3. slice    build_pipeline (res4, 256 snapshots, r = 40, 1024 + 128
              training/holdout samples, (64, 64) tanh MLP, 300 epochs) and
              run_inversion (pcn, rom_nn, 1024 chains, 4000 steps, 1000 burn,
              noise 1e-2) on the card; K1 must have been launched, every
              output finite, and the surrogate must lower the training-set
              error below the ROM's. The holdout comparison is printed, not
              gated: at these widths in full fp32 the holdout ROM error is
              only 3.6-12.5x the f32 FOM's own error and three of the 128
              samples carry 45-96% of its square, so whether the surrogate
              lowers it depends on the seed, for the JAX reference as much
              as for the port.

The last three lines are the kernel summary (JSON), the nvidia-smi line,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

TOL = 1e-7
MAXITER = 1500
B_CHECK = 256
REL_GATE = 1e-4
CHECK_EVERY = 16  # K1's convergence-check stride (its default)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed ({smi.returncode}): {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say("device", f"{torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")
    return card


def phase_build():
    from bayesianinferencedl_tpu_torch.ops import _build

    lib = _build.load_library("pcg_stencil")
    log = _build.build_logs.get("pcg_stencil")
    if log is None:
        say("build", f"cached {lib._name} (no nvcc run)")
        return
    say("build", f"pcg_stencil.cu -> sm_90a by nvcc in {log['seconds']:.2f} s")
    for line in log["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            say("build", line.strip())


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def _direct_rel_err(fin, ks: np.ndarray, u: np.ndarray) -> tuple[float, float, float]:
    """max over samples of: ||u - u*|| / ||u*|| against the float64 sparse
    direct solve u*, the f64 relative residual of u, and that residual for
    u* rounded to float32 (the floor any float32 solution sits on)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    As, Mext = fin.host.to_scipy_components()
    mask = sum(A.diagonal() for A in As) > 0
    F = fin.host.F_root
    err = res = floor = 0.0
    for k, ub in zip(ks, u):
        A = sum(float(ki) * Ai for ki, Ai in zip(k, As)) + fin.op.biot * Mext
        A = (A + sp.diags(np.where(mask, 0.0, 1.0))).tocsc()
        us = spla.spsolve(A, F)
        ub = ub.astype(np.float64)
        err = max(err, np.linalg.norm(ub - us) / np.linalg.norm(us))
        res = max(res, np.linalg.norm(F - A @ ub) / np.linalg.norm(F))
        floor = max(floor, np.linalg.norm(F - A @ us.astype(np.float32)) / np.linalg.norm(F))
    return err, res, floor


def phase_kernel():
    import torch

    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    fin = FiveParamFin.create(resolution=4, biot=0.1, device="cuda", cg_tol=TOL, cg_maxiter=MAXITER)
    defl = fin.deflation_basis()
    op = fin.op
    say("K1", f"res4 n={op.n} offsets={op.offsets[4:]} m={defl.m}; fin + deflation basis "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)

    def inputs(B):
        ks_np = np.exp(rng.uniform(np.log(0.1), np.log(10.0), (B, 5)))
        ks = torch.tensor(ks_np, dtype=torch.float32, device="cuda")
        vals4 = K1.upper_planes(op.vals(ks))
        Binv = defl.coarse_inverses(ks, op.biot).contiguous()
        return ks_np, ks, vals4, Binv

    ks_np, ks, vals4, Binv = inputs(B_CHECK)
    offs = op.offsets[4:]
    kw = dict(offsets=offs, tol=TOL, maxiter=MAXITER)
    # warm starts: deflated solutions at conductivities 5% away
    ks_near = ks * 1.05
    x0, _ = K1.pcg_stencil_reference(
        K1.upper_planes(op.vals(ks_near)), op.F_root, None, Wt=defl.Wt_bf16,
        Binv=defl.coarse_inverses(ks_near, op.biot).contiguous(), **kw,
    )
    cases = {
        "deflated": dict(x0=None, Wt=defl.Wt_bf16, Binv=Binv),
        "undeflated": dict(x0=None, Wt=None, Binv=None),
        "warm": dict(x0=x0.contiguous(), Wt=defl.Wt_bf16, Binv=Binv),
    }
    max_abs = 0.0
    iters = {}
    for name, c in cases.items():
        xk, itk = K1.pcg_stencil(vals4, op.F_root, c["x0"], Wt=c["Wt"], Binv=c["Binv"], **kw)
        torch.cuda.synchronize()
        xp, itp = K1.pcg_stencil_reference(vals4, op.F_root, c["x0"], Wt=c["Wt"], Binv=c["Binv"], **kw)
        if not torch.isfinite(xk).all():
            fail(f"K1 {name}: non-finite solution")
        rel = (torch.linalg.norm(xk - xp, dim=1) / torch.linalg.norm(xp, dim=1)).max().item()
        abs_err = (xk - xp).abs().max().item()
        max_abs = max(max_abs, abs_err)
        it, itp = itk.cpu().numpy(), itp.cpu().numpy()
        iters[name] = it
        it_diff = np.abs(it - itp)
        mean_shift = abs(it.mean() / itp.mean() - 1)
        say("K1", f"{name}: max per-sample rel diff vs plain {rel:.3e} (max abs {abs_err:.3e}); "
            f"iters kernel min/median/max {it.min()}/{int(np.median(it))}/{it.max()}, "
            f"plain {itp.min()}/{int(np.median(itp))}/{itp.max()}; per-sample count difference "
            f"max {it_diff.max()}, {int((it_diff > CHECK_EVERY).sum())} samples > {CHECK_EVERY}; "
            f"mean count {it.mean():.2f} vs {itp.mean():.2f}")
        if rel > REL_GATE:
            fail(f"K1 {name}: kernel vs plain relative difference {rel:.3e} > {REL_GATE}")
        if it.max() >= MAXITER:
            fail(f"K1 {name}: {int((it >= MAXITER).sum())} samples hit the {MAXITER}-iteration cap")
        # CG reaches the same x under any SPD preconditioner, so the solution
        # alone cannot show that the preconditioner is right: the iteration
        # counts can. With deflation (<= 48 iterations) they must agree per
        # sample to one check block. Undeflated f32 CG runs 256-448
        # iterations and its residual norm is not monotone near tol, so
        # single samples stop blocks apart under two summation orders; there
        # the batch's mean count must agree to 5%.
        if c["Wt"] is not None and it_diff.max() > CHECK_EVERY:
            fail(f"K1 {name}: iteration counts differ from the plain version's by "
                 f"{it_diff.max()} > {CHECK_EVERY} for some sample")
        if mean_shift > 0.05:
            fail(f"K1 {name}: mean iteration count {it.mean():.2f} vs plain {itp.mean():.2f}")
        if name == "deflated":
            sub = slice(0, 16)
            err, res, floor = _direct_rel_err(fin, ks_np[sub], xk[sub].cpu().numpy())
            say("K1", f"{name}: vs float64 direct solve (16 samples): max rel err {err:.3e}; "
                f"f64 rel residual {res:.3e} (float32-rounded exact solution: {floor:.3e})")
            if err > REL_GATE:
                fail(f"K1 {name}: relative error {err:.3e} against the f64 direct solve > {REL_GATE}")
    for name in ("deflated", "warm"):
        slow = int((2 * iters[name] > iters["undeflated"]).sum())
        if slow:
            fail(f"K1 {name}: {slow} samples took more than half their undeflated iterations")

    times = {}
    for B in (B_CHECK, 1024, 128):
        if B != B_CHECK:
            _, _, vals4, Binv = inputs(B)
        args = dict(Wt=defl.Wt_bf16, Binv=Binv, **kw)
        k_ms = _time_ms(lambda: K1.pcg_stencil(vals4, op.F_root, None, **args), 5)
        p_ms = _time_ms(lambda: K1.pcg_stencil_reference(vals4, op.F_root, None, **args), 3)
        times[B] = (k_ms, p_ms)
        say("K1", f"deflated B={B}: kernel {k_ms:.3f} ms, plain torch {p_ms:.3f} ms per batched solve")
    return max_abs, times


def phase_slice():
    import torch

    from bayesianinferencedl_tpu.config import (
        FEMConfig, MCMCConfig, MeshConfig, PipelineConfig, ROMConfig, SurrogateConfig,
    )
    from bayesianinferencedl_tpu_torch.api import build_pipeline, run_inversion
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K1
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    cfg = PipelineConfig(
        mesh=MeshConfig(resolution=4),
        fem=FEMConfig(biot=0.1, cg_tol=TOL, cg_maxiter=MAXITER),
        rom=ROMConfig(n_snapshots=256, basis_size=40, online_precision="highest"),
        surrogate=SurrogateConfig(hidden=(64, 64), n_train=1024, epochs=300),
        mcmc=MCMCConfig(n_chains=1024, n_steps=4000, n_burn=1000, beta=0.25, noise_sigma=1e-2,
                        likelihood="rom_nn", sampler="pcn"),
    )
    log = MetricsLogger()
    K1.launches = 0
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, device="cuda", metrics=log)
    build_s = time.perf_counter() - t0
    n_build = K1.launches
    inv = run_inversion(pipe, metrics=log)
    torch.cuda.synchronize()
    n_main = K1.launches
    s = log.summary()
    stages = {k: s[k]["seconds"] for k in ("build_fom", "snapshots", "project_rom", "error_dataset",
                                          "train_surrogate", "holdout_eval")}
    say("slice", f"build_pipeline {build_s:.2f} s; stages (s) " + json.dumps(stages))
    say("slice", f"K1 launches: {n_build} in the build, {n_main} in build + inversion")
    hold = s["holdout_rel_err"]
    say("slice", f"rom_rel_err {s['rom_rel_err']['value']:.4e} corrected_rel_err "
        f"{s['corrected_rel_err']['value']:.4e}; holdout rom {hold['rom']:.4e} "
        f"corrected {hold['corrected']:.4e} (corrected below rom: {hold['corrected'] < hold['rom']})")
    res = inv.result
    acc = res.accept_rate.mean().item()
    say("slice", f"pcn rom_nn: {inv.samples_per_sec:.1f} samples/s over {inv.wall_seconds:.3f} s "
        f"({res.samples.shape[0]} kept x {res.samples.shape[1]} chains); accept {acc:.3f}; "
        f"split-rhat max {inv.rhat.max().item():.4f}; ESS bulk min {inv.ess.min().item():.1f}, "
        f"tail min {inv.ess_tail.min().item():.1f}; ppc p {inv.ppc['p_value']:.3f}")
    post = res.samples.mean(dim=(0, 1)).cpu().numpy()
    say("slice", f"posterior mean log k {np.round(post, 4).tolist()} vs truth "
        f"{np.round(inv.theta_true.cpu().numpy(), 4).tolist()}")

    if n_build < 3:
        fail(f"K1 was launched {n_build} times in build_pipeline (expected >= 3)")
    if n_main <= n_build:
        fail("K1 was not launched for the synthetic-truth solve in run_inversion")
    for name, t in (("samples", res.samples), ("phi", res.phi_trace), ("ess", inv.ess),
                    ("ess_tail", inv.ess_tail), ("rhat", inv.rhat), ("data", inv.data)):
        if not torch.isfinite(t).all():
            fail(f"non-finite {name}")
    if tuple(res.samples.shape) != (3000, 1024, 5):
        fail(f"samples shape {tuple(res.samples.shape)}")
    rom_tr, corr_tr = s["rom_rel_err"]["value"], s["corrected_rel_err"]["value"]
    if not corr_tr < rom_tr:
        fail(f"training-set corrected error {corr_tr:.4e} not below ROM error {rom_tr:.4e}")
    if not 0.05 < acc < 0.9:
        fail(f"accept rate {acc:.3f} outside (0.05, 0.9)")
    return n_main


def main() -> None:
    card = phase_device()
    import torch

    phase_build()
    max_abs, times = phase_kernel()
    launches = phase_slice()
    k_ms, p_ms = times[B_CHECK]
    print(json.dumps({"kernels": [{
        "name": "pcg_stencil",
        "route": "cuda",
        "source": "bayesianinferencedl_tpu_torch/csrc/pcg_stencil.cu",
        "replaces": "bayesianinferencedl_tpu/ops/pcg_stencil.py:236",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
