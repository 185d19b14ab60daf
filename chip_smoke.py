#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bayesianinferencedl_tpu_torch) on one
NVIDIA GPU, from the root of a checkout:

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero with no result:

  0. device   require CUDA; print the card's name and power limit
  1. build    compile kernels K1 (csrc/pcg_stencil.cu), K2 (csrc/pcn_fused.cu),
              K3 (csrc/pcg_stencil_tile.cu), K4 (csrc/pcg_stencil_grid.cu), K4r
              (csrc/pcg_stencil_grid_resident.cu), K5 (csrc/shift_cost.cu), K3r
              (csrc/pcg_stencil_tile_mma.cu) and K4c
              (csrc/pcg_stencil_grid_cluster.cu) with nvcc, one process each,
              started together; each one's registers and spills from ptxas
  2. K1       the kernel against its plain torch version on the card at res4,
              B = 256 log-uniform conductivities, m = 128, tol 1e-7,
              maxiter 1500: deflated, undeflated and warm-started. Per-sample
              relative L2 difference <= 1e-4, no sample at the cap, the
              deflated solutions within 1e-4 of a float64 direct solve, and
              iteration counts that show the preconditioner is the plain
              version's (see phase_kernel). Kernel and plain times by CUDA
              events, also at the build's batch sizes 1024 and 128, with
              K3r's time on the same inputs for the record
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
  4. K2       the fused pCN sampler (experimental.pcn_fused) on the slice's
              pipeline, data and noise, cg_iters = pipe.rom_pcg_iters:
              (a) the kernel against its plain torch version on the card,
              1,024 chains x 200 steps (50 burn-in), the plain version
              replaying the uniforms the kernel wrote: the uniforms equal
              the plain Philox stream bit for bit and pass loose moment and
              neighbour-correlation gates; at most 1% of chains accept
              differently; on the others theta and log beta within 1e-4 and
              phi within 1e-3 relative (see phase_k2); (b) the main path,
              run_pcn_fused over 4,000 steps (1,000 burn-in) timed by CUDA
              events after the warm-up of (a), with its launches counted:
              posterior means within 5 Monte-Carlo standard errors (bulk
              ESS of both runs) of run_inversion's pcn, sds within 10%,
              accept rates within 0.02; split-R-hat printed beside pcn's;
              (c) the plain version over the same 4,000 steps, timed.
  5. K3r, K3  the sublanes layout's kernels against their plain torch version
              at res8 (n = 24,960), B = 256, m = 128, tol 1e-7, maxiter 1500.
              First the route: the cluster size tile_cluster gives for the
              batches this phase and the slice send, the shared memory a K3r
              block asks for, how many clusters of each size the card holds
              at once (the capacity tile_cluster reads), and K3r's registers
              and spills from ptxas. K3r (through pcg_stencil_tile) and K3
              (through its launcher), each on the same three cases: deflated
              cold (x0 = None, the da_pcn case), undeflated cold, deflated
              warm. No sample at the cap; deflated counts within 16 of the
              plain version's per sample, undeflated means within 5%;
              deflated runs under half their undeflated iterations; against a
              float64 direct solve (8 samples) within 1e-4, or within 1.5x
              the plain version's own error where f32 CG cannot reach 1e-4
              (printed with the reason); kernel vs plain per sample within
              the plain version's own error against the direct solve. Smaller
              batches on K3r (deflated cold at B = 1, 250 and 128, deflated
              warm at 250: the masked last tile and the holdout's batch)
              against the plain version with the same per-sample gates. Times
              at B = 256 and 1,024 for K3r, K3, K1 on the same inputs (for
              the record) and the plain version, with each kernel's count
              mean, least-work bound, share of it and streaming floor; K3r's
              output there under the per-case gates, and at 1,024 (the
              only batch on clusters of 1) against the direct solve too. A
              sweep of K3r over the cluster sizes at B = 1,024, 256, 128 and
              32 beside tile_cluster's pick (printed). Then res16 (n =
              99,072), K3r's other route: deflated cold at B = 32 against the
              plain version under the same gates and against the direct solve
              on 2 samples; K3r, K3 and the plain version timed at B = 256,
              K3r's output there under the per-case gates
  6. DA       build_pipeline at res8 with phase 3's widths, then
              run_inversion(da_pcn, fom): 1,024 chains, subchains of 64
              rom_nn pCN steps, noise 1e-2, 100 outer steps (30 burn-in; the
              reference bench runs 500 / 150). K3r must carry every FOM solve
              (>= 3 launches in the build, >= 101 in the run), K3 and K1 none;
              outputs finite, samples (70, 1024, 5), outer accept > 0.6, inner
              accept in (0.05, 0.9), no audited state at the iteration cap.
              Prints stage seconds, ESS/s, outer steps/s, split-R-hat against
              the reference's 1.05 gate, the posterior mean against the truth
              and the share of a batched fine solve in the outer step, with
              its coarse inverses and K3r timed apart on the same states.

  7. K4r, K4  the single layout's two kernels against the plain torch version
              at res32 (769 x 513 grid, padded to 776 x 640), tol 1e-7, the
              reference CLI's cap max(480, 120 res) = 3,840. First the route:
              grid_route's answer for this grid and card, the bytes a block
              needs (the Python count and the kernel's own, which must agree)
              and K4r's registers from ptxas. K4r, through pcg_stencil_grid,
              at B = 32 cold, B = 32 warm (x0 = the plain version's solutions
              at conductivities 5% away) and B = 1; K4, through its launcher,
              at B = 32 cold on the same inputs. Each: no cold sample at the
              cap; on the 2 samples a float64 direct solve covers, the kernel
              within max(1e-4, 1.5x the plain version's error) of the direct
              solve and a per-sample relative L2 gap from the plain version
              no larger than the plain version's own error (the reasons are
              printed); on every sample a gap below 1e-3; mean counts within
              5% of the plain version's; the warm batch's mean count under the
              cold one's. K4r vs K4 per sample printed. At B = 256 and 64 (the
              CLI's batches) K4r and the plain version are timed by CUDA events
              on the same inputs and held to the same per-sample 1e-3 gap and
              5% mean counts, with both count spreads, how many solves hit the
              cap (printed, not gated: the cap is the reference's own) and
              K4r's time per CG iteration; K4 and K4c (through its launcher,
              its own cluster size; not routed here) are timed beside K4r at
              B = 64, K4c twice (its first launch, then the one recorded)
              under the same per-sample 1e-3 gap and 5% mean counts, with
              its streaming floor.
              K4r alone on one cold sample, timed, and its floor: the same
              launch on one 8-cell row per block, 4 samples of the 5-point
              Laplacian at tol 0 (at least 1,000 iterations in all)
  8. FOM CLI  cli.main in-process at --resolution 32: fom, snapshots --n 256,
              rom --n-snapshots 256 --r 40; then snapshots --resolution 40 --n
              256 (the reference CLI's default n), a grid whose strips outgrow
              the card's shared memory. Each with the launch counts set to 0
              before it and read after: K4r carries every batched solve at
              res32 (>= 1 launch for snapshots, >= 2 for rom) and K4c every one
              at res40 (>= 1), the other kernels none (K4 included),
              and no deflation basis is built; JSON lines finite, the fom QoI
              positive with 5 entries; rom's rel_err_vs_fom < 0.1; solves/s
              printed. The fom k is also solved by K4r, its plain version and
              the fom command's flat loop with its matvec summed diagonal
              first: K4r's QoI within 1e-4 of the plain version's, and each of
              the four QoIs within 1e-3 of the float64 direct solve's (the
              readings and which plain solve is the outlier are printed).
  9. K4c      the single layout's kernel past K4r's reach at the shapes of that
              res40 sweep (961 x 641 grid padded to 968 x 768, cap 4,800): the
              route, K4c's shared memory (the Python count and the kernel's
              own, which must agree), how many clusters of 1-16 blocks the card
              holds and grid_cluster's pick for B = 1, 8, 64, 256. One set of
              256 conductivities; B = 8 and 64 are its first samples. K4c
              through pcg_stencil_grid at B = 8 against the plain version
              (every per-sample gap < 1e-3, mean counts within 5%, no sample
              at the cap that the plain version does not also hit); sample 0
              against a float64 direct solve (within max(1e-4, 1.5x the plain
              version's error)); one cold sample alone, its count equal to the
              B = 8 run's where grid_cluster picks one size for both; K4
              through its launcher at B = 8 under the same gates; K4c against
              K4 at B = 64 (gap < 1e-3, mean counts within 5%); K4c at B = 256,
              its first 8 samples under the B = 8 gates. Every run timed by
              CUDA events with its least-work bound and streaming floor (K4c
              68 B a true node, K4 80 B a padded cell). Then every cluster
              size at B = 8 and 64 (gap < 1e-3 from the plain run or the
              pick's), and whether grid_cluster's pick was the fastest
 10. K5       the shift-cost probe at res8, B = 64, tile 8, 256 iterations: with
              the shifts on A's planes, without them on |A|'s (a CG of an SPD
              diagonal operator; on A's own planes its values are set by
              rounding, see experimental/shift_cost.py), each against the
              plain version within max(1e-4, 3x the plain float32 run's gap
              from its float64 run), reason printed; then its entry point,
              shift_cost.main(["8", "8"]), counted, with the per-tile-iteration
              times of both variants, their gap and K3's time per iteration
              at res8 from phase 5 beside them

The last three lines are the kernel summary (JSON: time, launches, bound,
plain time of each kernel), the nvidia-smi line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
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


KERNEL_SOURCES = ("pcg_stencil", "pcn_fused", "pcg_stencil_tile", "pcg_stencil_grid",
                  "pcg_stencil_grid_resident", "shift_cost", "pcg_stencil_tile_mma")

# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit)
PEAK_F32 = 67e12  # FLOP/s on the CUDA cores
PEAK_BF16 = 989e12  # FLOP/s on the tensor cores
PEAK_HBM = 3.35e12  # bytes/s


def phase_build():
    from bayesianinferencedl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.load_libraries(*KERNEL_SOURCES)
    say("build", f"{len(libs)} kernels ready in {time.perf_counter() - t0:.2f} s")
    for name, lib in zip(KERNEL_SOURCES, libs):
        log = _build.build_logs.get(name)
        if log is None:
            say("build", f"cached {lib._name} (no nvcc run)")
            continue
        say("build", f"{name}.cu -> sm_90a by nvcc in {log['seconds']:.2f} s")
        for line in log["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                say("build", line.strip())


def _bound(nbytes: float, f32_ops: float, bf16_ops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_HBM
    t_ops = f32_ops / PEAK_F32 + bf16_ops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def _k1_bound(B: int, n: int, m: int, iters: np.ndarray) -> tuple[float, str]:
    """K1's bound for one deflated batch with these per-sample iteration
    counts (each sample also does one setup residual and preconditioner).
    Per iteration and sample: the 4-plane stencil (13 n), the two dots, three
    vector updates, the Jacobi scaling and rr (~13 n), the coarse solve
    Binv y (2 m^2, float32), and the two deflation products Wt bf16(r) and
    Wt^T bf16(c) (2 m n each): bf16 operands with float32 sums, the tensor
    cores' type. Bytes: vals4, F, Wt, Binv read once, x and iters written."""
    its = float(np.sum(iters + 1))
    f32 = its * (26 * n + 2 * m * m)
    bf16 = its * 4 * m * n
    nbytes = 4 * (4 * B * n + n + B * m * m + B * n + B) + 2 * m * n
    return _bound(nbytes, f32, bf16)


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


def _direct_rel_err(fin, ks: np.ndarray, u: np.ndarray) -> tuple[np.ndarray, np.ndarray, float]:
    """Per sample: ||u - u*|| / ||u*|| against the float64 sparse direct
    solve u*, and the f64 relative residual of u; and the max over samples
    of that residual for u* rounded to float32 (the floor any float32
    solution sits on)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    As, Mext = fin.host.to_scipy_components()
    mask = sum(A.diagonal() for A in As) > 0
    F = fin.host.F_root
    err, res, floor = [], [], 0.0
    for k, ub in zip(ks, u):
        A = sum(float(ki) * Ai for ki, Ai in zip(k, As)) + fin.op.biot * Mext
        A = (A + sp.diags(np.where(mask, 0.0, 1.0))).tocsc()
        us = spla.spsolve(A, F)
        ub = ub.astype(np.float64)
        err.append(np.linalg.norm(ub - us) / np.linalg.norm(us))
        res.append(np.linalg.norm(F - A @ ub) / np.linalg.norm(F))
        floor = max(floor, np.linalg.norm(F - A @ us.astype(np.float32)) / np.linalg.norm(F))
    return np.array(err), np.array(res), floor


def _direct_qoi(fin, k: np.ndarray) -> np.ndarray:
    """The QoI of the float64 sparse direct solve at conductivities k."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    As, Mext = fin.host.to_scipy_components()
    mask = sum(A.diagonal() for A in As) > 0
    A = sum(float(ki) * Ai for ki, Ai in zip(k, As)) + fin.op.biot * Mext
    A = (A + sp.diags(np.where(mask, 0.0, 1.0))).tocsc()
    return fin.host.qoi @ spla.spsolve(A, fin.host.F_root)


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
            err, res = err.max(), res.max()
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
        # the sublanes layout's kernel (K3r) on K1's inputs, for the record:
        # the K1/K3r split (LANES_MAX_N) is the JAX package's layout rule, and
        # these times say where it sits
        k3_ms = _time_ms(lambda: K1.pcg_stencil_tile(vals4, op.F_root, None, **args), 5)
        say("K1", f"deflated B={B}: kernel {k_ms:.3f} ms, plain torch {p_ms:.3f} ms per batched "
            f"solve; K3r on the same inputs {k3_ms:.3f} ms (cluster of {_cluster(B)}; for the "
            f"record)")
    bound = _k1_bound(B_CHECK, op.n, defl.m, iters["deflated"])
    say("K1", f"deflated B={B_CHECK}: bound {bound[0]:.4f} ms ({bound[1]}), kernel at "
        f"{100 * bound[0] / times[B_CHECK][0]:.2f}% of it")
    return max_abs, times, bound


def phase_slice():
    import torch

    from bayesianinferencedl_tpu_torch.config import (
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
    return n_main, cfg, pipe, inv


K2_SEED = 1234
K2_CHECK_STEPS, K2_CHECK_BURN = 200, 50
K2_FLIP_GATE = 0.01  # share of chains whose accept sequences may differ
K2_STATE_GATE = 1e-4  # |d theta|, |d log beta| on the chains that agree
K2_PHI_GATE = 1e-3  # |d phi| / max(|phi|, 1) on the chains that agree
K2_MEAN_GATE = 5.0  # posterior-mean difference, in Monte-Carlo standard errors
K2_SD_GATE = 0.10  # relative posterior-sd difference
K2_ACC_GATE = 0.02  # accept-rate difference


def _corr(a, b) -> float:
    a, b = a.flatten().double(), b.flatten().double()
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / (a.norm() * b.norm()))


def _k2_bound(C: int, T: int, r: int, d: int, m: int, h1: int, h2: int,
              cg: int) -> tuple[float, str]:
    """K2's bound for C chains and T steps: the least work of the function,
    whatever the formulation. One misfit per chain and step (plus the
    initial one), each: A(k) = Bi M + sum_j k_j A_j assembled once (d FMAs
    per entry, 2 d r^2), cg + 1 products A(k) p (2 r^2), cg + 1 products by
    P0 (2 r^2; P0 fhat is one vector for the whole run), ~10 r of dots and
    updates per iteration, y = x Bhat^T for the m observables and the MLP;
    all float32 on the CUDA cores. Bytes: theta0 and the operands read
    once, the (T, C, 8) trace written once."""
    misfit = (2 * d * r * r + (cg + 1) * 4 * r * r + cg * 10 * r + 3 * r + 2 * m * r
              + 2 * (d * h1 + h1 * h2 + h2 * m))
    operands = 7 * r * r + 9 * r + 9 * h1 + h1 * h2 + 9 * h2 + 32
    return _bound(4 * (C * 8 + operands + T * C * 8), C * (T + 1) * float(misfit))


def phase_k2(cfg, pipe, inv):
    import torch

    from bayesianinferencedl_tpu_torch.experimental import pcn_fused as K2
    from bayesianinferencedl_tpu_torch.infer.diagnostics import ess_bulk, split_rhat

    mc = cfg.mcmc
    C, T, NB = mc.n_chains, mc.n_steps, mc.n_burn
    cg = pipe.rom_pcg_iters
    gen = torch.Generator(device="cuda").manual_seed(mc.seed + 2)
    theta0 = pipe.prior.sample(gen, (C,))
    args = (pipe.rom, pipe.P0, pipe.surrogate.params, pipe.surrogate.norm, pipe.prior, inv.data,
            mc.noise_sigma, theta0)
    ops = K2.pack_operands(*args, mc.beta)
    r, (h1, h2) = ops.astack.shape[0], ops.w2.shape
    say("K2", f"C={C} r={r} h=({h1}, {h2}) cg_iters={cg} d={ops.d}")

    # (a) the kernel against the plain version on the uniforms it drew
    rk = K2.run_pcn_fused(*args, K2_SEED, n_steps=K2_CHECK_STEPS, n_burn=K2_CHECK_BURN,
                          beta=mc.beta, cg_iters=cg, return_uniforms=True)
    torch.cuda.synchronize()
    u1, u2 = rk.uniforms
    tp, _ = K2.pcn_fused_reference(ops, n_steps=K2_CHECK_STEPS, n_burn=K2_CHECK_BURN,
                                   cg_iters=cg, uniforms=(u1, u2))
    tk = rk.trace
    if not (torch.isfinite(tk).all() and torch.isfinite(tp).all()):
        fail("K2: non-finite trace")
    philox = [K2.philox_uniforms(K2_SEED, t, C, device="cuda") for t in range(K2_CHECK_STEPS)]
    same = torch.equal(torch.stack([a for a, _ in philox]), u1) and torch.equal(
        torch.stack([b for _, b in philox]), u2)
    u = torch.cat([u1, u2], -1)  # (T, C, 16)
    u_mean, u_var = float(u.double().mean()), float(u.double().var())
    c_chain, c_step = _corr(u[:, :-1], u[:, 1:]), _corr(u[:-1], u[1:])
    say("K2", f"uniforms: equal to the plain Philox stream: {same}; mean {u_mean:.6f} "
        f"(1/2), var {u_var:.6f} (1/12 = {1 / 12:.6f}), corr neighbouring chains {c_chain:.2e}, "
        f"neighbouring steps {c_step:.2e}")
    if not same:
        fail("K2: the kernel's uniforms differ from the plain Philox4x32-10 stream")
    if abs(u_mean - 0.5) > 0.01 or abs(u_var - 1 / 12) > 0.005 or max(abs(c_chain), abs(c_step)) > 0.01:
        fail("K2: the uniforms fail the moment or correlation gates")
    flips = (tk[:, :, 7] != tp[:, :, 7]).any(0)
    agree = ~flips
    d = (tk[:, agree] - tp[:, agree]).abs()
    d_theta = float(d[..., :ops.d].max())
    d_lbeta = float(d[..., 6].max())
    d_phi = float((d[..., 5] / tp[:, agree, 5].abs().clamp(min=1.0)).max())
    max_abs = float(d.max())
    say("K2", f"kernel vs plain, {C} chains x {K2_CHECK_STEPS} steps: chains whose accept "
        f"sequences differ {int(flips.sum())} ({100 * float(flips.float().mean()):.2f}%); on the "
        f"others max |d theta| {d_theta:.3e}, |d log beta| {d_lbeta:.3e}, rel |d phi| "
        f"{d_phi:.3e}, max abs {max_abs:.3e}; accept {float(tk[K2_CHECK_BURN:, :, 7].mean()):.4f} "
        f"vs {float(tp[K2_CHECK_BURN:, :, 7].mean()):.4f}")
    if float(flips.float().mean()) > K2_FLIP_GATE:
        fail(f"K2: {int(flips.sum())} chains accept differently from the plain version")
    if max(d_theta, d_lbeta) > K2_STATE_GATE or d_phi > K2_PHI_GATE:
        fail("K2: kernel and plain states differ beyond the gates")

    # (b) the main path: run_pcn_fused over the whole run, counted and timed
    K2.launches = 0
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    res = K2.run_pcn_fused(*args, K2_SEED + 1, n_steps=T, n_burn=NB, beta=mc.beta, cg_iters=cg)
    e1.record()
    e1.synchronize()
    launches = K2.launches
    k_ms = e0.elapsed_time(e1)
    eager_us = inv.wall_seconds / T * 1e6
    n_kept = (T - NB) * C
    say("K2", f"run_pcn_fused {T} steps ({NB} burn-in) x {C} chains: {k_ms:.3f} ms, "
        f"{k_ms / T * 1e3:.3f} us/step, {n_kept / (k_ms / 1e3):.1f} kept samples/s, launches "
        f"{launches}; the eager pcn step of run_inversion in this call: {eager_us:.3f} us/step, "
        f"{inv.samples_per_sec:.1f} samples/s")
    if launches < 1:
        fail("K2 was not launched on the main path")
    if not (torch.isfinite(res.samples).all() and torch.isfinite(res.phi_trace).all()):
        fail("K2: non-finite samples")
    if tuple(res.samples.shape) != (T - NB, C, ops.d):
        fail(f"K2 samples shape {tuple(res.samples.shape)}")
    ref = inv.result.samples
    means, sds, ses, rhats = [], [], [], []
    for x in (res.samples, ref):
        flat = x.reshape(-1, x.shape[-1]).double()
        means.append(flat.mean(0))
        sds.append(flat.std(0))
        ses.append(sds[-1] / ess_bulk(x).double().sqrt())
        rhats.append(float(split_rhat(x).max()))
    z = ((means[0] - means[1]).abs() / (ses[0] ** 2 + ses[1] ** 2).sqrt()).cpu().numpy()
    sd_rel = ((sds[0] - sds[1]).abs() / sds[1]).cpu().numpy()
    acc_k, acc_p = float(res.accept_rate.mean()), float(inv.result.accept_rate.mean())
    say("K2", f"posterior mean K2 {np.round(means[0].cpu().numpy(), 4).tolist()} vs pcn "
        f"{np.round(means[1].cpu().numpy(), 4).tolist()}; |diff| / MCSE "
        f"{np.round(z, 2).tolist()}")
    say("K2", f"posterior sd K2 {np.round(sds[0].cpu().numpy(), 4).tolist()} vs pcn "
        f"{np.round(sds[1].cpu().numpy(), 4).tolist()}; accept {acc_k:.4f} vs {acc_p:.4f}; "
        f"split-rhat max {rhats[0]:.4f} vs {rhats[1]:.4f}")
    if z.max() > K2_MEAN_GATE:
        fail(f"K2: posterior means {z.max():.2f} Monte-Carlo errors from pcn's")
    if sd_rel.max() > K2_SD_GATE:
        fail(f"K2: posterior sd {100 * sd_rel.max():.1f}% from pcn's")
    if abs(acc_k - acc_p) > K2_ACC_GATE:
        fail(f"K2: accept rate {acc_k:.4f} vs pcn {acc_p:.4f}")

    # (c) the plain version over the same run
    e0.record()
    K2.pcn_fused_reference(ops, n_steps=T, n_burn=NB, cg_iters=cg, seed=K2_SEED + 1)
    e1.record()
    e1.synchronize()
    p_ms = e0.elapsed_time(e1)
    bound = _k2_bound(C, T, r, ops.d, pipe.rom.Bhat.shape[0], h1, h2, cg)
    say("K2", f"plain torch version over the same {T} steps: {p_ms:.3f} ms; bound "
        f"{bound[0]:.3f} ms ({bound[1]}), kernel at {100 * bound[0] / k_ms:.2f}% of it")
    return dict(launches=launches, max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms, bound=bound)


K3_RES = 8
K3_DIRECT = 8  # samples held against the float64 direct solve
K3_BATCHES = (B_CHECK, 1024)


def _cluster(B: int, m: int = 128) -> int:
    """The cluster size K3r launches a batch of B with on this card, for a
    coarse space of m (the wrapper's own choice)."""
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    return K.tile_cluster(B, K.tile_capacity(m, 0))


def _stream_floor(bytes_per: int, n: int, iters: np.ndarray) -> float:
    """A streaming kernel's floor (ms): the bytes its design moves per node
    (or cell), sample and iteration, times n and the batch's sum(iters + 1),
    over HBM's rate. K3 moves ~76 B a node, K3r 64 B, K4 ~80 B a padded
    cell, K4c 68 B a true node (their sources' notes)."""
    return bytes_per * n * float(np.sum(iters + 1)) / PEAK_HBM * 1e3


K3_BYTES, K3R_BYTES = 76, 64
K4_BYTES, K4C_BYTES = 80, 68


def _k3_gates(tag, name, xk, itk, xp, itp, deflated):
    """Phase 5's per-case gates (PERF.md Findings): no sample at the cap; the
    counts show the preconditioner is the plain version's, per sample to one
    check block when deflated, the batch mean to 5% undeflated, where f32
    CG's residual is not monotone near tol. Returns (per-sample rel diffs,
    max abs diff, kernel counts)."""
    import torch

    if not torch.isfinite(xk).all():
        fail(f"{tag} {name}: non-finite solution")
    rel_s = (torch.linalg.norm(xk - xp, dim=1) / torch.linalg.norm(xp, dim=1)).cpu().numpy()
    abs_err = (xk - xp).abs().max().item()
    it, itp = itk.cpu().numpy(), itp.cpu().numpy()
    it_diff = np.abs(it - itp)
    mean_shift = abs(it.mean() / itp.mean() - 1)
    say(tag, f"{name}: per-sample rel diff vs plain max {rel_s.max():.3e} median "
        f"{np.median(rel_s):.3e} (max abs {abs_err:.3e}); iters kernel min/median/max "
        f"{it.min()}/{int(np.median(it))}/{it.max()}, plain {itp.min()}/{int(np.median(itp))}/"
        f"{itp.max()}; per-sample count difference max {it_diff.max()}, "
        f"{int((it_diff > CHECK_EVERY).sum())} samples > {CHECK_EVERY}; mean count "
        f"{it.mean():.2f} vs {itp.mean():.2f}")
    if it.max() >= MAXITER or itp.max() >= MAXITER:
        fail(f"{tag} {name}: {int((it >= MAXITER).sum())} kernel and {int((itp >= MAXITER).sum())} "
             f"plain samples hit the {MAXITER}-iteration cap")
    if deflated and it_diff.max() > CHECK_EVERY:
        fail(f"{tag} {name}: iteration counts differ from the plain version's by "
             f"{it_diff.max()} > {CHECK_EVERY} for some sample")
    if mean_shift > 0.05:
        fail(f"{tag} {name}: mean iteration count {it.mean():.2f} vs plain {itp.mean():.2f}")
    return rel_s, abs_err, it


def _k3_direct(tag, name, fin, ks_np, xk, xp, rel_s, n_direct, res):
    """The deflated cold case against the float64 direct solve: the kernel
    within max(REL_GATE, 1.5x the plain version's error), and kernel vs plain
    within the plain version's own error. Returns that error."""
    sub = slice(0, n_direct)
    err_k, res_k, floor = _direct_rel_err(fin, ks_np[sub], xk[sub].cpu().numpy())
    err_p, _, _ = _direct_rel_err(fin, ks_np[sub], xp[sub].cpu().numpy())
    say(tag, f"{name}: vs float64 direct solve ({n_direct} samples): kernel max rel err "
        f"{err_k.max():.3e}, plain {err_p.max():.3e}; f64 rel residual {res_k.max():.3e} "
        f"(float32-rounded exact solution: {floor:.3e}); kernel vs plain on these samples "
        f"{np.round(rel_s[sub], 8).tolist()}, plain vs direct {np.round(err_p, 8).tolist()}")
    gate = REL_GATE
    if 1.5 * err_p.max() > REL_GATE:
        gate = 1.5 * err_p.max()
        say(tag, f"accuracy gate {gate:.3e} = 1.5 x the plain version's own error: f32 CG "
            f"at res{res} does not reach {REL_GATE:g} against the direct solve")
    if err_k.max() > gate:
        fail(f"{tag} {name}: relative error {err_k.max():.3e} against the f64 direct solve > {gate:.3e}")
    if rel_s.max() > err_p.max():
        fail(f"{tag} {name}: kernel vs plain {rel_s.max():.3e} exceeds the plain version's own "
             f"error against the direct solve, {err_p.max():.3e}")
    return err_p.max()


def _k3_setup(res):
    import torch

    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    t0 = time.perf_counter()
    fin = FiveParamFin.create(resolution=res, biot=0.1, device="cuda", cg_tol=TOL, cg_maxiter=MAXITER)
    defl = fin.deflation_basis()
    op = fin.op
    say("K3r", f"res{res} n={op.n} offsets={op.offsets[4:]} m={defl.m}; fin + deflation basis "
        f"{time.perf_counter() - t0:.2f} s; solve_fom_stencil takes layout "
        f"{K.layout_for(op.n)} (K1 up to n = {K.LANES_MAX_N})")
    if K.layout_for(op.n) != "sublanes":
        fail(f"solve_fom_stencil does not route n = {op.n} to the sublanes layout")
    rng = np.random.default_rng(0)

    def inputs(B):
        ks_np = np.exp(rng.uniform(np.log(0.1), np.log(10.0), (B, 5)))
        ks = torch.tensor(ks_np, dtype=torch.float32, device="cuda")
        return ks_np, ks, K.upper_planes(op.vals(ks)), defl.coarse_inverses(ks, op.biot).contiguous()

    return fin, defl, op, inputs


def _k3_times(tag, fin, op, defl, inputs, batches, kw, with_k1, n_direct, res):
    """K3r, K3 (and K1 where asked) and the plain version on the same
    deflated cold inputs, each with its count mean, least-work bound, share
    and streaming floor. K3r's output at each batch is held against the
    plain version's under the per-case gates, and on ``n_direct`` samples
    against the float64 direct solve (B = 1,024 is the only batch that runs
    on clusters of 1). Returns (times, K3r's max abs diff from the plain)."""
    import torch

    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    k3 = lambda v, Bi: K._launch("pcg_stencil_tile", v, op.F_root, None, tol=TOL, Wt=defl.Wt_bf16,
                                 Binv=Bi, offsets=kw["offsets"], maxiter=MAXITER, check_every=CHECK_EVERY)
    times, max_abs = {}, 0.0
    for B in batches:
        ks_np, _, vals4, Binv = inputs(B)
        args = dict(Wt=defl.Wt_bf16, Binv=Binv, **kw)
        x_r, it_r = K.pcg_stencil_tile(vals4, op.F_root, None, **args)
        torch.cuda.synchronize()
        c = _cluster(B)
        name = f"deflated cold B={B} (cluster of {c})"
        xp, itp = K.pcg_stencil_reference(vals4, op.F_root, None, **args)
        rel_s, abs_err, _ = _k3_gates(tag, name, x_r, it_r, xp, itp, True)
        max_abs = max(max_abs, abs_err)
        if n_direct:
            _k3_direct(tag, name, fin, ks_np, x_r, xp, rel_s, n_direct, res)
        del x_r, xp
        _, it_3 = k3(vals4, Binv)
        r_ms = _time_ms(lambda: K.pcg_stencil_tile(vals4, op.F_root, None, **args), 5)
        k3_ms = _time_ms(lambda: k3(vals4, Binv), 5)
        k1_ms = _time_ms(lambda: K.pcg_stencil(vals4, op.F_root, None, **args), 3) if with_k1 else None
        p_ms = _time_ms(lambda: K.pcg_stencil_reference(vals4, op.F_root, None, **args), 3)
        rec = dict(ms=r_ms, k3_ms=k3_ms, k1_ms=k1_ms, plain_ms=p_ms, cluster=c)
        for key, it, nbytes in (("", it_r, K3R_BYTES), ("k3_", it_3, K3_BYTES)):
            it = it.cpu().numpy()
            rec[key + "bound"] = _k1_bound(B, op.n, defl.m, it)
            rec[key + "floor"] = _stream_floor(nbytes, op.n, it)
            rec[key + "iters_mean"] = float(it.mean())
        times[B] = rec
        k1 = f", K1 {k1_ms:.3f} ms (for the record)" if with_k1 else ""
        say(tag, f"deflated cold B={B}: K3r {r_ms:.3f} ms (cluster of {c}), K3 {k3_ms:.3f} ms{k1}, "
            f"plain torch {p_ms:.3f} ms per batched solve")
        for name, key, ms, nbytes in (("K3r", "", r_ms, K3R_BYTES), ("K3", "k3_", k3_ms, K3_BYTES)):
            bound, floor = rec[key + "bound"], rec[key + "floor"]
            say(tag, f"  {name}: mean count {rec[key + 'iters_mean']:.2f}; least-work bound "
                f"{bound[0]:.4f} ms ({bound[1]}), {100 * bound[0] / ms:.2f}% of it; streaming floor "
                f"({nbytes} B per node, sample and iteration) {floor:.3f} ms, "
                f"{100 * floor / ms:.1f}% of it")
    return times, max_abs


K3_SWEEP = (1024, 256, 128, 32)  # the batches of phase 5's cluster sweep


def _k3_sweep(op, defl, inputs, kw):
    """K3r at every cluster size for the batches in K3_SWEEP (deflated
    cold, CUDA events, the mean of 3 after a warm-up), beside the size
    tile_cluster picks. Printed, not gated: it shows whether the rule on
    the card's cluster capacity picks the fastest size."""
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    sweep = {}
    for B in K3_SWEEP:
        _, _, vals4, Binv = inputs(B)
        ms = {c: _time_ms(lambda: K._launch_tile_mma(vals4, op.F_root, None, Wt=defl.Wt_bf16, Binv=Binv,
                                                     check_every=CHECK_EVERY, cluster=c, **kw), 3)
              for c in K.TILE_CLUSTERS}
        pick, best = _cluster(B), min(ms, key=ms.get)
        sweep[B] = ms
        say("K3r", f"cluster sweep B={B}: " + ", ".join(f"c={c} {t:.3f} ms" for c, t in ms.items())
            + f"; tile_cluster picks {pick}, the fastest is {best}"
            + ("" if pick == best else f" (the pick {100 * (ms[pick] / ms[best] - 1):.1f}% slower)"))
    return sweep


def phase_k3():
    """K3r (csrc/pcg_stencil_tile_mma.cu, the sublanes layout's kernel on the
    main path) and K3 (csrc/pcg_stencil_tile.cu, beside it) against their
    plain version at res8, then K3r at res16."""
    import torch

    from bayesianinferencedl_tpu_torch.ops import _build
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    fin, defl, op, inputs = _k3_setup(K3_RES)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    lib = _build.load_library("pcg_stencil_tile_mma")
    lib.pcg_stencil_tile_mma_smem_bytes.restype = ctypes.c_int
    lib.pcg_stencil_tile_mma_smem_bytes.argtypes = [ctypes.c_int]
    held, held0 = K.tile_capacity(defl.m, 0), K.tile_capacity(0, 0)
    say("K3r", f"route: {n_sm} SMs; tile_cluster(B, capacity) = "
        + ", ".join(f"{B}: {_cluster(B)}" for B in (1024, 256, 250, 128, 32, 1))
        + f" deflated, {_cluster(B_CHECK, 0)} undeflated at B={B_CHECK}"
        + "; nodes a block owns: " + ", ".join(
            f"c={c}: {min(b - a for a, b in K.tile_ranges(op.n, c))}-"
            f"{max(b - a for a, b in K.tile_ranges(op.n, c))}" for c in K.TILE_CLUSTERS)
        + f"; {lib.pcg_stencil_tile_mma_smem_bytes(defl.m)} B of shared memory a block; clusters "
        f"the card holds at once (cudaOccupancyMaxActiveClusters): "
        + ", ".join(f"c={c}: {v}" for c, v in held.items())
        + f" ({lib.pcg_stencil_tile_mma_smem_bytes(0)} B and "
        + ", ".join(f"{v}" for v in held0.values()) + " undeflated)")
    if min(held.values()) < 1 or min(held0.values()) < 1:
        fail("K3r: the card holds no cluster of some size")
    for line in _build.build_logs.get("pcg_stencil_tile_mma", {}).get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            say("K3r", f"ptxas: {line.strip()}")

    ks_np, ks, vals4, Binv = inputs(B_CHECK)
    kw = dict(offsets=op.offsets[4:], tol=TOL, maxiter=MAXITER)
    ks_near = ks * 1.05  # warm starts: deflated solutions at conductivities 5% away
    x0, _ = K.pcg_stencil_reference(
        K.upper_planes(op.vals(ks_near)), op.F_root, None, Wt=defl.Wt_bf16,
        Binv=defl.coarse_inverses(ks_near, op.biot).contiguous(), **kw,
    )
    cases = {
        "deflated cold": dict(x0=None, Wt=defl.Wt_bf16, Binv=Binv),
        "undeflated cold": dict(x0=None, Wt=None, Binv=None),
        "deflated warm": dict(x0=x0.contiguous(), Wt=defl.Wt_bf16, Binv=Binv),
    }
    kernels = {
        "K3r": lambda v, x0, Wt, Binv: K.pcg_stencil_tile(v, op.F_root, x0, Wt=Wt, Binv=Binv, **kw),
        "K3": lambda v, x0, Wt, Binv: K._launch("pcg_stencil_tile", v, op.F_root, x0, Wt=Wt, Binv=Binv,
                                                check_every=CHECK_EVERY, **kw),
    }
    max_abs = {"K3r": 0.0, "K3": 0.0}
    full = {}
    rel_gate = None
    for name, c in cases.items():
        xp, itp = K.pcg_stencil_reference(vals4, op.F_root, c["x0"], Wt=c["Wt"], Binv=c["Binv"], **kw)
        for tag, kern in kernels.items():
            xk, itk = kern(vals4, c["x0"], c["Wt"], c["Binv"])
            torch.cuda.synchronize()
            if tag == "K3r":
                m_c = 0 if c["Wt"] is None else defl.m
                say(tag, f"{name} B={B_CHECK}: cluster of {_cluster(B_CHECK, m_c)}")
            rel_s, abs_err, it = _k3_gates(tag, name, xk, itk, xp, itp, c["Wt"] is not None)
            max_abs[tag] = max(max_abs[tag], abs_err)
            full[tag, name] = (xk, it)
            if name == "deflated cold":
                err_p = _k3_direct(tag, name, fin, ks_np, xk, xp, rel_s, K3_DIRECT, K3_RES)
                rel_gate = err_p if tag == "K3r" else rel_gate
    for tag in kernels:
        for name in ("deflated cold", "deflated warm"):
            slow = int((2 * full[tag, name][1] > full[tag, "undeflated cold"][1]).sum())
            if slow:
                fail(f"{tag} {name}: {slow} samples took more than half their undeflated iterations")

    # smaller batches, held against the plain version with the per-sample
    # gates of the full-tile cases: the masked last tile (batches that are not
    # a multiple of the tile's 8 samples, as the synthetic-truth solve B = 1
    # sends) and the holdout's 128, which the card runs on clusters of 4
    for B, name in ((1, "deflated cold"), (250, "deflated cold"), (250, "deflated warm"),
                    (128, "deflated cold")):
        c = cases[name]
        v = vals4[:B].contiguous()
        x0_b = None if c["x0"] is None else c["x0"][:B].contiguous()
        args = dict(Wt=c["Wt"], Binv=c["Binv"][:B].contiguous(), **kw)
        xk, itk = K.pcg_stencil_tile(v, op.F_root, x0_b, **args)
        torch.cuda.synchronize()
        cl = _cluster(B)
        xp, itp = K.pcg_stencil_reference(v, op.F_root, x0_b, **args)
        if not torch.isfinite(xk).all():
            fail(f"K3r {name} B={B}: non-finite solution")
        rel_s = (torch.linalg.norm(xk - xp, dim=1) / torch.linalg.norm(xp, dim=1)).cpu().numpy()
        max_abs["K3r"] = max(max_abs["K3r"], (xk - xp).abs().max().item())
        it, itp = itk.cpu().numpy(), itp.cpu().numpy()
        it_diff = np.abs(it - itp)
        same = torch.equal(xk, full["K3r", name][0][:B])
        say("K3r", f"{name} B={B} (last tile {B % 8 or 8} of 8, cluster of {cl}): per-sample rel diff "
            f"vs plain max {rel_s.max():.3e}; iters kernel min/max {it.min()}/{it.max()}, plain "
            f"{itp.min()}/{itp.max()}, per-sample count difference max {it_diff.max()}; "
            f"bit-identical to the B={B_CHECK} run's first {B} samples: {same}")
        if it.max() >= MAXITER or itp.max() >= MAXITER:
            fail(f"K3r {name} B={B}: samples hit the {MAXITER}-iteration cap")
        if it_diff.max() > CHECK_EVERY:
            fail(f"K3r {name} B={B}: iteration counts differ from the plain version's by "
                 f"{it_diff.max()} > {CHECK_EVERY} for some sample")
        if rel_s.max() > rel_gate:
            fail(f"K3r {name} B={B}: kernel vs plain {rel_s.max():.3e} exceeds the plain version's "
                 f"own error against the direct solve, {rel_gate:.3e}")
    say("K3r", "sum order: K3r groups each sum by block, so it depends on the cluster size, not on n "
        "alone; a sample's bits can differ between batches with other cluster sizes (the "
        "'bit-identical' lines above)")

    times, abs_t = _k3_times("K3r", fin, op, defl, inputs, K3_BATCHES, kw, True, K3_DIRECT, K3_RES)
    max_abs["K3r"] = max(max_abs["K3r"], abs_t)
    sweep = _k3_sweep(op, defl, inputs, kw)
    res16 = phase_k3_res16()
    return dict(max_abs_err=max(max_abs["K3r"], res16["max_abs_err"]), k3_max_abs_err=max_abs["K3"],
                times=times, sweep=sweep, res16=res16)


K3_RES16 = 16
K3_RES16_B = 32
K3_RES16_DIRECT = 2


def phase_k3_res16():
    """K3r on its other route, res16 (n = 99,072): deflated cold at B = 32
    against the plain version under the res8 gates and against the float64
    direct solve on 2 samples; K3r, K3 and the plain version timed at
    B = 256."""
    import torch

    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    fin, defl, op, inputs = _k3_setup(K3_RES16)
    kw = dict(offsets=op.offsets[4:], tol=TOL, maxiter=MAXITER)
    ks_np, _, vals4, Binv = inputs(K3_RES16_B)
    args = dict(Wt=defl.Wt_bf16, Binv=Binv, **kw)
    xk, itk = K.pcg_stencil_tile(vals4, op.F_root, None, **args)
    torch.cuda.synchronize()
    say("K3r", f"res{K3_RES16} deflated cold B={K3_RES16_B}: cluster of {_cluster(K3_RES16_B)}")
    xp, itp = K.pcg_stencil_reference(vals4, op.F_root, None, **args)
    name = f"res{K3_RES16} deflated cold B={K3_RES16_B}"
    rel_s, abs_err, _ = _k3_gates("K3r", name, xk, itk, xp, itp, True)
    _k3_direct("K3r", name, fin, ks_np, xk, xp, rel_s, K3_RES16_DIRECT, K3_RES16)
    times, abs_t = _k3_times(f"K3r res{K3_RES16}", fin, op, defl, inputs, (B_CHECK,), kw, False, 0,
                             K3_RES16)
    return dict(max_abs_err=max(abs_err, abs_t), times=times, n=op.n)


DA_OUTER, DA_BURN = 100, 30  # cut from the reference bench's 500 / 150 outer steps
RHAT_GATE = 1.05  # the reference bench's split-R-hat gate


def phase_da():
    """The slice: the res8 build and da_pcn on the fom likelihood."""
    import torch

    from bayesianinferencedl_tpu_torch.api import build_pipeline, run_inversion
    from bayesianinferencedl_tpu_torch.config import (
        FEMConfig, MCMCConfig, MeshConfig, PipelineConfig, ROMConfig, SurrogateConfig,
    )
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger
    from bayesianinferencedl_tpu_torch.utils.ppc import thin_samples

    cfg = PipelineConfig(
        mesh=MeshConfig(resolution=K3_RES),
        fem=FEMConfig(biot=0.1, cg_tol=TOL, cg_maxiter=MAXITER),
        rom=ROMConfig(n_snapshots=256, basis_size=40, online_precision="highest"),
        surrogate=SurrogateConfig(hidden=(64, 64), n_train=1024, epochs=300),
        mcmc=MCMCConfig(n_chains=1024, n_steps=DA_OUTER, n_burn=DA_BURN, beta=0.25,
                        noise_sigma=1e-2, likelihood="fom", sampler="da_pcn", subchain=64,
                        da_coarse="rom_nn", da_inner="pcn"),
    )
    mc = cfg.mcmc
    log = MetricsLogger()
    K.launches = K.tile_launches = K.tile_mma_launches = 0
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, device="cuda", metrics=log)
    build_s = time.perf_counter() - t0
    k3_build, k1_build = K.tile_mma_launches, K.launches
    inv = run_inversion(pipe, metrics=log)
    torch.cuda.synchronize()
    k3_all, k1_all, k3_old = K.tile_mma_launches, K.launches, K.tile_launches
    s = log.summary()
    stages = {k: s[k]["seconds"] for k in ("build_fom", "snapshots", "project_rom", "error_dataset",
                                          "train_surrogate", "holdout_eval")}
    say("DA", f"build_pipeline res{K3_RES} (n = {pipe.fin.op.n}) {build_s:.2f} s; stages (s) "
        + json.dumps(stages))
    say("DA", f"K3r launches: {k3_build} in the build, {k3_all - k3_build} in run_inversion; "
        f"K3 launches: {k3_old}; K1 launches: {k1_all} ({k1_build} in the build)")
    res = inv.result
    outer = float(res.accept_rate.mean())
    inner = float(res.inner_accept_rate.mean())
    rhat = float(inv.rhat.max())
    say("DA", f"da_pcn fom, {mc.n_chains} chains, subchain {mc.subchain}, {mc.n_steps} outer steps "
        f"({mc.n_burn} burn-in): {inv.wall_seconds:.3f} s, {mc.n_steps / inv.wall_seconds:.3f} outer "
        f"steps/s, {inv.samples_per_sec:.1f} kept samples/s, ESS/s {inv.ess_per_sec:.2f} (bulk ESS "
        f"min {inv.ess.min().item():.1f}, tail min {inv.ess_tail.min().item():.1f}); outer accept "
        f"{outer:.4f}, inner accept {inner:.4f}; fine evaluations {res.n_fine_evals}")
    say("DA", f"split-rhat max {rhat:.4f} against the reference bench's {RHAT_GATE} gate: "
        f"{'pass' if rhat <= RHAT_GATE else 'fail'} (printed, not gated: {mc.n_steps - mc.n_burn} "
        f"kept outer steps); iteration audit cap {inv.fom_iter_cap}, max {inv.fom_iter_max}, "
        f"at cap {inv.fom_hit_cap_frac}; ppc p {inv.ppc['p_value']:.3f}")
    post = res.samples.mean(dim=(0, 1)).cpu().numpy()
    say("DA", f"posterior mean log k {np.round(post, 4).tolist()} vs truth "
        f"{np.round(inv.theta_true.cpu().numpy(), 4).tolist()}")

    if k3_build < 3:
        fail(f"K3r was launched {k3_build} times in build_pipeline at res{K3_RES} (expected >= 3)")
    if k3_all - k3_build < mc.n_steps + 1:
        fail(f"K3r was launched {k3_all - k3_build} times in the da_pcn run (expected >= "
             f"{mc.n_steps + 1})")
    if k1_all or k3_old:
        fail(f"K1 was launched {k1_all} times and K3 {k3_old} at res{K3_RES}, where K3r carries "
             f"every FOM solve")
    for name, t in (("samples", res.samples), ("phi", res.phi_trace), ("ess", inv.ess),
                    ("ess_tail", inv.ess_tail), ("rhat", inv.rhat), ("data", inv.data)):
        if not torch.isfinite(t).all():
            fail(f"non-finite {name}")
    if tuple(res.samples.shape) != (mc.n_steps - mc.n_burn, mc.n_chains, 5):
        fail(f"samples shape {tuple(res.samples.shape)}")
    if not outer > 0.6:
        fail(f"outer accept {outer:.4f} not above 0.6")
    if not 0.05 < inner < 0.9:
        fail(f"inner accept {inner:.4f} outside (0.05, 0.9)")
    if inv.fom_hit_cap_frac != 0:
        fail(f"{inv.fom_hit_cap_frac:.2%} of audited states hit the FOM iteration cap")

    # the fine correction alone: one batched FOM forward of 1,024 kept states
    fwd = pipe.batched_forward_fn("fom")
    states = thin_samples(res.samples, mc.n_chains)
    fine_ms = _time_ms(lambda: fwd(states), 3)
    step_ms = inv.wall_seconds * 1e3 / mc.n_steps
    say("DA", f"batched fine solve of {states.shape[0]} kept states {fine_ms:.3f} ms (K3r, cluster "
        f"of {_cluster(states.shape[0])}); outer step {step_ms:.3f} ms, of which the fine solve is "
        f"{100 * fine_ms / step_ms:.1f}% and the {mc.subchain} rom_nn steps the rest")
    # the fine solve's two parts on the same states: the coarse inverses (a
    # batched Cholesky factorisation and inverse in torch) and K3r alone
    fin, ks = pipe.fin, torch.exp(states)
    defl = fin.deflation_for_kernels()
    inv_ms = _time_ms(lambda: defl.coarse_inverses(ks, fin.op.biot), 3)
    vals4, Binv = K.upper_planes(fin.op.vals(ks)), defl.coarse_inverses(ks, fin.op.biot).contiguous()
    k3r_ms = _time_ms(lambda: K.pcg_stencil_tile(vals4, fin.op.F_root, None, offsets=fin.op.offsets[4:],
                                                 tol=TOL, maxiter=MAXITER, Wt=defl.Wt_bf16, Binv=Binv), 3)
    say("DA", f"  the same states: coarse inverses {inv_ms:.3f} ms, K3r alone {k3r_ms:.3f} ms")
    return k3_all


K4_RES = 32
K4_CAP = max(480, 120 * K4_RES)  # the reference CLI's _cg_maxiter in float32
K4_CHECK_B = 32
K4_DIRECT = 2  # samples held against the float64 direct solve
K4_BATCHES = (256, 64)  # the snapshots/rom batch and rom's test batch
K4_STREAM_B = 64  # the batch at which K4 is timed beside K4r
FLOOR_ITERS, FLOOR_B = 2000, 4  # the cap and batch of K4r's floor run (phase 7)
K4_STREAM_RES = 40  # a mesh past K4r's reach on an H100 (res >= 39), so K4c's route
K4_STREAM_N = 256  # the batch of phase 8's snapshot sweep there (the reference CLI's default --n)
K4C_BATCHES = (8, 64, 256)  # K4c's timed batches at res40: the first 8 and 64 of the 256
K4C_CAP = max(480, 120 * K4_STREAM_RES)  # the reference CLI's _cg_maxiter in float32: 4,800


def _time_once_ms(fn) -> tuple[float, object]:
    """One call timed by CUDA events (for calls of seconds, after the kernel
    has been built and run once); returns (ms, the call's result)."""
    import torch

    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1), out


def _k4_bound(B: int, cells: int, nodes: int, iters: np.ndarray) -> tuple[float, str]:
    """K4's bound for one cold batch with these per-sample counts (each
    sample also does one setup residual). Per iteration and grid node: the
    7-plane stencil (13), p.Ap, the x and r updates, z, r.z, r.r and the p
    update (13): 26 float32 operations, counted on the true grid's nodes
    (the padded cells have zero planes and need none). Bytes: the (B, 7,
    X, Y) planes and F read once, x and the counts written once."""
    f32 = float(np.sum(iters + 1)) * 26 * nodes
    nbytes = 4 * (7 * B * cells + cells + B * cells + B)
    return _bound(nbytes, f32)


def _rel_gap(a, b) -> np.ndarray:
    """Per-sample relative L2 gap ||a - b|| / ||b|| over (B, X, Y) grids."""
    import torch

    return (torch.linalg.norm((a - b).flatten(1), dim=1)
            / torch.linalg.norm(b.flatten(1), dim=1)).cpu().numpy()


def phase_k4():
    """K4r (csrc/pcg_stencil_grid_resident.cu), the single layout's kernel at
    res32, through pcg_stencil_grid, and K4 (csrc/pcg_stencil_grid.cu)
    through its launcher, each against the plain version."""
    import torch

    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.ops import _build
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    t0 = time.perf_counter()
    fin = FiveParamFin.create(resolution=K4_RES, biot=0.1, device="cuda", cg_tol=TOL, cg_maxiter=K4_CAP)
    op = fin.op
    X, Y = op.grid_shape
    X0, Y0 = op.grid_shape0
    say("K4r", f"res{K4_RES} n={op.n} grid {op.grid_shape0} padded to {op.grid_shape}; fin "
        f"{time.perf_counter() - t0:.2f} s; layout {K.layout_for(op.n)} (K3r up to n = "
        f"{K.SUBLANES_MAX_N}); cap {K4_CAP}")
    if K.layout_for(op.n) != "single":
        fail(f"solve_fom_stencil does not route n = {op.n} to the single layout")
    n_sm, smem = K.device_limits(torch.device("cuda"))
    route = K.grid_route(X0, Y0, n_sm, smem)
    nb = min(n_sm, X0)
    rows = [b - a for a, b in K.grid_strips(X0, nb)]
    lib = _build.load_library("pcg_stencil_grid_resident")
    c_bytes = lib.pcg_stencil_grid_resident_bytes
    c_bytes.restype, c_bytes.argtypes = ctypes.c_longlong, [ctypes.c_int] * 3
    py_bytes, k_bytes = K.resident_bytes(X0, Y0, nb), int(c_bytes(X0, Y0, nb))
    say("K4r", f"route: grid_route({X0}, {Y0}, {n_sm} SMs, {smem} B a block) = {route}; {nb} blocks "
        f"of {min(rows)}-{max(rows)} rows, {py_bytes} B of shared memory a block (the kernel's own "
        f"count: {k_bytes})")
    for line in _build.build_logs.get("pcg_stencil_grid_resident", {}).get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            say("K4r", f"ptxas: {line.strip()}")
    if route != "resident" or py_bytes != k_bytes:
        fail(f"res{K4_RES} routed to {route}, bytes {py_bytes} vs the kernel's {k_bytes}")
    rng = np.random.default_rng(0)
    F2d = op.to_grid(op.F_root)
    kw = dict(tol=TOL, maxiter=K4_CAP)
    k4r = lambda v, x0=None: K.pcg_stencil_grid(v, F2d, x0, shape0=(X0, Y0), **kw)
    k4 = lambda v, x0=None: K._launch_grid(v, F2d, x0, **kw)

    def inputs(B):
        ks_np = np.exp(rng.uniform(np.log(0.1), np.log(10.0), (B, 5)))
        ks = torch.tensor(ks_np, dtype=torch.float32, device="cuda")
        return ks_np, ks, op.vals_grid(ks)

    ks_np, ks, v2 = inputs(K4_CHECK_B)
    x0, _ = K.pcg_stencil_grid_reference(op.vals_grid(ks * 1.05), F2d, None, **kw)
    cases = (("K4r", "cold", k4r, v2, None), ("K4r", "warm", k4r, v2, x0),
             ("K4r", "cold B=1", k4r, v2[:1].contiguous(), None), ("K4", "cold", k4, v2, None))
    max_abs, iters, sols = {"K4r": 0.0, "K4": 0.0}, {}, {}
    for kern, name, solve, v, x0c in cases:
        n_r, n_s = K.grid_resident_launches, K.grid_launches
        xk, itk = solve(v, x0c)
        torch.cuda.synchronize()
        launched = (K.grid_resident_launches - n_r, K.grid_launches - n_s)
        if launched != ((1, 0) if kern == "K4r" else (0, 1)):
            fail(f"{kern} {name}: launches K4r/K4 {launched}")
        xp, itp = K.pcg_stencil_grid_reference(v, F2d, x0c, **kw)
        if not torch.isfinite(xk).all():
            fail(f"{kern} {name}: non-finite solution")
        rel_s = _rel_gap(xk, xp)
        max_abs[kern] = max(max_abs[kern], (xk - xp).abs().max().item())
        it, itp = itk.cpu().numpy(), itp.cpu().numpy()
        iters[kern, name], sols[kern, name] = it, xk
        mean_shift = abs(it.mean() / itp.mean() - 1)
        say(kern, f"{name}: per-sample rel diff vs plain max {rel_s.max():.3e} median "
            f"{np.median(rel_s):.3e}; iters kernel min/mean/max {it.min()}/{it.mean():.1f}/{it.max()}, "
            f"plain {itp.min()}/{itp.mean():.1f}/{itp.max()}; per-sample count difference max "
            f"{np.abs(it - itp).max()}")
        if name.startswith("cold") and (it.max() >= K4_CAP or itp.max() >= K4_CAP):
            fail(f"{kern} {name}: {int((it >= K4_CAP).sum())} kernel and {int((itp >= K4_CAP).sum())} "
                 f"plain samples hit the {K4_CAP}-iteration cap")
        if mean_shift > 0.05:
            fail(f"{kern} {name}: mean iteration count {it.mean():.2f} vs plain {itp.mean():.2f}")
        # f32 CG at res32 stops 0.5-1.5e-4 from the direct solve (its
        # attainable accuracy, which the stencil's rounding sets) and its
        # residual hovers near tol for hundreds of iterations, so the two
        # versions can stop hundreds of iterations apart. With the same
        # summation order and roundings (the kernels contract no FMA) they
        # follow one trajectory: per sample their gap is held against the
        # plain version's own error, and the kernel's error within 1.5x the
        # plain version's, the rule of phase 5. On every sample the gap must
        # stay below 1e-3, ten times that error: beyond it is a fault, not
        # rounding
        sub = slice(0, min(K4_DIRECT, len(it)))
        flat = lambda x: op.from_grid(x[sub]).cpu().numpy()
        err_k, res_k, floor = _direct_rel_err(fin, ks_np[sub], flat(xk))
        err_p, _, _ = _direct_rel_err(fin, ks_np[sub], flat(xp))
        gate = max(REL_GATE, 1.5 * err_p.max())
        say(kern, f"{name}: vs float64 direct solve (samples {sub.start}-{sub.stop - 1}): kernel rel err "
            f"{np.round(err_k, 8).tolist()}, plain {np.round(err_p, 8).tolist()}, kernel vs plain "
            f"{np.round(rel_s[sub], 8).tolist()}; f64 rel residual {res_k.max():.3e} (float32-rounded "
            f"exact solution: {floor:.3e}); accuracy gate {gate:.3e} = max({REL_GATE:g}, 1.5 x the plain "
            f"version's error: f32 CG's attainable accuracy at res{K4_RES} is its own)")
        if err_k.max() > gate:
            fail(f"{kern} {name}: relative error {err_k.max():.3e} against the f64 direct solve > {gate:.3e}")
        if (rel_s[sub] > err_p).any():
            fail(f"{kern} {name}: kernel vs plain {np.round(rel_s[sub], 8).tolist()} exceeds the plain "
                 f"version's own error against the direct solve, {np.round(err_p, 8).tolist()}")
        if rel_s.max() > 1e-3:
            fail(f"{kern} {name}: kernel vs plain {rel_s.max():.3e} > 1e-3 on some sample")
    same = bool(iters["K4r", "cold B=1"][0] == iters["K4r", "cold"][0])
    say("K4r", f"B=1 count equal to the B={K4_CHECK_B} run's first sample: {same}")
    gap = _rel_gap(sols["K4r", "cold"], sols["K4", "cold"])
    dit = np.abs(iters["K4r", "cold"] - iters["K4", "cold"])
    say("K4r", f"cold B={K4_CHECK_B}: K4r vs K4 per-sample rel gap max {gap.max():.3e}, "
        f"{int((gap == 0).sum())} of {len(gap)} samples bit-identical; count difference max {dit.max()}")
    # a warm start lowers the batch's mean count; single samples can take
    # more, since near tol the count moves by hundreds of iterations
    w, c = iters["K4r", "warm"], iters["K4r", "cold"]
    say("K4r", f"warm vs cold: mean count {w.mean():.1f} vs {c.mean():.1f}; {int((w >= c).sum())} of "
        f"{len(c)} samples took no fewer iterations warm")
    if not w.mean() < c.mean():
        fail(f"K4r warm: mean count {w.mean():.1f} not below the cold {c.mean():.1f}")

    # the CLI's batches: timed, and K4r held against the plain version on
    # every sample with the gates that need no direct solve; K4 timed beside
    # it at B = 64
    times = {}
    for B in K4_BATCHES:
        _, ks, v2 = inputs(B)
        r_ms, (xk, it_b) = _time_once_ms(lambda: k4r(v2))
        p_ms, (xp, itp_b) = _time_once_ms(lambda: K.pcg_stencil_grid_reference(v2, F2d, None, **kw))
        rel_s = _rel_gap(xk, xp)
        max_abs["K4r"] = max(max_abs["K4r"], (xk - xp).abs().max().item())
        finite = bool(torch.isfinite(xk).all())
        it, itp = it_b.cpu().numpy(), itp_b.cpu().numpy()
        bound = _k4_bound(B, X * Y, op.n_grid, it)
        us_it = r_ms * 1e3 / float(np.sum(it + 1))
        times[B] = dict(ms=r_ms, plain_ms=p_ms, bound=bound, iters_mean=float(it.mean()), us_iter=us_it)
        say("K4r", f"cold B={B}: K4r {r_ms:.3f} ms ({B / r_ms * 1e3:.2f} solves/s, {us_it:.4f} us per "
            f"CG iteration = ms / sum(iters + 1)), plain torch {p_ms:.3f} ms; bound {bound[0]:.4f} ms "
            f"({bound[1]}), K4r at {100 * bound[0] / r_ms:.2f}% of it")
        say("K4r", f"cold B={B}: per-sample rel diff vs plain max {rel_s.max():.3e} median "
            f"{np.median(rel_s):.3e}; counts min/mean/max kernel {it.min()}/{it.mean():.1f}/{it.max()}, "
            f"plain {itp.min()}/{itp.mean():.1f}/{itp.max()}; per-sample count difference max "
            f"{np.abs(it - itp).max()}; at the {K4_CAP} cap: kernel {int((it >= K4_CAP).sum())}, plain "
            f"{int((itp >= K4_CAP).sum())} (printed, not gated: the cap is the reference CLI's own)")
        if B == K4_STREAM_B:
            s_ms, (x4, it4) = _time_once_ms(lambda: k4(v2))
            max_abs["K4"] = max(max_abs["K4"], (x4 - xp).abs().max().item())
            g4 = _rel_gap(xk, x4)
            it4 = it4.cpu().numpy()
            times["K4"] = dict(ms=s_ms, plain_ms=p_ms, bound=bound)
            say("K4", f"cold B={B}, same inputs: K4 {s_ms:.3f} ms ({B / s_ms * 1e3:.2f} solves/s), "
                f"K4r {r_ms:.3f} ms: K4r {s_ms / r_ms:.2f}x faster; K4 vs plain max {_rel_gap(x4, xp).max():.3e}; "
                f"K4r vs K4 per-sample gap max {g4.max():.3e} ({int((g4 == 0).sum())} of {B} "
                f"bit-identical), count difference max {np.abs(it - it4).max()}")
            del x4
            # K4c, the streaming route past K4r's reach, on the same inputs:
            # recorded beside K4r, not routed here (ISSUE: its streaming
            # floor is no better than K4r's time at res32)
            # timed twice: K4c's first launch in this process, then the
            # second on the same inputs (the first has read seconds slower)
            c1_ms, _ = _time_once_ms(lambda: K._launch_grid_cluster(v2, F2d, None, (X0, Y0), **kw))
            c_ms, (xc, itc) = _time_once_ms(lambda: K._launch_grid_cluster(v2, F2d, None, (X0, Y0), **kw))
            gc, itc = _rel_gap(xc, xp), itc.cpu().numpy()
            g4r = _rel_gap(xc, xk)
            c4c = K.grid_cluster(B, K.grid_capacity(torch.cuda.current_device(), Y0))
            fl = _stream_floor(K4C_BYTES, op.n_grid, itc)
            times["K4c"] = dict(ms=c_ms, first_ms=c1_ms, r_ms=r_ms, floor=fl)
            say("K4c", f"res{K4_RES} cold B={B}, same inputs: K4c (clusters of {c4c}) {c_ms:.3f} ms (its first "
                f"launch {c1_ms:.3f} ms) "
                f"({B / c_ms * 1e3:.2f} solves/s), K4r {r_ms:.3f} ms: K4r/K4c time ratio {r_ms / c_ms:.3f}; "
                f"K4c streaming floor {fl:.3f} ms ({K4C_BYTES} B a true node), K4c at {100 * fl / c_ms:.1f}% of "
                f"it; K4c vs plain max {gc.max():.3e}, counts min/mean/max {itc.min()}/{itc.mean():.1f}/"
                f"{itc.max()} (plain {itp.mean():.1f}); K4c vs K4r per-sample gap max {g4r.max():.3e} "
                f"({int((g4r == 0).sum())} of {B} bit-identical)")
            if not torch.isfinite(xc).all() or gc.max() > 1e-3 or abs(itc.mean() / itp.mean() - 1) > 0.05:
                fail(f"K4c res{K4_RES} B={B}: finite {bool(torch.isfinite(xc).all())}, gap vs plain "
                     f"{gc.max():.3e} (gate 1e-3), mean count {itc.mean():.2f} vs plain {itp.mean():.2f} (5%)")
            del xc
        del xk, xp
        if not finite:
            fail(f"K4r cold B={B}: non-finite solution")
        if abs(it.mean() / itp.mean() - 1) > 0.05:
            fail(f"K4r cold B={B}: mean iteration count {it.mean():.2f} vs plain {itp.mean():.2f}")
        if rel_s.max() > 1e-3:
            fail(f"K4r cold B={B}: kernel vs plain {rel_s.max():.3e} > 1e-3 on some sample")

    # one cold sample alone, and the floor of an iteration: the same launch on
    # a one-row, 8-cell strip per block, FLOOR_B samples of the 5-point
    # Laplacian (SPD; the fin's own planes are the identity in the grid's
    # corners, outside the fin) with a load of ones at tol 0, each running
    # to the cap unless its residual reaches exactly zero: the two
    # reductions and barriers with next to no sweep
    one_ms, (_, it1) = _time_once_ms(lambda: k4r(v2[:1].contiguous()))
    lap = torch.zeros((FLOOR_B, 7, nb, 8), dtype=torch.float32, device="cuda")
    lap[:, K.DIAG_SLOT] = 4.0
    for s_ in (1, 2, 4, 5):  # (-1, 0), (0, -1), (0, 1), (1, 0)
        lap[:, s_] = -1.0
    ones = torch.ones((nb, 8), dtype=torch.float32, device="cuda")
    fl_ms, (xf, itf) = _time_once_ms(lambda: K.pcg_stencil_grid(
        lap, ones, None, tol=0.0, maxiter=FLOOR_ITERS, shape0=(nb, 8)))
    n_fl = int(itf.sum()) + FLOOR_B
    floor_us = fl_ms * 1e3 / n_fl
    us = times[K4_BATCHES[0]]["us_iter"]
    times[1] = dict(ms=one_ms, iters=int(it1[0]))
    say("K4r", f"cold B=1: {one_ms:.3f} ms for {int(it1[0])} iterations "
        f"({one_ms * 1e3 / (int(it1[0]) + 1):.4f} us each); the floor, {nb} strips of one 8-cell row, "
        f"{FLOOR_B} samples at tol 0, {n_fl} iterations in all: {floor_us:.4f} us per iteration, "
        f"{100 * floor_us / us:.1f}% of the {us:.4f} us at B={K4_BATCHES[0]}")
    if not torch.isfinite(xf).all() or n_fl < 1000:
        fail(f"K4r floor run: {n_fl} iterations, finite {bool(torch.isfinite(xf).all())}")
    return dict(fin=fin, max_abs_err=max_abs, times=times)


def phase_fom_cli(k4):
    """The slice: the reference CLI's FOM commands at res32, in-process, on
    K4r; and a snapshot sweep at res40, where the single layout's strips
    outgrow the card's shared memory, on K4c."""
    import torch

    from bayesianinferencedl_tpu_torch import cli
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K
    from bayesianinferencedl_tpu_torch.ops.deflation import DeflationBasis

    builds = []
    create = DeflationBasis.create

    def counted_create(*a, **kw):
        builds.append(1)
        return create(*a, **kw)

    res = str(K4_RES)
    k_fom = ["0.5", "2.0", "1.0", "3.0", "0.8"]
    # (name, argv, the kernel that must carry the batched solves, its least launches)
    commands = (("fom", ["fom", "--resolution", res, "--k", *k_fom], "K4r", 0),
                ("snapshots", ["snapshots", "--resolution", res, "--n", "256"], "K4r", 1),
                ("rom", ["rom", "--resolution", res, "--n-snapshots", "256", "--r", "40"], "K4r", 2),
                (f"snapshots res{K4_STREAM_RES}", ["snapshots", "--resolution", str(K4_STREAM_RES),
                                                   "--n", str(K4_STREAM_N)], "K4c", 1))
    out, counts = {}, {"K4r": 0, "K4c": 0}
    DeflationBasis.create = counted_create
    try:
        for name, argv, kern, least in commands:
            K.launches = K.tile_launches = K.tile_mma_launches = 0
            K.grid_launches = K.grid_resident_launches = K.grid_cluster_launches = 0
            builds.clear()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = {"K4r": K.grid_resident_launches, "K4c": K.grid_cluster_launches, "K4": K.grid_launches,
                 "K1": K.launches, "K3r": K.tile_mma_launches, "K3": K.tile_launches}
            nb = len(builds)
            line = buf.getvalue().strip().splitlines()[-1]
            out[name] = rec = json.loads(line)
            say("CLI", f"{' '.join(argv)}: {wall:.2f} s wall; {line}")
            say("CLI", f"{name}: launches " + ", ".join(f"{k} {v}" for k, v in n.items())
                + f"; deflation bases built {nb}")
            other = [k for k, v in n.items() if k != kern and v]
            if n[kern] < least:
                fail(f"{name}: {kern} was launched {n[kern]} times (expected >= {least})")
            if other or nb:
                fail(f"{name}: launches of {other} and {nb} deflation bases, where {kern} carries "
                     f"every batched solve undeflated")
            if not np.isfinite(np.array(list(_numbers(rec)), dtype=float)).all():
                fail(f"{name}: non-finite output {line}")
            counts[kern] += n[kern]
    finally:
        DeflationBasis.create = create

    qoi = np.array(out["fom"]["qoi"])
    if qoi.shape != (5,) or not (qoi > 0).all():
        fail(f"fom: QoI {qoi.tolist()} is not 5 positive entries")
    _fom_qoi_check(k4["fin"], np.array([float(v) for v in k_fom]), qoi)
    rel = out["rom"]["rel_err_vs_fom"]
    say("CLI", f"snapshots: {out['snapshots']['fom_solves_per_sec']:.2f} FOM solves/s at res{K4_RES} "
        f"(K4r), {out[commands[3][0]]['fom_solves_per_sec']:.2f} at res{K4_STREAM_RES} (K4c); rom r=40 "
        f"rel_err_vs_fom {rel:.4e}")
    if not rel < 0.1:
        fail(f"rom: rel_err_vs_fom {rel} not below 0.1")
    return counts


# K4r vs its plain version: one trajectory, with the stencil summed in one order
# and every product and sum rounded on its own (K4r contracts no FMA)
K4_QOI_GAP = 1e-4
# any f32 solve of the fom k vs the float64 direct solve at res32, tol 1e-7:
# f32 Jacobi-PCG stops where the stencil's rounding lets it, 6.4e-5 to 8.4e-4
# from the direct solve's QoI across the summation orders this phase runs
K4_QOI_ERR = 1e-3


def _fom_qoi_check(fin, k_np: np.ndarray, qoi: np.ndarray) -> None:
    """The fom command's QoI at k against the float64 direct solve's, beside
    three more float32 solves of the same k at the same tol and cap: K4r, its
    plain version, and the fom command's flat plain loop with its matvec
    summed diagonal first, as both grid versions sum it. Where the flat loop
    lands with that order tells which of the two plain solves is the outlier:
    f32 CG stops at an accuracy that the matvec's rounding sets."""
    import torch

    from bayesianinferencedl_tpu_torch.fem.solve import pcg
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    op = fin.op
    k = torch.tensor(k_np[None], dtype=torch.float32, device="cuda")
    kw = dict(tol=TOL, maxiter=K4_CAP)
    v2, F2d = op.vals_grid(k), op.to_grid(op.F_root)
    x4, it4 = K.pcg_stencil_grid(v2, F2d, None, shape0=op.grid_shape0, **kw)
    xg, itg = K.pcg_stencil_grid_reference(v2, F2d, None, **kw)
    vals, m = op.vals(k), op.max_offset

    def matvec_diag_first(p):
        pp = torch.nn.functional.pad(p, (m, m))
        acc = vals[..., K.DIAG_SLOT] * p
        for s, o in enumerate(op.offsets):
            if s != K.DIAG_SLOT:
                acc = acc + vals[..., s] * pp[..., m + o : m + o + op.n]
        return acc

    xf, itf, _ = pcg(matvec_diag_first, op.F_root[None], op.diag(vals), **kw)
    q = {"fom": qoi,
         "K4r": fin.qoi(op.from_grid(x4))[0].cpu().numpy(),
         "plain grid": fin.qoi(op.from_grid(xg))[0].cpu().numpy(),
         "flat, diagonal first": fin.qoi(xf)[0].cpu().numpy()}
    its = {"K4r": int(it4[0]), "plain grid": int(itg[0]), "flat, diagonal first": int(itf[0])}
    qd = _direct_qoi(fin, k_np)
    err = {name: np.abs(v - qd).max() / np.abs(qd).max() for name, v in q.items()}
    gap = np.abs(q["K4r"] - q["plain grid"]).max() / np.abs(q["plain grid"]).max()
    say("CLI", f"fom QoI {np.round(qoi, 6).tolist()}; max rel error against the float64 direct solve's "
        f"QoI: " + ", ".join(f"{name} {e:.3e}" + (f" ({its[name]} iterations)" if name in its else "")
                             for name, e in err.items()))
    outlier = "fom (flat, offsets order)" if (abs(err["fom"] - err["flat, diagonal first"])
                                             > abs(err["plain grid"] - err["flat, diagonal first"])) \
        else "plain grid"
    say("CLI", f"the plain solve farther from the flat loop summed diagonal first: {outlier}; K4r vs plain "
        f"grid QoI gap {gap:.3e} (gate {K4_QOI_GAP:g}: one trajectory, one summation order, the same "
        f"roundings); every solve vs direct gated at {K4_QOI_ERR:g} (f32 Jacobi-PCG's attainable "
        f"accuracy at res{K4_RES}, tol {TOL:g}, which the stencil's summation order moves by up to 13x)")
    if gap > K4_QOI_GAP:
        fail(f"fom: K4r's QoI differs from its plain version's by {gap:.3e} > {K4_QOI_GAP:g}")
    for name, e in err.items():
        if e > K4_QOI_ERR:
            fail(f"fom: {name} QoI error {e:.3e} against the direct solve > {K4_QOI_ERR:g}")


def _k4c_gates(tag, x, it, xp, itp, cap):
    """The per-sample gates of a res40 run against the plain version on the
    same inputs: finite, every gap below 1e-3, mean counts within 5%, and no
    sample at the cap that the plain version does not also hit."""
    import torch

    gap = _rel_gap(x, xp)
    it, itp = it.cpu().numpy(), itp.cpu().numpy()
    only = int(((it >= cap) & (itp < cap)).sum())
    say("K4c", f"{tag} vs plain: per-sample rel gap max {gap.max():.3e} median {np.median(gap):.3e}; counts "
        f"min/mean/max {it.min()}/{it.mean():.1f}/{it.max()}, plain {itp.min()}/{itp.mean():.1f}/{itp.max()}; "
        f"per-sample count difference max {np.abs(it - itp).max()}; at the {cap} cap: {int((it >= cap).sum())}, "
        f"plain {int((itp >= cap).sum())}")
    if not torch.isfinite(x).all():
        fail(f"{tag}: non-finite solution")
    if gap.max() > 1e-3:
        fail(f"{tag}: per-sample gap {gap.max():.3e} from the plain version > 1e-3")
    if abs(it.mean() / itp.mean() - 1) > 0.05:
        fail(f"{tag}: mean iteration count {it.mean():.2f} vs plain {itp.mean():.2f}")
    if only:
        fail(f"{tag}: {only} samples at the {cap} cap where the plain version converged")
    return (x - xp).abs().max().item()


def phase_k4c(k4):
    """K4c (csrc/pcg_stencil_grid_cluster.cu), the single layout's kernel past
    K4r's reach, at the shapes of its main path (phase 8's res40 sweep, cap
    4,800), through pcg_stencil_grid; K4 (csrc/pcg_stencil_grid.cu), off the
    main path, through its launcher beside it. The batches are the first 8,
    64 and all 256 of one set of conductivities."""
    import torch

    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.ops import _build
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

    t0 = time.perf_counter()
    fin = FiveParamFin.create(resolution=K4_STREAM_RES, biot=0.1, device="cuda", cg_tol=TOL,
                              cg_maxiter=K4C_CAP)
    op = fin.op
    X, Y = op.grid_shape
    X0, Y0 = op.grid_shape0
    cells, nodes = X * Y, op.n_grid
    n_sm, smem = K.device_limits(torch.device("cuda"))
    route = K.grid_route(X0, Y0, n_sm, smem)
    cap = K.grid_capacity(torch.cuda.current_device(), Y0)
    picks = {B: K.grid_cluster(B, cap) for B in (1, *K4C_BATCHES)}
    c_bytes = _build.load_library("pcg_stencil_grid_cluster").pcg_stencil_grid_cluster_smem_bytes
    c_bytes.restype, c_bytes.argtypes = ctypes.c_longlong, [ctypes.c_int]
    py_bytes, k_bytes = K.cluster_bytes(Y0), int(c_bytes(Y0))
    say("K4c", f"res{K4_STREAM_RES} n={op.n} grid {op.grid_shape0} padded to {op.grid_shape} ({nodes} true "
        f"nodes, {cells} cells); fin {time.perf_counter() - t0:.2f} s; cap {K4C_CAP}; route: grid_route({X0}, "
        f"{Y0}, {n_sm} SMs, {smem} B a block) = {route} (K4r's strips would need "
        f"{K.resident_bytes(X0, Y0, min(n_sm, X0))} B a block); {py_bytes} B of shared memory a K4c block "
        f"(the kernel's own count: {k_bytes})")
    say("K4c", f"capacity, clusters of c the card holds at once: {cap}; grid_cluster(B, capacity) = "
        + ", ".join(f"{B}: {c}" for B, c in picks.items()))
    for line in _build.build_logs.get("pcg_stencil_grid_cluster", {}).get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            say("K4c", f"ptxas: {line.strip()}")
    if route != "stream" or py_bytes != k_bytes:
        fail(f"res{K4_STREAM_RES} routed to {route}, bytes {py_bytes} vs the kernel's {k_bytes}")

    ks_np = np.exp(np.random.default_rng(1).uniform(np.log(0.1), np.log(10.0), (K4C_BATCHES[-1], 5)))
    v_all = op.vals_grid(torch.tensor(ks_np, dtype=torch.float32, device="cuda"))
    F2d = op.to_grid(op.F_root)
    kw = dict(tol=TOL, maxiter=K4C_CAP)
    k4c = lambda v: K.pcg_stencil_grid(v, F2d, None, shape0=(X0, Y0), **kw)
    k4 = lambda v: K._launch_grid(v, F2d, None, **kw)
    times, max_abs = {}, {}

    def report(name, B, ms, it, bytes_per, n):
        it = it.cpu().numpy()
        bound, fl = _k4_bound(B, cells, nodes, it), _stream_floor(bytes_per, n, it)
        times[name, B] = dict(ms=ms, bound=bound, floor=fl)
        say(name, f"res{K4_STREAM_RES} cold B={B}: {ms:.3f} ms ({B / ms * 1e3:.2f} solves/s), counts mean "
            f"{it.mean():.1f}, sum(iters + 1) {int(np.sum(it + 1))}; least-work bound {bound[0]:.4f} ms "
            f"({bound[1]}), {name} at {100 * bound[0] / ms:.2f}% of it; streaming floor {fl:.3f} ms "
            f"({bytes_per} B x {n} x sum(iters + 1) / 3.35 TB/s), {name} at {100 * fl / ms:.1f}% of it")

    # B = 8 through the wrapper, against the plain version
    v8 = v_all[: K4C_BATCHES[0]]
    before = (K.grid_cluster_launches, K.grid_launches, K.grid_resident_launches)
    ms8, (x8, it8) = _time_once_ms(lambda: k4c(v8))
    launched = tuple(a - b for a, b in zip((K.grid_cluster_launches, K.grid_launches,
                                            K.grid_resident_launches), before))
    if launched != (1, 0, 0):
        fail(f"res{K4_STREAM_RES}: pcg_stencil_grid launched K4c/K4/K4r {launched}, not K4c once")
    p_ms, (xp, itp) = _time_once_ms(lambda: K.pcg_stencil_grid_reference(v8, F2d, None, **kw))
    times["plain", 8] = dict(ms=p_ms)
    say("K4c", f"cold B=8 through pcg_stencil_grid (clusters of {picks[8]}): {ms8:.3f} ms, plain torch "
        f"{p_ms:.3f} ms: K4c {p_ms / ms8:.2f}x faster than plain")
    max_abs["K4c"] = _k4c_gates("K4c cold B=8", x8, it8, xp, itp, K4C_CAP)
    report("K4c", 8, ms8, it8, K4C_BYTES, nodes)

    # one sample against the float64 direct solve
    flat = lambda x: op.from_grid(x[:1]).cpu().numpy()
    err_k, res_k, floor = _direct_rel_err(fin, ks_np[:1], flat(x8))
    err_p, _, _ = _direct_rel_err(fin, ks_np[:1], flat(xp))
    gate = max(REL_GATE, 1.5 * err_p.max())
    say("K4c", f"sample 0 vs the float64 direct solve: K4c rel err {err_k[0]:.4e}, plain {err_p[0]:.4e}; f64 "
        f"rel residual {res_k[0]:.3e} (float32-rounded exact solution: {floor:.3e}); gate {gate:.4e} = "
        f"max({REL_GATE:g}, 1.5 x the plain version's error: f32 CG's attainable accuracy at "
        f"res{K4_STREAM_RES} is its own)")
    if err_k.max() > gate:
        fail(f"K4c: relative error {err_k.max():.3e} against the f64 direct solve > {gate:.3e}")

    # one cold sample alone
    ms1, (x1, it1) = _time_once_ms(lambda: k4c(v_all[:1]))
    same = int(it1[0]) == int(it8[0])
    say("K4c", f"cold B=1 (clusters of {picks[1]}): {ms1:.3f} ms, {int(it1[0])} iterations; the B=8 run's "
        f"sample 0 (clusters of {picks[8]}): {int(it8[0])}; equal: {same}; bit-identical: "
        f"{bool(torch.equal(x1[0], x8[0]))}" + ("" if picks[1] == picks[8] else
                                                " (other cluster sizes: printed, not gated)"))
    if picks[1] == picks[8] and not same:
        fail(f"K4c B=1: {int(it1[0])} iterations, the B=8 run's sample 0 took {int(it8[0])} on the same c")
    del x1

    # K4, off the main path, at B = 8: its gates against the same plain run
    ms48, (x48, it48) = _time_once_ms(lambda: k4(v8))
    max_abs["K4"] = _k4c_gates("K4 cold B=8", x48, it48, xp, itp, K4C_CAP)
    report("K4", 8, ms48, it48, K4_BYTES, cells)
    g = _rel_gap(x8, x48)
    say("K4c", f"cold B=8: K4 {ms48:.3f} ms, K4c {ms8:.3f} ms: K4c {ms48 / ms8:.2f}x faster; K4c vs K4 "
        f"per-sample gap max {g.max():.3e} ({int((g == 0).sum())} of 8 bit-identical)")
    del x48

    # B = 64: K4c and K4 on the same inputs
    v64 = v_all[: K4C_BATCHES[1]]
    ms64, (x64, it64) = _time_once_ms(lambda: k4c(v64))
    report("K4c", 64, ms64, it64, K4C_BYTES, nodes)
    ms464, (x464, it464) = _time_once_ms(lambda: k4(v64))
    report("K4", 64, ms464, it464, K4_BYTES, cells)
    g, a, b = _rel_gap(x64, x464), it64.cpu().numpy(), it464.cpu().numpy()
    say("K4c", f"cold B=64 (clusters of {picks[64]}), same inputs: K4 {ms464:.3f} ms, K4c {ms64:.3f} ms: K4c "
        f"{ms464 / ms64:.2f}x faster; K4c vs K4 per-sample gap max {g.max():.3e} ({int((g == 0).sum())} of 64 "
        f"bit-identical); counts mean {a.mean():.1f} vs {b.mean():.1f}, difference max {np.abs(a - b).max()}")
    if not torch.isfinite(x64).all() or g.max() > 1e-3 or abs(a.mean() / b.mean() - 1) > 0.05:
        fail(f"K4c B=64 vs K4: gap {g.max():.3e} (gate 1e-3), mean counts {a.mean():.2f} vs {b.mean():.2f} (5%)")
    del x464

    # B = 256, the main path's batch; its first 8 against the plain run
    ms256, (x256, it256) = _time_once_ms(lambda: k4c(v_all))
    report("K4c", 256, ms256, it256, K4C_BYTES, nodes)
    say("K4c", f"cold B=256 (clusters of {picks[256]}): first 8 samples against the B=8 plain run:")
    max_abs["K4c"] = max(max_abs["K4c"], _k4c_gates("K4c cold B=256 [:8]", x256[:8], it256[:8], xp, itp,
                                                    K4C_CAP))
    a = it256.cpu().numpy()
    say("K4c", f"cold B=256: counts min/mean/max {a.min()}/{a.mean():.1f}/{a.max()}, at the {K4C_CAP} cap "
        f"{int((a >= K4C_CAP).sum())} (printed, not gated: the cap is the reference CLI's own); finite "
        f"{bool(torch.isfinite(x256).all())}")
    if not torch.isfinite(x256).all():
        fail("K4c B=256: non-finite solution")
    del x256

    # the cluster sizes beside the pick, at B = 8 (against the plain run) and 64
    for B, v, ref in ((8, v8, xp), (64, v64, x64)):
        t = {}
        for c in K.GRID_CLUSTERS:
            t[c], (xc, _) = _time_once_ms(
                lambda: K._launch_grid_cluster(v, F2d, None, (X0, Y0), cluster=c, **kw))
            g = _rel_gap(xc, ref).max()
            if not torch.isfinite(xc).all() or g > 1e-3:
                fail(f"K4c sweep B={B}, clusters of {c}: gap {g:.3e} from the reference run (gate 1e-3)")
        fastest = min(t, key=t.get)
        say("K4c", f"sweep B={B}: " + ", ".join(f"c={c} {ms:.3f} ms" for c, ms in t.items())
            + f"; grid_cluster picks {picks[B]}, the fastest is {fastest}: the pick is the fastest: "
            f"{picks[B] == fastest} (the pick at {t[picks[B]] / t[fastest]:.3f}x the fastest)")
    return dict(max_abs_err=max_abs, times=times)


def _numbers(rec):
    for v in rec.values():
        if isinstance(v, list):
            yield from v
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            yield v


K5_RES, K5_B, K5_TILE = 8, 64, 8
K5_ITERS = 256  # the reference probe's iteration count
K5_GATE_FLOOR = 1e-4


def _k5_bound(B: int, n: int, n_iters: int) -> tuple[float, str]:
    """K5's bound for one run: per iteration and node the 7-plane matvec
    (13), p.Ap, the x and r updates, z, r.z and the p update (11): 24
    float32 operations, and ~4 for the setup. Bytes: the (B, n, 7) values
    and F read once, x written once."""
    return _bound(4 * (7 * B * n + n + B * n), float(B) * n * (24 * n_iters + 4))


def phase_k5(k3):
    """K5 (csrc/shift_cost.cu) against its plain version at res8, then its
    entry point."""
    import torch

    from bayesianinferencedl_tpu_torch.experimental import shift_cost as K5
    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.rom.snapshots import sample_log_uniform

    fin = FiveParamFin.create(resolution=K5_RES, biot=0.1, device="cuda", cg_tol=TOL, cg_maxiter=2000)
    op = fin.op
    vals = op.vals(sample_log_uniform(torch.Generator(device="cuda").manual_seed(1), K5_B))
    max_abs = 0.0
    why = ("a fixed-iteration f32 CG with no stop test keeps every rounding difference of its sums, so "
           "two float32 runs differ by about what each differs from the float64 one")
    # without the shifts the operator is the diagonal of A's row sums, which
    # cancel to rounding level off the convective boundary, so on A's own
    # planes the values are set by rounding from the second iteration on
    # (experimental/shift_cost.py); on |A|'s planes the row sums are
    # positive, the loop is a CG of an SPD diagonal operator, and the
    # comparison is as tight as with the shifts
    variants = ((True, vals, "A's planes"), (False, vals.abs(), "|A|'s planes"))
    for use_rolls, v, what in variants:
        n_iters = K5_ITERS
        kw = dict(offsets=op.offsets, n_iters=n_iters, use_rolls=use_rolls)
        xk = K5.shift_cost(v, op.F_root, tile=K5_TILE, **kw)
        torch.cuda.synchronize()
        xp = K5.shift_cost_reference(v, op.F_root, **kw)
        x64 = K5.shift_cost_reference(v.double(), op.F_root.double(), **kw)
        rel = lambda a, b: (torch.linalg.norm(a.double() - b.double(), dim=1)
                            / torch.linalg.norm(b.double(), dim=1)).max().item()
        r_kp, r_p64, r_k64 = rel(xk, xp), rel(xp, x64), rel(xk, x64)
        gate = max(K5_GATE_FLOOR, 3 * r_p64)
        max_abs = max(max_abs, (xk - xp).abs().max().item())
        say("K5", f"{'shifts' if use_rolls else 'no shifts'} on {what}, {n_iters} iterations, B={K5_B}, "
            f"tile {K5_TILE}: kernel vs plain max per-sample rel diff {r_kp:.3e}; plain float32 vs its "
            f"float64 run {r_p64:.3e}, kernel vs float64 {r_k64:.3e}; gate {gate:.3e} = "
            f"max({K5_GATE_FLOOR:g}, 3x the plain float32 run's gap from its float64 run): {why}")
        if not torch.isfinite(xk).all():
            fail("K5: non-finite output")
        if r_kp > gate:
            fail(f"K5: kernel vs plain {r_kp:.3e} > {gate:.3e}")

    # the main path: the probe's entry point
    K5.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        K5.main([str(K5_RES), str(K5_TILE)])
    launches = K5.launches
    rows = {r["use_rolls"]: r for r in (json.loads(line) for line in buf.getvalue().splitlines()
                                        if line.startswith("{"))}
    for r in rows.values():
        say("K5", json.dumps(r))
    if launches < 2 or set(rows) != {True, False}:
        fail(f"K5's entry point made {launches} launches and printed {len(rows)} variants")
    us_s, us_n = rows[True]["per_tile_iter_us"], rows[False]["per_tile_iter_us"]
    t3 = k3["times"][B_CHECK]
    k3_us = t3["k3_ms"] * 1e3 / t3["k3_iters_mean"]
    say("K5", f"launches {launches}; per tile-iteration: shifts {us_s:.4f} us, no shifts {us_n:.4f} us, "
        f"shift cost {us_s - us_n:.4f} us ({100 * (us_s - us_n) / us_s:.1f}%); K3 deflated at res8, "
        f"B={B_CHECK} (phase 5): {k3_us:.3f} us per batch iteration, "
        f"{k3_us / (B_CHECK // 8):.4f} us per tile-iteration in the reference's division")
    vals2 = op.vals(sample_log_uniform(torch.Generator(device="cuda").manual_seed(2), K5_B))
    p_ms, _ = _time_once_ms(lambda: K5.shift_cost_reference(vals2, op.F_root, offsets=op.offsets,
                                                           n_iters=K5_ITERS, use_rolls=True))
    ms = rows[True]["total_s"] * 1e3
    bound = _k5_bound(K5_B, op.n, K5_ITERS)
    say("K5", f"shifts, {K5_ITERS} iterations: kernel {ms:.3f} ms, plain torch {p_ms:.3f} ms; bound "
        f"{bound[0]:.4f} ms ({bound[1]}), kernel at {100 * bound[0] / ms:.2f}% of it")
    return dict(launches=launches, max_abs_err=max_abs, ms=ms, plain_ms=p_ms, bound=bound)


def _kernel_entry(name: str, source: str, replaces: str, launches: int, max_abs_err: float,
                  ms: float, plain_ms: float, bound: tuple) -> dict:
    return {"name": name, "route": "cuda", "source": f"bayesianinferencedl_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}


def main() -> None:
    card = phase_device()
    import torch

    phase_build()
    max_abs, times, k1_bound = phase_kernel()
    launches, cfg, pipe, inv = phase_slice()
    k2 = phase_k2(cfg, pipe, inv)
    k3 = phase_k3()
    k3_launches = phase_da()
    k4 = phase_k4()
    k4_launches = phase_fom_cli(k4)
    k4c = phase_k4c(k4)
    k5 = phase_k5(k3)
    k_ms, p_ms = times[B_CHECK]
    t3 = k3["times"][1024]
    t4r = k4["times"][K4_BATCHES[0]]
    # K4c and K4 at res40, B = 8: the batch at which the plain version is
    # timed on the same inputs (phase K4c; the main path's 256 is timed there too)
    t4c, t4, p40 = k4c["times"]["K4c", 8], k4c["times"]["K4", 8], k4c["times"]["plain", 8]["ms"]
    print(json.dumps({"kernels": [
        _kernel_entry("pcg_stencil", "pcg_stencil.cu", "bayesianinferencedl_tpu/ops/pcg_stencil.py:236",
                      launches, max_abs, k_ms, p_ms, k1_bound),
        _kernel_entry("pcn_fused", "pcn_fused.cu", "bayesianinferencedl_tpu/experimental/pcn_fused.py:67",
                      k2["launches"], k2["max_abs_err"], k2["ms"], k2["plain_ms"], k2["bound"]),
        _kernel_entry("pcg_stencil_tile_mma", "pcg_stencil_tile_mma.cu",
                      "bayesianinferencedl_tpu/ops/pcg_stencil.py:385", k3_launches,
                      k3["max_abs_err"], t3["ms"], t3["plain_ms"], t3["bound"]),
        # K3, off the main path since K3r: timed on the same inputs, for the record
        _kernel_entry("pcg_stencil_tile", "pcg_stencil_tile.cu",
                      "bayesianinferencedl_tpu/ops/pcg_stencil.py:385", 0,
                      k3["k3_max_abs_err"], t3["k3_ms"], t3["plain_ms"], t3["k3_bound"]),
        _kernel_entry("pcg_stencil_grid_cluster", "pcg_stencil_grid_cluster.cu",
                      "bayesianinferencedl_tpu/ops/pcg_stencil.py:58", k4_launches["K4c"],
                      k4c["max_abs_err"]["K4c"], t4c["ms"], p40, t4c["bound"]),
        # K4, off the main path since K4c: timed on the same inputs, for the record
        _kernel_entry("pcg_stencil_grid", "pcg_stencil_grid.cu",
                      "bayesianinferencedl_tpu/ops/pcg_stencil.py:58", 0,
                      max(k4["max_abs_err"]["K4"], k4c["max_abs_err"]["K4"]), t4["ms"], p40, t4["bound"]),
        _kernel_entry("pcg_stencil_grid_resident", "pcg_stencil_grid_resident.cu",
                      "bayesianinferencedl_tpu/ops/pcg_stencil.py:58", k4_launches["K4r"],
                      k4["max_abs_err"]["K4r"], t4r["ms"], t4r["plain_ms"], t4r["bound"]),
        _kernel_entry("shift_cost", "shift_cost.cu", "scripts/diag_roll_cost.py:27", k5["launches"],
                      k5["max_abs_err"], k5["ms"], k5["plain_ms"], k5["bound"]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
