"""A snapshot sweep: batches of FOM solves back to back, the window driver.

Set-up assembles the fin (``FiveParamFin.create``), builds the batched
solver that ``snapshots`` uses (``api.make_fom_solver`` at the
configuration's tolerance and cap, returning each sample's iteration count)
and solves one batch of the window's shape. The window then draws a fresh
batch of conductivities, log-uniform from the seed, for every solve, with at
most two batches queued on the device. It ends when the batch in flight at
``--seconds`` completes.

After the window a sample of the solution fields, two a batch drawn from the
seed, is held against the plain reference's float64 solve for the same
conductivities: ``solution_gap`` is the largest relative L2 distance over
the whole lattice the package returns (the nodes outside the fin must hold
0).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import trace as tr
from portbench.drivers import common
from portbench.harness import say
from portbench.reference import fin5
from portbench.yardstick.traffic import sample_log_uniform, sub_seeds


class _State:
    pass


def setup(run):
    from bayesianinferencedl_tpu_torch import api
    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin

    cfg, p, dev = run.config, run.params, run.device
    seeds = sub_seeds(run.seed, 3)
    st = _State()
    st.fin = FiveParamFin.create(resolution=cfg["resolution"], biot=cfg["biot"], dtype=torch.float32,
                                 device=dev, cg_tol=cfg["cg_tol"], cg_maxiter=cfg["cg_maxiter"])
    say(f"[setup] fin res{cfg['resolution']}: n {st.fin.op.n}, assembler {st.fin.assembler}")
    st.solve = api.make_fom_solver(st.fin, tol=cfg["cg_tol"], maxiter=cfg["cg_maxiter"],
                                   with_iters=True)
    st.gen = torch.Generator(device=dev).manual_seed(seeds[0])
    st.pick = np.random.default_rng(seeds[1])
    B = p["batch"]
    draw = lambda: sample_log_uniform(st.gen, B, lo=p["k_low"], hi=p["k_high"])
    st.draw = draw
    u, it = st.solve(draw())
    common.sync(dev)
    say(f"[setup] warm batch of {B}: iterations {common.stats(it.cpu().numpy())}")
    del u, it
    return st


def window(run, st):
    p, dev, cfg = run.params, run.device, run.config
    B, keep = p["batch"], p["check_per_batch"]
    st.kept_k, st.kept_u, finite, iters, kernels = [], [], [], [], []
    queue = common.Queue(dev)
    traced = common.Traced(run, queue)
    before = common.launch_counts()
    traced.start()
    run.mark_window_start()
    clock = common.Clock(dev)
    while True:
        ks = st.draw()
        c0 = common.launch_counts()
        with tr.span("portbench.fom_solve", run.trace):
            u, it = st.solve(ks)
        kernels.append(common.carried_by(c0, common.launch_counts()))
        idx = torch.as_tensor(np.sort(st.pick.choice(B, size=keep, replace=False)), device=dev)
        st.kept_k.append(ks[idx])
        st.kept_u.append(u[idx])
        finite.append(torch.isfinite(u).all(1).sum())
        iters.append(it)
        del u
        queue.enqueued()
        elapsed = clock.elapsed()
        traced.step_done(elapsed)
        if elapsed >= run.seconds and traced.finished():
            break
    run.window_s = clock.stop()
    after = common.launch_counts()
    n = len(iters)
    run.steps = n
    run.attempted = n * B
    run.failed = int(n * B - sum(int(f) for f in finite))
    run.e2e["fom_solves_per_s"] = n * B / run.window_s
    its = [i.cpu().numpy() for i in iters]
    defl = st.fin.deflation_for_kernels()
    m = 0 if defl is None else int(defl.m)
    for i, (k, it) in enumerate(zip(kernels, its)):
        run.solves.append({"kernel": k, "B": B, "resolution": cfg["resolution"], "m": m, "iters": it,
                           "traced": traced.covers(i)})
    run.traced_steps = sum(traced.covers(i) for i in range(n))
    run.traced_first = traced.first
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    all_its = np.concatenate(its)
    say(f"[window] {n} batches of {B} in {run.window_s:.3f} s; carried by {sorted(set(kernels))}; "
        f"launches in the window {moved or 'none'}")
    say(f"[window] iterations {common.stats(all_its)}, at the cap ({cfg['cg_maxiter']}) "
        f"{int(np.sum(all_its >= cfg['cg_maxiter']))}")


def check(run, st):
    """The kept solution fields against the reference's float64 solves."""
    cfg, dev = run.config, run.device
    fin5.no_tf32()
    ks = torch.cat(st.kept_k).double()
    u = torch.cat(st.kept_u).double()
    st.kept_u = st.solve = st.fin = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = fin5.Fin.build(cfg["resolution"], cfg["biot"], device=dev)
    gaps = []
    for kc, uc in zip(ks.split(16), u.split(16)):
        ur, _ = ref.solve(kc)
        full = torch.zeros_like(uc)
        full[:, ref.lattice] = ur
        gaps.append(torch.linalg.norm(uc - full, dim=1) / torch.linalg.norm(ur, dim=1))
    gaps = torch.cat(gaps)
    say(f"[check] {gaps.numel()} solution fields; relative gaps {common.stats(gaps.cpu().numpy() * 1e6)}"
        f" (x1e-6)")
    run.checks = [("solution_gap", float(gaps.max()), run.limit("solution_gap"))]


def control(run, st) -> None:
    """Put the reference in the package's place one precision lower than
    the configuration states: its CG in bfloat16 (the FOM solve is float32),
    the fields returned on the package's lattice."""
    cfg = run.config
    ref = fin5.Fin.build(cfg["resolution"], cfg["biot"], device=run.device)
    n = st.fin.op.n

    def solve_bf16(ks):
        u, iters = ref.solve(ks.double(), tol=cfg["cg_tol"], maxiter=cfg["cg_maxiter"],
                             dtype=torch.bfloat16)
        full = torch.zeros((ks.shape[0], n), dtype=torch.float32, device=ks.device)
        full[:, ref.lattice] = u.float()
        return full, iters

    st.solve = solve_bf16
