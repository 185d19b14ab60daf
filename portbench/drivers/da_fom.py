"""Delayed acceptance on the exact FOM posterior: the window driver.

Set-up builds the pipeline from the seed (``api.build_pipeline``: snapshots,
POD, projection, error dataset, training), makes the observations of the fin
being calibrated (a synthetic truth and its noise, fixed by the mix's data
seed so that every run samples one posterior; solved by the plain
reference), draws the chains' starts from the prior, and runs a short burn-in of
``run_da_pcn`` that adapts the inner step sizes. The window then drives the
sampler one outer step at a time, as ``run_da_pcn``'s sampling loop does:
``da_step`` on the carried state with the frozen step sizes, the rom_nn
coarse misfit and the fom fine misfit that ``api.run_inversion`` builds for
da_pcn on fom. Every step's draws (the subchain's normals and uniforms, the
outer uniform) come from the benchmark's generator and are handed to the
step, so the reference can replay it.

After the window a sample of outer steps and chains, drawn from the seed, is
checked against the plain reference in float64: the fine misfit at the state
each step started from and at its proposal (``fine_gap``), the coarse
misfit carried at those states (``coarse_gap``), and a replay of each
followed chain's subchain and outer accept that must land where the package
did (``wrong_moves``, a count). The coarse side follows the package's own
build: the reference projects the fin onto the package's basis itself and
evaluates the package's MLP weights itself. That state is held by itself
against the reference's full-order solve at the same states: the ROM+NN it
makes must lie within ``model_gap`` of the FOM's observables.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import trace as tr
from portbench.drivers import common
from portbench.harness import say
from portbench.reference import fin5
from portbench.yardstick.traffic import sample_log_uniform, sub_seeds

# two chain states in log k this close are one state: float32 rounding over a
# subchain moves a chain ~1e-6, one differing accept by beta sigma |xi| ~ 1e-2
SAME = 1e-4


class _State:
    pass


def _draws(gen, S, C, d, dev):
    normals = torch.randn((S, C, d), generator=gen, device=dev)
    uniforms = torch.rand((S, C), generator=gen, device=dev)
    outer = torch.rand((C,), generator=gen, device=dev)
    return normals, uniforms, outer


def setup(run):
    from bayesianinferencedl_tpu_torch import api
    from bayesianinferencedl_tpu_torch.infer import delayed_acceptance as da
    from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit
    from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

    cfg, p, dev = run.config, run.params, run.device
    seeds = sub_seeds(run.seed, 6)
    st = _State()
    st.pcfg = common.pipeline_config(cfg, run.cell.mix, seeds)
    log = MetricsLogger()
    st.pipe = pipe = api.build_pipeline(st.pcfg, device=dev, metrics=log)
    common.log_events(log.events)
    st.ref_fin = fin5.Fin.build(cfg["resolution"], cfg["biot"], device=dev)
    st.gen = gen = torch.Generator(device=dev).manual_seed(seeds[3])
    C, S, d, sigma = p["chains"], p["subchain"], 5, p["noise_sigma"]
    st.sigma = sigma

    # the fin being calibrated: a synthetic truth drawn from the prior and its
    # noisy observations, both fixed by the mix's data seed (so every run
    # samples the same posterior), the observations solved by the reference
    g_data = torch.Generator().manual_seed(p["data_seed"])
    theta_true = cfg["prior_mean"] + cfg["prior_sigma"] * torch.randn((1, d), generator=g_data,
                                                                       dtype=torch.float64)
    noise = sigma * torch.randn((d,), generator=g_data, dtype=torch.float64)
    u_true, _ = st.ref_fin.solve(torch.exp(theta_true).to(dev))
    st.data = (st.ref_fin.observe(u_true)[0] + noise.to(dev)).float()
    say(f"[setup] truth log k {[round(v, 4) for v in theta_true[0].tolist()]}, data "
        f"{[round(v, 6) for v in st.data.tolist()]}")

    st.fine_log = []  # per call of the fine misfit in the window: [theta, phi, iters, kernel]
    st.coarse_log = []  # per outer step in the window: the subchain endpoint's coarse misfit
    st.fine_events = []
    st.recording = False
    solve = api.make_fom_solver(pipe.fin, tol=pipe.fin.cg_tol, maxiter=pipe.fin.cg_maxiter,
                                with_iters=True)

    def fom_observables(theta):
        u, iters = solve(torch.exp(pipe.prior.to_theta(theta)))
        return pipe.fin.op.observe(u), iters

    st.fine_y = fom_observables  # the control puts the reference in its place

    def fine_forward(theta):
        before = common.launch_counts()
        y, iters = st.fine_y(theta)
        if st.recording:
            st.fine_log.append([theta, None, iters, common.carried_by(before, common.launch_counts())])
        return y

    misfit_fom = gaussian_misfit(fine_forward, st.data, sigma)
    timed = dev.type == "cuda"

    def misfit_fine(theta):
        if st.recording and timed:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        with tr.span("portbench.fine_misfit", run.trace):
            phi = misfit_fom(theta)
        if st.recording:
            st.fine_log[-1][1] = phi
            if timed:
                e1.record()
                st.fine_events.append((e0, e1))
        return phi

    st.misfit_fine = misfit_fine
    st.da = da
    _coarse_on(st, pipe.working_forward_fn("rom_nn"))  # the coarse forward run_inversion builds

    theta0 = pipe.prior.sample(gen, (C,))
    nb = p["burn_in"]
    normals = torch.randn((nb, S, C, d), generator=gen, device=dev)
    uniforms = torch.rand((nb, S, C), generator=gen, device=dev)
    outer = torch.rand((nb, C), generator=gen, device=dev)
    burn = da.run_da_pcn(st.misfit_fine, st.misfit_coarse, pipe.prior, theta0, None, n_steps=nb,
                         n_burn=nb, beta=p["beta"], subchain=S, normals=normals, uniforms=uniforms,
                         outer_uniforms=outer)
    st.state, st.beta = burn.state, burn.beta
    common.sync(dev)
    say(f"[setup] burn-in {nb} outer steps: beta {common.stats(burn.beta.cpu().numpy() * 1e4)} (x1e-4)")
    rng = np.random.default_rng(seeds[4])
    st.chains = np.sort(rng.choice(C, size=min(p["check_chains"], C), replace=False))
    st.check_seed = seeds[5]
    st.model = None  # the coarse state the check reads, where the control puts its own
    return st


def _coarse_on(st, fwd) -> None:
    """The coarse misfit on the forward ``fwd`` and the subchain kernel on
    it, whose endpoint misfit (what ``da_step`` corrects with) is recorded
    in the window."""
    from bayesianinferencedl_tpu_torch.infer.pcn import gaussian_misfit

    st.misfit_coarse = gaussian_misfit(fwd, st.data, st.sigma)
    kernel = st.da.make_inner_kernel("pcn", st.misfit_coarse, st.pipe.prior)
    endpoint = kernel.phi

    def phi(inner):
        v = endpoint(inner)
        if st.recording:
            st.coarse_log.append(v)
        return v

    st.kernel = kernel._replace(phi=phi)


def window(run, st):
    p, dev = run.params, run.device
    C, S, d = p["chains"], p["subchain"], 5
    st.steps = []
    st.finite = []
    st.step_t = []
    queue = common.Queue(dev)
    traced = common.Traced(run, queue)
    st.recording = True
    before = common.launch_counts()
    traced.start()
    run.mark_window_start()
    clock = common.Clock(dev)
    while True:
        normals, uniforms, outer = _draws(st.gen, S, C, d, dev)
        with tr.span("portbench.da_step", run.trace):
            new, acc, _ = st.da.da_step(st.misfit_fine, st.kernel, st.beta, S, st.state, None,
                                        normals=normals, uniforms=uniforms, outer_uniform=outer)
        st.steps.append((st.state, new, acc, normals, uniforms, outer, st.fine_log[-1],
                         st.coarse_log[-1]))
        st.finite.append(torch.isfinite(new.phi_f).sum())
        st.state = new
        queue.enqueued()
        st.step_t.append(clock.elapsed())
        traced.step_done(st.step_t[-1])
        if st.step_t[-1] >= run.seconds and traced.finished():
            break
    run.window_s = clock.stop()
    st.recording = False
    after = common.launch_counts()
    n = len(st.steps)
    run.steps = n
    run.attempted = n * C
    run.failed = int(n * C - sum(int(f) for f in st.finite))
    run.e2e["samples_per_s"] = n * C / run.window_s
    its = [rec[2].cpu().numpy() for rec in st.fine_log[-n:]]
    for i, (rec, it) in enumerate(zip(st.fine_log[-n:], its)):
        run.solves.append({"kernel": rec[3], "B": C, "resolution": run.config["resolution"],
                           "m": _deflation_m(st), "iters": it, "traced": traced.covers(i)})
    run.traced_steps = sum(traced.covers(i) for i in range(n))
    run.traced_first = traced.first
    run.spans["step_ms"] = list(np.diff([0.0] + st.step_t) * 1e3)
    if st.fine_events:
        run.spans["fine_ms"] = [a.elapsed_time(b) for a, b in st.fine_events]
        say(f"[window] ms a step on the host clock {common.stats(run.spans['step_ms'])}; the fine "
            f"misfit (events) {common.stats(run.spans['fine_ms'])}")
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    carried = sorted({rec["kernel"] for rec in run.solves})
    say(f"[window] {n} outer steps of {C} chains in {run.window_s:.3f} s; fine solves {n}, carried by "
        f"{carried}; launches in the window {moved or 'none'}")
    all_its = np.concatenate(its) if its else np.zeros(0)
    say(f"[window] fine-solve iterations {common.stats(all_its)}, at the cap "
        f"({run.config['cg_maxiter']}) {int(np.sum(all_its >= run.config['cg_maxiter']))}")
    accept = float(torch.stack([s[2].float().mean() for s in st.steps]).mean()) if n else float("nan")
    say(f"[window] outer accept {accept:.4f}")


def _deflation_m(st) -> int:
    defl = st.pipe.fin.deflation_for_kernels()
    return 0 if defl is None else int(defl.m)


def check(run, st):
    """The sampled steps and chains against the plain reference (float64)."""
    p, dev, cfg = run.params, run.device, run.config
    sigma, S = p["noise_sigma"], p["subchain"]
    fin5.no_tf32()
    pipe = st.pipe
    model = st.model or _program_model(st)
    rng = np.random.default_rng(st.check_seed)
    n = len(st.steps)
    picked = np.sort(rng.choice(n, size=min(p["check_steps"], n), replace=False))
    ch = torch.as_tensor(st.chains, device=dev)
    beta = st.beta[ch].double()
    rec = []
    for t in picked:
        old, new, acc, normals, uniforms, outer, fine, phi_c_prop = st.steps[t]
        rec.append(dict(theta=old.theta[ch], phi_f=old.phi_f[ch], phi_c=old.phi_c[ch],
                        prop=fine[0][ch], phi_f_prop=fine[1][ch], phi_c_prop=phi_c_prop[ch],
                        new_theta=new.theta[ch],
                        new_phi_c=new.phi_c[ch], acc=acc[ch], normals=normals[:, ch],
                        uniforms=uniforms[:, ch], outer=outer[ch]))
    g = {k: torch.cat([r[k].double() if r[k].is_floating_point() else r[k] for r in rec],
                      1 if k in ("normals", "uniforms") else 0) for k in rec[0]}
    beta = beta.repeat(len(rec))
    # the package's state is no longer needed: free it before the reference runs
    st.steps = st.state = st.fine_log = st.pipe = st.kernel = None
    st.misfit_fine = st.misfit_coarse = pipe = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rom = fin5.RomNN.project(st.ref_fin, *model,
                             fin5.rom_iters(cfg["basis_size"], sigma, cfg["online_iters"]))
    m = g["theta"].shape[0]
    y_fine = _fine_observables(st.ref_fin, torch.cat([g["theta"], g["prop"]]))
    y_coarse = rom.forward(torch.cat([g["theta"], g["prop"]]))
    ff = fin5.misfit(y_fine, st.data, sigma)
    ff_old, ff_prop = ff[:m], ff[m:]
    cc = lambda th: fin5.misfit(rom.forward(th), st.data, sigma)
    fc = fin5.misfit(y_coarse, st.data, sigma)
    fc_old, fc_prop = fc[:m], fc[m:]
    accepted = g["acc"].bool()
    fc_new = cc(g["new_theta"])[accepted]
    pairs_f = ((g["phi_f"], ff_old), (g["phi_f_prop"], ff_prop))
    pairs_c = ((g["phi_c"], fc_old), (g["phi_c_prop"], fc_prop), (g["new_phi_c"][accepted], fc_new))
    fine_gap, fine_raw = _gap(pairs_f)
    coarse_gap, coarse_raw = _gap(pairs_c)
    model_gap = float(torch.linalg.norm(y_coarse - y_fine, dim=1).max()) / sigma

    # replay each chain's subchain on the reference's coarse misfit; a chain
    # with a decision within twice what the coarse limit allows of its
    # threshold is not followed
    lim_c = run.limit("coarse_gap")
    theta, phi = g["theta"], fc_old
    followed = torch.ones(m, dtype=torch.bool, device=dev)
    for i in range(S):
        prop = fin5.pcn_proposal(theta, g["normals"][i], beta, cfg["prior_mean"], cfg["prior_sigma"])
        phi_p = cc(prop)
        la, lu = phi - phi_p, torch.log(g["uniforms"][i].double())
        followed &= (lu - la).abs() > 2 * lim_c * (_scale(phi) + _scale(phi_p))
        take = lu < la
        theta = torch.where(take[:, None], prop, theta)
        phi = torch.where(take, phi_p, phi)
    # the outer accept on the package's own four misfits (each held to the
    # reference above), and the new state it implies
    la_out = (g["phi_f"] - g["phi_f_prop"]) - (g["phi_c"] - g["phi_c_prop"])
    lu_out = torch.log(g["outer"].double())
    decided = (lu_out - la_out).abs() > 1e-4  # float32 rounding of the package's own ratio
    want = torch.where(accepted[:, None], g["prop"], g["theta"])
    bad = followed & ((theta - g["prop"]).abs().amax(1) > SAME)
    bad |= decided & (accepted != (lu_out < la_out))
    bad |= (g["new_theta"] - want).abs().amax(1) > SAME
    wrong = int(bad.sum())
    say(f"[check] {m} chain-steps ({len(picked)} outer steps x {len(st.chains)} chains); every outer "
        f"accept and new state checked, {int(followed.sum())} subchains replayed (the others pass within "
        f"twice the coarse limit of an accept threshold)")
    say(f"[check] largest misfit gaps in nats: fine {fine_raw:.6g}, coarse {coarse_raw:.6g}; fine misfits "
        f"of the reference {common.stats(ff.cpu().numpy())}")
    run.checks = [("fine_gap", fine_gap, run.limit("fine_gap")), ("coarse_gap", coarse_gap, lim_c),
                  ("model_gap", model_gap, run.limit("model_gap")),
                  ("wrong_moves", float(wrong), run.limit("wrong_moves"))]


def _program_model(st) -> tuple:
    """The package's coarse state in float64: its basis on the fin's nodes,
    its MLP's weights and its normaliser."""
    pipe = st.pipe
    V = st.ref_fin.from_lattice(pipe.rom.V.double().T).T
    layers = [(W.double(), b.double()) for W, b in pipe.surrogate.params]
    return V, layers, tuple(a.double() for a in pipe.surrogate.norm)


def _scale(phi: torch.Tensor) -> torch.Tensor:
    """1 + sqrt(2 phi): a misfit's gap over this is the observables' gap in
    units of the noise (phi = |r|^2 / 2 sigma^2, d phi = r . dy / sigma^2)."""
    return 1.0 + torch.sqrt(2.0 * torch.clamp(phi, min=0.0))


def _gap(pairs) -> tuple[float, float]:
    """(largest gap in noise units, largest gap in nats) of the package's
    misfits against the reference's."""
    d = torch.cat([(mine - ref).abs() for mine, ref in pairs])
    s = torch.cat([_scale(ref) for _, ref in pairs])
    return float(torch.max(d / s)), float(torch.max(d))


def _fine_observables(fin: fin5.Fin, theta: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    return torch.cat([fin.observe(fin.solve(torch.exp(th.double()))[0]) for th in theta.split(chunk)])


def control(run, st) -> None:
    """Put the reference in the package's place one precision lower than
    the configuration states: the fine misfit from the reference's CG in
    bfloat16 (the FOM solve is float32, off the matrix units); the build's
    basis from the POD of the reference's snapshots solved in bfloat16 at
    the build's count of log-uniform draws; and the coarse forward from the
    reference's ROM+NN on that basis (with the package's MLP weights: the
    reference trains none) in float32 with TF32 products (the configuration
    runs its float32 products with TF32 off; the package's own "high" tier
    reads as close to float64 as "highest" does, PERF.md section 2)."""
    cfg, p, dev = run.config, run.params, run.device
    ref = st.ref_fin
    gen = torch.Generator(device=dev).manual_seed(st.check_seed)
    ks = sample_log_uniform(gen, cfg["n_snapshots"], dtype=torch.float64)
    snaps, _ = ref.solve(ks, tol=cfg["cg_tol"], maxiter=cfg["cg_maxiter"], dtype=torch.bfloat16)
    _, layers, norm = _program_model(st)
    st.model = (fin5.pod_basis(snaps, cfg["basis_size"]), layers, norm)
    rom32 = fin5.RomNN.project(ref, *st.model, fin5.rom_iters(cfg["basis_size"], p["noise_sigma"],
                                                              cfg["online_iters"])).to(torch.float32)

    def coarse_tf32(xs):
        with fin5.tf32():
            return rom32.forward(xs)

    def fom_bf16(theta):
        u, iters = ref.solve(torch.exp(theta.double()), tol=cfg["cg_tol"], maxiter=cfg["cg_maxiter"],
                             dtype=torch.bfloat16)
        return ref.observe(u).float(), iters

    st.fine_y = fom_bf16
    _coarse_on(st, coarse_tf32)
