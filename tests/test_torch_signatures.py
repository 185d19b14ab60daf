"""The reference's public options on the port: every keyword of every
public function, method and class method that both packages define, and
every flag of every CLI command both define, is accepted by the port,
outside a named exclusion list with a reason on each entry. Then replays
of the options added for that against JAX on the CPU: refine_steps=1,
deflate=False, adapt=False (a run_pcn on injected draws, to rounding),
val_frac=0 (the same carried weights and batches), the svgd --segment
argv and generate_error_dataset(lo=, hi=, chunk=)."""

import argparse
import importlib
import inspect
import json
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import bayesianinferencedl_tpu as R
import bayesianinferencedl_tpu_torch as P

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

# keyword -> why the port does not take it
EXCLUDED = {
    "key": "JAX PRNG keys: the port takes a torch.Generator (generator= / gen) and pre-drawn draws",
    "batched": "the port's misfits and forwards are always batched",
    "batched_fine": "the port's misfits and forwards are always batched",
    "batched_coarse": "the port's misfits and forwards are always batched",
    "use_pallas": "the port routes by device: the kernels on a card, their plain versions on the CPU",
}
# (qualified name, keyword) -> why
EXCLUDED_AT = {}
# flags of the reference CLI the port does not take
EXCLUDED_FLAGS = {}


def _modules(pkg):
    out = {}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if m.name.endswith(".cli") or ".experimental" in m.name:
            continue
        out[m.name[len(pkg.__name__) + 1:]] = importlib.import_module(m.name)
    return out


def _callables(mod):
    """(name, reference callable) of the module's own public functions,
    jitted ones included, and its classes' public methods."""
    for name, f in vars(mod).items():
        if name.startswith("_") or getattr(f, "__module__", None) != mod.__name__:
            continue
        if inspect.isclass(f):
            for k, v in vars(f).items():
                if not k.startswith("_") and (inspect.isfunction(v) or isinstance(v, (classmethod, staticmethod))):
                    yield f"{name}.{k}", getattr(f, k)
        elif callable(f):
            yield name, f


def _keywords(f):
    sig = inspect.signature(inspect.unwrap(f))
    return {p: v for p, v in sig.parameters.items()
            if v.default is not v.empty or v.kind == v.KEYWORD_ONLY}


def test_every_reference_keyword_is_accepted():
    rm, pm = _modules(R), _modules(P)
    refused, checked = [], 0
    for name in sorted(set(rm) & set(pm)):
        for qual, f in _callables(rm[name]):
            g = pm[name]
            for part in qual.split("."):
                g = getattr(g, part, None)
            if g is None:
                continue
            try:
                theirs = _keywords(f)
                ours = inspect.signature(g).parameters
            except (TypeError, ValueError):
                continue
            if any(p.kind == p.VAR_KEYWORD for p in ours.values()):
                continue
            for kw in theirs:
                checked += 1
                if kw not in ours and kw not in EXCLUDED and (f"{name}.{qual}", kw) not in EXCLUDED_AT:
                    refused.append(f"{name}.{qual}({kw}=)")
    assert checked > 500
    assert not refused, refused


class _Parsed(Exception):
    pass


def _commands(main, monkeypatch) -> dict:
    """{command: set of option strings} of a CLI's parser, captured at its
    parse_args without running anything."""
    got = {}

    def capture(self, *a, **k):
        got["p"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed):
            main([])
    sub = next(a for a in got["p"]._actions if isinstance(a, argparse._SubParsersAction))
    return {c: {s for a in p._actions for s in a.option_strings} for c, p in sub.choices.items()}


def test_every_reference_flag_is_accepted(monkeypatch):
    from bayesianinferencedl_tpu import cli as jcli
    from bayesianinferencedl_tpu_torch import cli as tcli

    ref, port = _commands(jcli.main, monkeypatch), _commands(tcli.main, monkeypatch)
    assert set(ref) <= set(port), set(ref) - set(port)
    refused = {c: sorted(ref[c] - port[c] - set(EXCLUDED_FLAGS)) for c in ref}
    assert not any(refused.values()), refused
    for c in ("invert-ff", "evidence-ff"):
        assert "--shard" in port[c]


def test_every_reference_module_has_a_counterpart():
    """Each .py module of the JAX package has a module at the same path in
    the port."""
    from pathlib import Path

    ref_root, port_root = Path(R.__file__).parent, Path(P.__file__).parent
    mods = sorted(p.relative_to(ref_root) for p in ref_root.rglob("*.py"))
    assert len(mods) > 60
    missing = [str(m) for m in mods if not (port_root / m).is_file()]
    assert not missing, missing


# --- replays -------------------------------------------------------------------


@pytest.fixture(scope="module")
def fins():
    from bayesianinferencedl_tpu.models.five_param import FiveParamFin as JFin
    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin

    return (JFin.create(resolution=1, dtype=jnp.float32),
            FiveParamFin.create(resolution=1, dtype=torch.float32, device="cpu"))


def test_refine_steps_replays_reference(fins):
    from bayesianinferencedl_tpu.fem.solve import solve_fom as j_solve
    from bayesianinferencedl_tpu_torch.fem.solve import solve_fom

    jfin, fin = fins
    k = np.array([0.4, 1.7, 3.1, 0.9, 1.2], np.float32)
    op64 = type(fin.op).from_host(fin.host, biot=0.1, dtype=torch.float64, device="cpu")
    A64 = lambda u: op64.apply(torch.from_numpy(k.astype(np.float64)), u.double())
    res = lambda u: float(torch.linalg.norm(op64.F_root - A64(u)))
    u0 = solve_fom(fin.op, torch.from_numpy(k), tol=1e-6, maxiter=3000)
    u1 = solve_fom(fin.op, torch.from_numpy(k), tol=1e-6, maxiter=3000, refine_steps=1)
    uj = np.asarray(j_solve(jfin.op, jnp.asarray(k), tol=1e-6, maxiter=3000, refine_steps=1))
    assert res(u1) < res(u0)
    assert np.linalg.norm(u1.numpy() - uj) <= 1e-6 * np.linalg.norm(uj)
    # the adjoint solve refines too, as under custom_linear_solve
    w = torch.tensor([1.0, -0.5, 0.3, 0.2, 0.8])
    kt = torch.from_numpy(k).requires_grad_()
    (g,) = torch.autograd.grad(torch.dot(w, fin.op.observe(solve_fom(fin.op, kt, tol=1e-6, maxiter=3000,
                                                                     refine_steps=1))), kt)
    gj = jax.grad(lambda kk: jnp.dot(jnp.asarray(w.numpy()), jfin.op.observe(
        j_solve(jfin.op, kk, tol=1e-6, maxiter=3000, refine_steps=1))))(jnp.asarray(k))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-7)


def test_undeflated_solver_replays_reference(fins):
    from bayesianinferencedl_tpu.api import make_fom_solver as j_make
    from bayesianinferencedl_tpu_torch.api import make_fom_solver

    jfin, fin = fins
    ks = np.exp(np.random.default_rng(3).uniform(np.log(0.1), np.log(10), (4, 5))).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        u_j = np.asarray(j_make(jfin, tol=1e-6, maxiter=800, use_pallas=True, deflate=False)(jnp.asarray(ks)))
    u_t, it_t = make_fom_solver(fin, tol=1e-6, maxiter=800, deflate=False, with_iters=True)(torch.from_numpy(ks))
    _, it_d = make_fom_solver(fin, tol=1e-6, maxiter=800, with_iters=True)(torch.from_numpy(ks))
    for b in range(4):
        assert np.linalg.norm(u_t[b].numpy() - u_j[b]) < 5e-5 * np.linalg.norm(u_j[b])
    assert np.all(it_t.numpy() > 2 * it_d.numpy())


def test_run_pcn_without_adaptation_replays_reference():
    from bayesianinferencedl_tpu.infer import pcn as jp
    from bayesianinferencedl_tpu.infer.priors import GaussianPrior as JPrior
    from bayesianinferencedl_tpu_torch.infer import pcn as tp
    from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior

    C, D, n_steps, n_burn = 16, 5, 30, 10
    Mx = np.random.default_rng(0).normal(size=(D, 4))
    data = np.array([0.3, -0.2, 0.5, 0.1])
    mj = jp.gaussian_misfit(lambda t: jnp.tanh(t) @ jnp.asarray(Mx), jnp.asarray(data), 0.1)
    mt = tp.gaussian_misfit(lambda t: torch.tanh(t) @ torch.from_numpy(Mx), torch.from_numpy(data), 0.1)
    theta0 = np.random.default_rng(2).normal(0, 0.6, (C, D))
    beta = np.linspace(0.05, 0.5, C)
    key = jax.random.PRNGKey(9)
    rj = jp.run_pcn(mj, JPrior.iid(D, sigma=0.6, dtype=jnp.float64), jnp.asarray(theta0), key,
                    n_steps=n_steps, n_burn=n_burn, beta=jnp.asarray(beta), adapt=False, batched=True)
    k_burn, k_main = jax.random.split(key)
    keys = list(jax.random.split(k_burn, n_burn)) + list(jax.random.split(k_main, n_steps - n_burn))
    draws = [jax.random.split(k) for k in keys]
    nrm = np.stack([np.asarray(jax.random.normal(a, (C, D), jnp.float64)) for a, _ in draws])
    uni = np.stack([np.asarray(jax.random.uniform(b, (C,), jnp.float64)) for _, b in draws])
    rt = tp.run_pcn(mt, GaussianPrior.iid(D, sigma=0.6, dtype=torch.float64, device="cpu"),
                    torch.from_numpy(theta0), n_steps=n_steps, n_burn=n_burn, beta=torch.from_numpy(beta),
                    adapt=False, normals=torch.tensor(nrm), uniforms=torch.tensor(uni))
    # frozen: no Robbins-Monro update (exp(log beta) either side)
    np.testing.assert_allclose(rt.beta.numpy(), beta, rtol=1e-15, atol=0)
    np.testing.assert_allclose(np.asarray(rj.beta), beta, rtol=1e-15, atol=0)
    np.testing.assert_allclose(rt.samples.numpy(), np.asarray(rj.samples), rtol=1e-12, atol=1e-12)


def test_train_surrogate_without_validation_split_replays_reference():
    from bayesianinferencedl_tpu.models import surrogate as js
    from bayesianinferencedl_tpu_torch.models import surrogate as ts

    rng = np.random.default_rng(5)
    x, y = rng.normal(size=(40, 3)), rng.normal(size=(40, 2))
    steps, batch, hidden, seed = 25, 8, (6,), 4
    sj, _ = js.train_surrogate(jnp.asarray(x), jnp.asarray(y), hidden=hidden, batch_size=batch,
                               steps=steps, seed=seed, val_frac=0.0)
    # the reference's draws: its init key and one randint per step over the
    # doubled rows' training half (n_val = 0 validates on the training rows)
    key, init_key = jax.random.split(jax.random.PRNGKey(seed))
    p0 = js.MLP(sizes=(3, *hidden, 2), activation="tanh").init(init_key, dtype=jnp.float64)
    idx = np.stack([np.asarray(jax.random.randint(k, (batch,), 0, 40)) for k in jax.random.split(key, steps)])
    st, _ = ts.train_surrogate(torch.from_numpy(x), torch.from_numpy(y), hidden=hidden, batch_size=batch,
                               steps=steps, seed=seed, val_frac=0.0,
                               params=[(np.array(W), np.array(b)) for W, b in p0],
                               idx=torch.from_numpy(idx))
    for (Wj, bj), (Wt, bt) in zip(sj.params, st.params):
        np.testing.assert_allclose(Wt.detach().numpy(), np.asarray(Wj), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(bt.detach().numpy(), np.asarray(bj), rtol=1e-10, atol=1e-12)


def test_svgd_segment_argv(capsys, monkeypatch):
    from test_torch_slice import cached_build_pipeline

    from bayesianinferencedl_tpu_torch import api, cli as tcli

    monkeypatch.setattr(api, "build_pipeline", cached_build_pipeline)  # one build for both runs

    argv = ["svgd", "--resolution", "1", "--n-snapshots", "16", "--r", "4", "--n-train", "32",
            "--epochs", "2", "--particles", "8", "--steps", "4", "--noise", "1e-2"]
    outs = []
    for extra in ([], ["--segment", "2"]):
        tcli.main(argv + ["--device", "cpu"] + extra)
        outs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    outs[0].pop("wall_seconds", None), outs[1].pop("wall_seconds", None)
    assert outs[0].keys() == outs[1].keys()
    for k in ("misfit_first_last", "n_forward_evals"):
        assert outs[0][k] == outs[1][k]


def test_generate_error_dataset_options(fins):
    from bayesianinferencedl_tpu.fem.solve import solve_fom as j_solve
    from bayesianinferencedl_tpu_torch.data.datasets import generate_error_dataset
    from bayesianinferencedl_tpu_torch.rom.galerkin import ReducedOperator
    from bayesianinferencedl_tpu_torch.fem.dia import StencilOperator
    from bayesianinferencedl_tpu.fem.dia import StencilOperator as JStencil

    _, fin = fins
    op = StencilOperator.from_host(fin.host, biot=0.1, dtype=torch.float64, device="cpu")
    V = np.linalg.qr(np.random.default_rng(0).normal(size=(op.n, 4)))[0]
    rom = ReducedOperator.project_host(fin.host, 0.1, V, dtype=torch.float64, device="cpu")
    gen = lambda: torch.Generator().manual_seed(7)
    kw = dict(lo=0.5, hi=2.0, tol=1e-12, maxiter=3000)
    a = generate_error_dataset(op, rom, gen(), 7, chunk=3, **kw)
    b = generate_error_dataset(op, rom, gen(), 7, **kw)
    ks = torch.exp(a.log_k).numpy()
    assert ks.min() >= 0.5 and ks.max() <= 2.0
    torch.testing.assert_close(a.y_fom, b.y_fom, rtol=0, atol=1e-14)
    jop = JStencil.from_host(fin.host, biot=0.1, dtype=jnp.float64)
    y_j = jax.vmap(lambda k: jop.observe(j_solve(jop, k, tol=1e-12, maxiter=3000)))(jnp.asarray(ks))
    np.testing.assert_allclose(a.y_fom.numpy(), np.asarray(y_j), rtol=1e-10)
    np.testing.assert_allclose(a.error.numpy(), (a.y_fom - rom.forward(torch.from_numpy(ks))).numpy(),
                               rtol=0, atol=1e-14)
