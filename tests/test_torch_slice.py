"""The slice as a whole: the port's offline build and pCN inversion.

1. A JAX pipeline built in float64 is carried into the port through
   convert.pipeline_from_arrays: the port's batched rom_nn forward equals
   JAX's to 1e-10, and pCN on that misfit, replaying JAX's draws from the
   same data and initial states, gives JAX's samples to 1e-9.
2. The port's own build_pipeline + run_inversion on the CPU in float32
   completes with finite outputs, the surrogate lowers the holdout error
   below the ROM's, and the acceptance rate is sane.
Sizes: res1, r = 8, 32 snapshots, 64 training samples, 20 epochs."""

import dataclasses
import fcntl
import hashlib
import os
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads SciPy's OpenBLAS before the thread limit)
import scipy.sparse.linalg  # noqa: F401
import threadpoolctl
import torch

from bayesianinferencedl_tpu import config as jcfg
from bayesianinferencedl_tpu.api import Pipeline as JPipeline
from bayesianinferencedl_tpu.api import build_pipeline as j_build
from bayesianinferencedl_tpu.infer import pcn as jp
from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch import config as tcfg
from bayesianinferencedl_tpu_torch.convert import pipeline_from_arrays
from bayesianinferencedl_tpu_torch.infer import pcn as tp
from bayesianinferencedl_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

C, D = 32, 5


def _run_dir(name: str) -> Path:
    """A directory of this test run under the temporary directory, shared
    by its worker processes."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID", str(os.getpid()))
    root = Path(tempfile.gettempdir()) / f"{name}_{run}"
    root.mkdir(parents=True, exist_ok=True)
    return root


# One JAX compilation cache for the test run: the port's files compile many of
# the same reference programs (the builds, the forwards, the CLIs' samplers)
# in several worker processes, and a worker that finds a program compiled by
# another loads it instead. Every worker imports this module when it collects.
jax.config.update("jax_compilation_cache_dir", str(_run_dir("bidl_jax_cache")))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

# NumPy's and SciPy's OpenBLAS (SciPy loads its own copy, so it is imported
# first) and OpenMP on one thread in each worker process, as torch's intra-op
# threads are pinned to one: the test workers share the machine's cores, and
# with a full thread pool in every worker, OpenBLAS's spinning threads made
# the host linear algebra (the deflation eigensolve, the POD) several times
# slower. Every worker imports this module when it collects.
threadpoolctl.threadpool_limits(1)


def _cfg(cg_tol, cfg=tcfg, **mcmc):
    """The test's PipelineConfig, from the port's config module (default) or
    the JAX package's (``cfg=jcfg``): each side is built from its own."""
    return cfg.PipelineConfig(
        mesh=cfg.MeshConfig(resolution=1),
        fem=cfg.FEMConfig(biot=0.1, cg_tol=cg_tol, cg_maxiter=1500),
        rom=cfg.ROMConfig(n_snapshots=32, basis_size=8),
        surrogate=cfg.SurrogateConfig(hidden=(16, 16), n_train=64, epochs=20),
        mcmc=cfg.MCMCConfig(noise_sigma=1e-2, **mcmc),
    )


def _arrays(jpipe) -> dict:
    """A JAX Pipeline's weights and state as plain arrays."""
    rom, sur = jpipe.rom, jpipe.surrogate
    out = {f: np.asarray(getattr(rom, f)) for f in ("Ahat", "Mhat", "Fhat", "Bhat", "V")}
    out["P0"] = np.asarray(jpipe.P0)
    for i, (W, b) in enumerate(sur.params):
        out[f"W{i}"], out[f"b{i}"] = np.asarray(W), np.asarray(b)
    out.update({f: np.asarray(getattr(sur.norm, f)) for f in ("x_mean", "x_std", "y_mean", "y_std")})
    out["rom_pcg_iters"] = np.asarray(jpipe.rom_pcg_iters)
    return out


def jax_build(cfg, dtype):
    """The JAX package's build_pipeline(cfg, dtype=dtype), built once per test
    run for each configuration: the first test process to ask builds it and
    saves it (``Pipeline.save``), the others load that file
    (``Pipeline.load``: the same arrays, mesh and config), under the run's
    temporary directory. The key leaves out the MCMC fields, of which the
    build reads only whether noise_sigma < 5e-4; the pipeline comes back
    under the asked-for config."""
    bare = dataclasses.replace(cfg, mcmc=jcfg.MCMCConfig(noise_sigma=1e-4 if cfg.mcmc.noise_sigma < 5e-4
                                                         else 1e-2))
    key = hashlib.sha256(f"{bare!r} {jnp.dtype(dtype).name}".encode()).hexdigest()[:16]
    root = _run_dir("bidl_jax_builds")
    path = root / f"{key}.npz"
    with open(root / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one builder; the others wait for its file
        if not path.exists():
            jpipe = j_build(cfg, dtype=dtype)
            jpipe.save(str(root / f"{key}.tmp.npz"))
            os.replace(root / f"{key}.tmp.npz", path)
            return jpipe
    return dataclasses.replace(JPipeline.load(str(path), dtype=dtype), config=cfg)


_BUILDS: dict = {}


def cached_build_pipeline(cfg, *, device="cuda", dtype=torch.float32, metrics=None, fin=None,
                          _build=api.build_pipeline):
    """api.build_pipeline, built once per process for each configuration: a
    repeat with the same fields but the MCMC ones (of which the build reads
    only noise_sigma) returns the first build under the asked-for config,
    and logs the first build's events into ``metrics`` again. The build is
    deterministic and no code of the port mutates a Pipeline, so the CLI
    tests run their commands on one build instead of one each. A build on a
    given fin (a sensor design's) is not cached."""
    if fin is not None:
        return _build(cfg, device=device, dtype=dtype, metrics=metrics, fin=fin)
    key = (repr(dataclasses.replace(cfg, mcmc=tcfg.MCMCConfig(noise_sigma=cfg.mcmc.noise_sigma))),
           str(device), str(dtype))
    if key not in _BUILDS:
        log = MetricsLogger()
        _BUILDS[key] = (_build(cfg, device=device, dtype=dtype, metrics=log), log.events)
    pipe, events = _BUILDS[key]
    if metrics is not None:
        for e in events:
            metrics.log(e["event"], **{k: v for k, v in e.items() if k not in ("event", "t")})
    return dataclasses.replace(pipe, config=cfg)


@pytest.fixture(scope="module")
def converted():
    jpipe = jax_build(_cfg(1e-10, jcfg), jnp.float64)
    tpipe = pipeline_from_arrays(_cfg(1e-10), _arrays(jpipe), device="cpu", dtype=torch.float64)
    return jpipe, tpipe


def test_converted_rom_nn_forward_equals_reference(converted):
    jpipe, tpipe = converted
    thetas = np.random.default_rng(0).normal(0.0, 0.6, (16, D))
    yj = np.asarray(jpipe.batched_forward_fn("rom_nn")(jnp.asarray(thetas)))
    yt = tpipe.batched_forward_fn("rom_nn")(torch.from_numpy(thetas)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-10, atol=1e-10 * np.abs(yj).max())
    # the Cholesky-based corrected forward agrees as well
    yc = np.asarray(jax.vmap(jpipe.corrected)(jnp.asarray(thetas)))
    np.testing.assert_allclose(tpipe.corrected(torch.from_numpy(thetas)).numpy(), yc,
                               rtol=1e-10, atol=1e-10 * np.abs(yc).max())
    np.testing.assert_allclose(tpipe.forward_fn("rom")(torch.from_numpy(thetas[0])).numpy(),
                               np.asarray(jpipe.forward_fn("rom")(jnp.asarray(thetas[0]))),
                               rtol=1e-10)


def test_converted_pcn_chain_replays_reference(converted):
    jpipe, tpipe = converted
    rng = np.random.default_rng(1)
    data = np.asarray(jpipe.batched_forward_fn("rom_nn")(jnp.asarray(rng.normal(0, 0.6, (1, D)))))[0]
    data = data + 1e-2 * rng.normal(size=data.shape)
    theta0 = rng.normal(0.0, 0.6, (C, D))
    n_steps, n_burn = 60, 20
    key = jax.random.PRNGKey(5)
    misfit_j = jp.gaussian_misfit(jpipe.batched_forward_fn("rom_nn"), jnp.asarray(data), 1e-2)
    rj = jp.run_pcn(misfit_j, jpipe.prior, jnp.asarray(theta0), key, n_steps=n_steps,
                    n_burn=n_burn, beta=0.25, batched=True)
    k_burn, k_main = jax.random.split(key)
    keys = list(jax.random.split(k_burn, n_burn)) + list(jax.random.split(k_main, n_steps - n_burn))
    nrm, uni = [], []
    for k in keys:
        k_prop, k_acc = jax.random.split(k)
        nrm.append(np.asarray(jax.random.normal(k_prop, (C, D), jnp.float64)))
        uni.append(np.asarray(jax.random.uniform(k_acc, (C,), jnp.float64)))
    misfit_t = tp.gaussian_misfit(tpipe.batched_forward_fn("rom_nn"), torch.from_numpy(data), 1e-2)
    rt = tp.run_pcn(misfit_t, tpipe.prior, torch.from_numpy(theta0), n_steps=n_steps,
                    n_burn=n_burn, beta=0.25, normals=torch.tensor(np.stack(nrm)),
                    uniforms=torch.tensor(np.stack(uni)))
    np.testing.assert_allclose(rt.samples.numpy(), np.asarray(rj.samples), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(rt.accept_rate.numpy(), np.asarray(rj.accept_rate), rtol=1e-6)


def test_port_build_and_inversion_on_cpu():
    cfg = _cfg(1e-7, n_chains=64, n_steps=400, n_burn=200)
    log = MetricsLogger()
    pipe = api.build_pipeline(cfg, device="cpu", metrics=log)
    inv = api.run_inversion(pipe, metrics=log)
    s = log.summary()
    hold = s["holdout_rel_err"]
    assert 0 < hold["corrected"] < hold["rom"], hold
    assert np.isfinite(s["rom_rel_err"]["value"]) and np.isfinite(s["corrected_rel_err"]["value"])
    res = inv.result
    assert res.samples.shape == (200, 64, D)
    for t in (res.samples, res.phi_trace, inv.ess, inv.ess_tail, inv.rhat, inv.data):
        assert torch.isfinite(t).all()
    assert 0.05 < float(res.accept_rate.mean()) < 0.9
    assert inv.samples_per_sec > 0 and 0.0 <= inv.ppc["p_value"] <= 1.0
    assert pipe.rom_pcg_iters == 15 and pipe.P0.dtype == torch.float32


def test_unported_options_raise(converted):
    _, tpipe = converted
    # mlda_pcn is ported; on this res1 pipeline its default mid rung (res2) is not coarser
    with pytest.raises(ValueError, match="must be coarser"):
        api.run_inversion(tpipe, sampler="mlda_pcn", likelihood="fom")
    # the "high" tier (bf16x3) is ported: the build runs at it and says so
    cfg = _cfg(1e-7)
    cfg = dataclasses.replace(cfg, rom=dataclasses.replace(cfg.rom, online_precision="high"))
    assert api.build_pipeline(cfg, device="cpu").rom_precision == "high"
    if not torch.cuda.is_available():  # the card is the default; absent, it raises, no CPU fallback
        with pytest.raises(RuntimeError, match="cuda"):
            api.build_pipeline(_cfg(1e-7))


def test_cli_invert_prints_reference_keys(capsys):
    import json

    from bayesianinferencedl_tpu_torch.cli import main

    main(["invert", "--device", "cpu", "--resolution", "1", "--n-snapshots", "32", "--r", "8",
          "--n-train", "64", "--epochs", "5", "--chains", "16", "--steps", "120", "--burn", "60",
          "--noise", "1e-2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {
        "likelihood", "sampler", "prior", "samples_per_sec", "ess_min", "ess_tail_min",
        "ess_per_sec", "accept_rate", "rhat_split_max", "posterior_mean_log_k", "theta_true",
        "ppc_p_value",
    }
    assert len(out["posterior_mean_log_k"]) == D and np.isfinite(out["samples_per_sec"])
