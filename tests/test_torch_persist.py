"""Pipeline persistence (utils/checkpoint.py, Pipeline.save / Pipeline.load)
against the JAX package's, and the ``surrogate`` and ``pipeline`` commands.

1. The npz module: leaves come back in order, cast to the exemplar's dtype,
   with the meta; a shape that differs from the exemplar's raises.
2. The port's leaf names are the key paths ``jax.tree_util`` gives the
   reference's saved tuple (rom, params, norm, P0, dataset).
3. A JAX-saved pipeline loads into the port: the rom_nn batched forward
   equals JAX's to 1e-12 in float64 and 1e-6 in float32, the dataset and
   the deployed iteration count come along.
4. A port-saved file loads in JAX's ``Pipeline.load`` with the same
   forward: a port build (float32, its own dataset) and a converted
   pipeline without a dataset (0 rows); the tier round-trips ("high").
5. ``surrogate`` prints the reference's keys (its float64 gradient check
   within 1e-6)
   and ``--out`` writes (params, Ahat, V) that JAX's ``load_checkpoint``
   reads; ``pipeline`` prints ``invert``'s keys.
Sizes: res1, r = 8, float64 where the JAX build is."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu import config as jcfg
from bayesianinferencedl_tpu.api import Pipeline as JPipeline
from bayesianinferencedl_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch import config as tcfg
from bayesianinferencedl_tpu_torch.cli import main
from bayesianinferencedl_tpu_torch.utils.checkpoint import load_checkpoint, read_meta, save_checkpoint
from test_torch_approx_api import _cfg as _cfg32
from test_torch_slice import _cfg, cached_build_pipeline, jax_build

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

D = 5


def _forward_pair(jpipe, tpipe, n=16, seed=0):
    thetas = np.random.default_rng(seed).normal(0.0, 0.6, (n, D))
    yj = np.asarray(jpipe.batched_forward_fn("rom_nn")(jnp.asarray(thetas, jpipe.P0.dtype)))
    yt = tpipe.batched_forward_fn("rom_nn")(torch.tensor(thetas, dtype=tpipe.P0.dtype)).numpy()
    return yj, yt


def test_checkpoint_leaves_dtypes_meta_and_shapes(tmp_path):
    path = tmp_path / "c.npz"
    save_checkpoint(path, [torch.arange(6, dtype=torch.float32).reshape(2, 3), np.ones(4, np.int32)],
                    meta={"step": 3, "names": ["a", "b"]})
    leaves, meta = load_checkpoint(path, [("a", (2, 3), np.float64), ("b", None, np.int64)])
    assert meta == {"step": 3, "names": ["a", "b"]} and read_meta(path) == meta
    assert leaves["a"].dtype == np.float64 and leaves["b"].dtype == np.int64
    np.testing.assert_array_equal(leaves["a"], np.arange(6).reshape(2, 3))
    # the JAX package reads the same file
    (a, b), jmeta = j_load_checkpoint(path, (jnp.zeros((2, 3), jnp.float32), jnp.zeros(4, jnp.int32)))
    assert jmeta == meta
    np.testing.assert_array_equal(np.asarray(a), leaves["a"])
    with pytest.raises(ValueError, match="leaf_0"):
        load_checkpoint(path, [("a", (3, 2), np.float32)])


@pytest.fixture(scope="module")
def jax64():
    return jax_build(_cfg(1e-10, jcfg), jnp.float64)


def test_leaf_names_are_the_reference_key_paths(jax64):
    tree = (jax64.rom, jax64.surrogate.params, jax64.surrogate.norm, jax64.P0, jax64.dataset)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    names = [n for n, _ in api._pipeline_layout(jax64.rom.r, tuple(jax64.surrogate.mlp.sizes))]
    assert names == paths


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-6)])
def test_jax_saved_pipeline_loads_into_the_port(tmp_path, jax64, dtype, tol):
    jpipe = jax64 if dtype == "float64" else jax_build(_cfg32(jcfg), jnp.float32)
    jpipe.save(str(tmp_path / "j.npz"))
    tpipe = api.Pipeline.load(tmp_path / "j.npz", device="cpu", dtype=getattr(torch, dtype))
    yj, yt = _forward_pair(jpipe, tpipe)
    np.testing.assert_allclose(yt, yj, rtol=tol, atol=tol * np.abs(yj).max())
    assert tpipe.rom_pcg_iters == jpipe.rom_pcg_iters and tpipe.rom_precision == "highest"
    assert tpipe.config.to_dict() == jpipe.config.to_dict()
    np.testing.assert_array_equal(tpipe.dataset.y_rom.numpy(), np.asarray(jpipe.dataset.y_rom))
    assert tpipe.fin.op.n == jpipe.fin.op.n


def test_port_saved_pipelines_load_in_jax(tmp_path, jax64):
    # a port build, float32, with its own dataset
    cfg = tcfg.PipelineConfig(
        mesh=tcfg.MeshConfig(resolution=1), fem=tcfg.FEMConfig(biot=0.1, cg_tol=1e-7, cg_maxiter=1500),
        rom=tcfg.ROMConfig(n_snapshots=32, basis_size=8), surrogate=tcfg.SurrogateConfig(
            hidden=(16, 16), n_train=64, epochs=5), mcmc=tcfg.MCMCConfig(noise_sigma=1e-2))
    tpipe = cached_build_pipeline(cfg, device="cpu")
    tpipe.save(tmp_path / "t.npz")
    jpipe = JPipeline.load(str(tmp_path / "t.npz"), dtype=jnp.float32)
    yj, yt = _forward_pair(jpipe, tpipe)
    # Two float32 evaluations of the same forward on the same arrays. The
    # rom_nn forward is dominated by the reduced solve A(k) u = F: rounding
    # its matrix and load to float32 (relative u = 2^-24 an entry) moves u by
    # at most kappa(A(k)) (u + u) relative, to first order, in each package,
    # so the two differ by at most 4 u kappa(A(k)) relative a sample, kappa
    # the 2-norm condition number of the float64 reduced operator at that
    # sample (15-88 here, so ~2e-6 to 2e-5: the former 1e-6 sat inside it).
    ks = torch.exp(tpipe.prior.to_theta(torch.tensor(np.random.default_rng(0).normal(0.0, 0.6, (16, D)))))
    rom64 = api.Pipeline.load(tmp_path / "t.npz", device="cpu", dtype=torch.float64).rom
    kappa = torch.linalg.cond(torch.einsum("bi,ijk->bjk", ks, rom64.Ahat) + rom64.biot * rom64.Mhat).numpy()
    rel = np.linalg.norm(yt - yj, axis=1) / np.linalg.norm(yj, axis=1)
    assert np.all(rel <= 4 * 2.0**-24 * kappa), (rel, kappa)
    np.testing.assert_array_equal(np.asarray(jpipe.dataset.error), tpipe.dataset.error.numpy())
    back = api.Pipeline.load(tmp_path / "t.npz", device="cpu")
    assert torch.equal(back.batched_forward_fn("rom_nn")(torch.zeros(3, D)),
                       tpipe.batched_forward_fn("rom_nn")(torch.zeros(3, D)))
    # a converted float64 pipeline: no dataset (0 rows), saved at the "high" tier
    jax64.save(str(tmp_path / "j.npz"))
    p64 = dataclasses.replace(api.Pipeline.load(tmp_path / "j.npz", device="cpu", dtype=torch.float64),
                              dataset=None)
    cfg_h = dataclasses.replace(p64.config, rom=dataclasses.replace(p64.config.rom, online_precision="high"))
    dataclasses.replace(p64, config=cfg_h).save(tmp_path / "h.npz")
    jh = JPipeline.load(str(tmp_path / "h.npz"), dtype=jnp.float64)
    assert jh.rom_precision == jax.lax.Precision.HIGH and jh.dataset.log_k.shape == (0, D)
    th = api.Pipeline.load(tmp_path / "h.npz", device="cpu", dtype=torch.float64)
    assert th.rom_precision == "high" and th.dataset is None
    # on the CPU JAX ignores the matmul precision: its "high" forward is the "highest" one
    yj, yt = _forward_pair(jh, dataclasses.replace(th, rom_precision="highest"))
    np.testing.assert_allclose(yt, yj, rtol=1e-12, atol=1e-12 * np.abs(yj).max())


SMALL = ["--device", "cpu", "--resolution", "1", "--n-snapshots", "32", "--r", "8", "--n-train", "64",
         "--epochs", "5"]


def test_surrogate_and_pipeline_commands(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(api, "build_pipeline", cached_build_pipeline)
    # in float64 (central differences at eps 1e-6): in float32 at eps 1e-3 the
    # difference quotient itself is off by up to ~1e-2
    main(["surrogate", *SMALL, "--dtype", "float64", "--out", str(tmp_path / "s.npz")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"rom_rel_err", "corrected_rel_err", "gradcheck_rel_err"}
    assert all(np.isfinite(v) for v in out.values()) and out["gradcheck_rel_err"] < 1e-6
    meta = read_meta(tmp_path / "s.npz")
    r, sizes = meta["rom"]["basis_size"], (D, *meta["surrogate"]["hidden"], D)
    params_ex = [(jnp.zeros((a, b), jnp.float32), jnp.zeros(b, jnp.float32))
                 for a, b in zip(sizes[:-1], sizes[1:])]
    (params, Ahat, V), jmeta = j_load_checkpoint(
        tmp_path / "s.npz", (params_ex, jnp.zeros((5, r, r), jnp.float32), jnp.zeros((1, r), jnp.float32)))
    assert jmeta == meta and Ahat.shape == (5, r, r) and V.shape[1] == r
    assert [p.shape for W_b in params for p in W_b] == [p.shape for W_b in params_ex for p in W_b]
    main(["pipeline", *SMALL, "--chains", "16", "--steps", "60", "--burn", "30", "--noise", "1e-2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"likelihood", "sampler", "samples_per_sec", "posterior_mean_log_k", "theta_true"} <= set(out)
    assert np.all(np.isfinite(out["posterior_mean_log_k"]))
