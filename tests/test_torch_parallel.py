"""The port's multi-device path (parallel/mesh.py, parallel/sharding.py,
parallel/dryrun.py) on the CPU: one gloo world of 4 ranks, started once for
the file, runs every multi-rank check (``torch_parallel_ranks.parallel_checks``)
and hands its results back through files; the JAX references run here on
a 4-device mesh of the conftest's 8 virtual devices.

- every chain-independent sharded family at a world of 4 equals the
  unsharded runner (a world of 1) from the same injected draws, to
  rounding in float64, the chains in rank-major order; a world of 1 in
  this process equals it bit for bit from the same generator;
- dp_train_step equals JAX's on 4 devices at 1e-12, sharded_snapshots
  JAX's at 1e-10;
- SVGD, ADVI, flow-VI and ChEES at a world of 4 equal their unsharded runs
  on the same ensemble or draws; each SMC island is run_smc on its rank's
  generator and the combined log Z is logsumexp(lz) - log 4;
- run_inversion(mesh=) reaches the sharded runners for da_pcn, pt_pcn,
  pt_da_pcn, pt_mala and mlda_pcn; invert --shard 2 --device cpu prints
  one JSON line; the dryrun runs every family;
- utils/roofline.py's counts equal the reference's, and profile_trace
  writes a Chrome trace."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_ranks import ROUTES, families, parallel_checks, problem

from bayesianinferencedl_tpu_torch.parallel.mesh import launch

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

FAMILIES = tuple(families(problem()))


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    launch(parallel_checks, 4, str(d), device="cpu")
    return d


def _npz(out, name):
    with np.load(out / f"{name}.npz") as z:
        return dict(z)


def _same(a: dict, b: dict, rtol=1e-12, atol=1e-12):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        if a[k].dtype.kind in "iub":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol, err_msg=k)


def test_collectives_on_four_ranks(out):
    ok = json.loads((out / "collectives.json").read_text())
    assert all(ok.values()), ok


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_family_equals_unsharded(out, name):
    sharded, plain = _npz(out, f"fam_{name}_sharded"), _npz(out, f"fam_{name}_plain")
    _same(sharded, plain)
    if "samples" in sharded:
        assert sharded["samples"].shape[1] == 8  # the whole batch on every rank


def test_world_of_one_is_the_unsharded_run_bit_for_bit():
    import torch.distributed as dist

    from bayesianinferencedl_tpu_torch.infer.pcn import run_pcn
    from bayesianinferencedl_tpu_torch.parallel.mesh import device_mesh
    from bayesianinferencedl_tpu_torch.parallel.sharding import sharded_pcn

    p = problem()
    th = torch.tensor(np.random.default_rng(1).normal(0.0, 0.8, (8, 3)))
    kw = dict(n_steps=12, n_burn=4, beta=0.3)
    try:
        mesh = device_mesh(1, device="cpu")
        a = sharded_pcn(mesh, p["fine"], p["prior"], th, torch.Generator().manual_seed(4), **kw)
    finally:
        dist.destroy_process_group()
    b = run_pcn(p["fine"], p["prior"], th, torch.Generator().manual_seed(4), **kw)
    for x, y in ((a.samples, b.samples), (a.beta, b.beta), (a.accept_rate, b.accept_rate)):
        assert torch.equal(x, y)


def test_dp_train_step_matches_reference(out):
    from bayesianinferencedl_tpu.models.surrogate import MLP, adam_init
    from bayesianinferencedl_tpu.parallel import device_mesh, dp_train_step

    rng = np.random.default_rng(5)
    W = [(rng.normal(0, 0.5, (5, 16)), rng.normal(0, 0.1, 16)), (rng.normal(0, 0.5, (16, 3)),
                                                                  rng.normal(0, 0.1, 3))]
    x, y = rng.standard_normal((64, 5)), rng.standard_normal((64, 3))
    params = [(jnp.asarray(a), jnp.asarray(b)) for a, b in W]
    mlp = MLP(sizes=(5, 16, 3), activation="tanh")
    step = jax.jit(lambda p, o, xb, yb: dp_train_step(device_mesh(4), mlp, p, o, xb, yb, 1e-3))
    p_j, _, loss_j = step(params, adam_init(params), jnp.asarray(x), jnp.asarray(y))
    got = _npz(out, "dp_train")
    np.testing.assert_allclose(got["loss"], float(loss_j), rtol=1e-12, atol=0)
    ref = [np.asarray(a) for Wb in p_j for a in Wb]
    for i, r in enumerate(ref):
        np.testing.assert_allclose(got[f"p{i}"], r, rtol=0, atol=1e-12)


def test_sharded_snapshots_match_reference(out):
    from bayesianinferencedl_tpu.fem.dia import StencilOperator, assemble_fin_dia
    from bayesianinferencedl_tpu.geometry import build_fin_mesh
    from bayesianinferencedl_tpu.parallel import device_mesh, sharded_snapshots

    got = _npz(out, "snapshots")
    op = StencilOperator.from_host(assemble_fin_dia(build_fin_mesh(1), pad_to=128), biot=0.1,
                                   dtype=jnp.float64)
    S_j = np.asarray(jax.jit(lambda ks: sharded_snapshots(device_mesh(4), op, ks, tol=1e-12))(
        jnp.asarray(got["ks"])))
    err = np.linalg.norm(got["S64"] - S_j, axis=1) / np.linalg.norm(S_j, axis=1)
    assert err.max() < 1e-10, err.max()
    # float32 through the kernels' route: each rank's block solved as the
    # whole batch is, to the float32 solver's tolerance (1e-6)
    d32 = np.linalg.norm(got["S32"] - got["S32_plain"], axis=1) / np.linalg.norm(got["S32_plain"], axis=1)
    assert d32.max() < 1e-5, d32.max()


@pytest.mark.parametrize("name", ("svgd", "advi", "chees"))
def test_sharded_approximation_equals_unsharded(out, name):
    _same(_npz(out, f"approx_{name}_sharded"), _npz(out, f"approx_{name}_plain"), rtol=1e-10)


def test_sharded_flow_vi_equals_unsharded(out):
    got = _npz(out, "approx_flow")
    np.testing.assert_allclose(got["elbo_sharded"], got["elbo_plain"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got["mean_sharded"], got["mean_plain"], rtol=1e-10, atol=1e-12)


def test_island_smc(out):
    got = _npz(out, "smc")
    assert got["islands_equal"].all()
    lz = got["lz"]
    assert lz.shape == (4,) and got["particles"].shape == (4, 16, 3) and got["n_stages"].shape == (4,)
    m = lz.max()
    np.testing.assert_allclose(got["log_evidence"], m + math.log(np.mean(np.exp(lz - m))), rtol=1e-12)


@pytest.mark.parametrize("sampler", [r[0] for r in ROUTES])
def test_run_inversion_routes_mesh(out, sampler):
    got = json.loads((out / "routes.json").read_text())[sampler]
    assert got["calls"] == 2, got  # the warm-up run and the timed run
    assert got["shape"] == [4, 8, 5] and got["finite"], got


def test_invert_shard_prints_one_line_from_rank_zero(capfd):
    from bayesianinferencedl_tpu_torch import cli as tcli

    tcli.main(["invert", "--device", "cpu", "--resolution", "1", "--n-snapshots", "16", "--r", "4",
               "--n-train", "32", "--epochs", "2", "--chains", "8", "--steps", "12", "--burn", "4",
               "--noise", "1e-2", "--sampler", "pt_pcn", "--n-temps", "3", "--shard", "2"])
    lines = [ln for ln in capfd.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert rec["sampler"] == "pt_pcn" and len(rec["posterior_mean_log_k"]) == 5
    assert math.isfinite(rec["log_evidence"])


def test_dryrun_runs_every_family(out):
    got = json.loads((out / "dryrun.json").read_text())
    assert list(got["families"]) == [
        "tiny_pipeline_build", "pcn_step+dp_train", "fom_domain_decomposed", "snapshots", "da_pcn",
        "pt_pcn", "pt_da", "mlda", "mala", "hmc", "hmc_chees", "pt_mala", "lis_pcn", "eki", "advi",
        "flow_vi", "svgd", "psis", "smc"]
    assert all(math.isfinite(v) and v >= 0 for v in got["families"].values())


@pytest.mark.parametrize("fn, args", [
    ("stencil_pcg_flops", (776, 640, 2811.0)),
    ("stencil_pcg_flops_flat", (24960, 64.0)),
    ("deflation_mxu_flops", (24960, 128, 64.0)),
    ("stencil_pcg_vmem_bytes_per_sample", (24960, 64.0)),
    ("stencil_pcg_xla_bytes", (776, 640, 2811.0)),
    ("rom_chain_step_flops", (40, 15, 5, 5)),
    ("pct", (3.2e12, 3.35e12)),
])
def test_roofline_counts_match_reference(fn, args):
    from bayesianinferencedl_tpu.utils import roofline as jr

    from bayesianinferencedl_tpu_torch.utils import roofline as tr

    assert getattr(tr, fn)(*args) == getattr(jr, fn)(*args)


def test_roofline_peaks_are_the_cards():
    from bayesianinferencedl_tpu_torch.utils import roofline as tr

    assert "H100" in tr.CARD and "700 W" in tr.CARD
    assert (tr.H100_HBM_BYTES_PER_S, tr.H100_F32_FLOPS, tr.H100_BF16_TENSOR_FLOPS) == (3.35e12, 67e12, 989e12)
    assert not any(n.startswith("V5E") for n in vars(tr))  # no TPU figure


def test_profile_trace_writes_a_trace(tmp_path):
    from bayesianinferencedl_tpu_torch.utils.metrics import profile_trace

    with profile_trace(tmp_path / "trace") as pt:
        x = torch.randn(64, 64)
        (x @ x).sum()
    trace = json.loads(pt.path.read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("mm" in str(n) for n in names), sorted(map(str, names))[:20]
    assert pt.profiler.key_averages()
