"""The port's FOM commands (``fom``, ``snapshots``, ``rom`` of
bayesianinferencedl_tpu_torch.cli) against the JAX package's CLI at res1 on
the CPU: the JSON keys and npz keys are the reference's, the ``fom`` QoI
equals the reference's (both are one Jacobi-PCG solve of the same system: to
1e-5 relative in float32 at tol 1e-7, to 1e-10 in float64 at tol 1e-10),
the ROM lands below 10% error, and the iteration cap is the reference's
``_cg_maxiter``. Without a card, the commands and the public constructors
raise unless asked for the CPU."""

import json

import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu import cli as jcli
from bayesianinferencedl_tpu_torch import cli as tcli

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs


def _run(main, argv, capsys) -> dict:
    main(argv)
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    return json.loads(lines[-1])


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("float64", 1e-10)])
def test_fom_matches_reference(dtype, rtol, capsys, tmp_path):
    argv = ["fom", "--resolution", "1", "--dtype", dtype, "--k", "0.5", "2.0", "1.0", "3.0", "0.8"]
    j = _run(jcli.main, argv + ["--save-obs", str(tmp_path / "j.npz")], capsys)
    t = _run(tcli.main, argv + ["--device", "cpu", "--save-obs", str(tmp_path / "t.npz")], capsys)
    assert set(t) == set(j) and t["n_dof"] == j["n_dof"] and len(t["qoi"]) == 5
    np.testing.assert_allclose(t["qoi"], j["qoi"], rtol=rtol)
    with np.load(tmp_path / "j.npz") as jz, np.load(tmp_path / "t.npz") as tz:
        assert sorted(tz.files) == sorted(jz.files)
        for f in jz.files:
            np.testing.assert_allclose(tz[f], jz[f], rtol=rtol)


def test_snapshots_keys_and_npz(capsys, tmp_path):
    argv = ["snapshots", "--resolution", "1", "--n", "8"]
    j = _run(jcli.main, argv + ["--out", str(tmp_path / "j.npz")], capsys)
    t = _run(tcli.main, argv + ["--device", "cpu", "--out", str(tmp_path / "t.npz")], capsys)
    assert set(t) == set(j) and t["n"] == 8 and t["fom_solves_per_sec"] > 0
    with np.load(tmp_path / "j.npz") as jz, np.load(tmp_path / "t.npz") as tz:
        assert sorted(tz.files) == sorted(jz.files)
        for f in jz.files:
            assert tz[f].shape == jz[f].shape and np.isfinite(tz[f]).all()


def test_rom_keys_error_and_npz(capsys, tmp_path):
    argv = ["rom", "--resolution", "1", "--n-snapshots", "64", "--r", "8"]
    j = _run(jcli.main, argv + ["--out", str(tmp_path / "j.npz")], capsys)
    t = _run(tcli.main, argv + ["--device", "cpu", "--out", str(tmp_path / "t.npz")], capsys)
    assert set(t) == set(j) and (t["r"], t["method"]) == (8, "pod")
    assert 0 < t["rel_err_vs_fom"] < 0.1, t
    with np.load(tmp_path / "j.npz") as jz, np.load(tmp_path / "t.npz") as tz:
        assert sorted(tz.files) == sorted(jz.files) and tz["V"].shape == jz["V"].shape
    # the greedy basis, ported: the same keys, an error below 0.1
    g = _run(tcli.main, argv + ["--device", "cpu", "--method", "greedy"], capsys)
    assert set(g) == set(j) and g["method"] == "greedy" and 0 < g["rel_err_vs_fom"] < 0.1, g


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("res", [1, 4, 32])
def test_cg_maxiter_is_the_reference_rule(res, dtype):
    from argparse import Namespace

    args = Namespace(resolution=res, dtype=dtype)
    assert tcli._cg_maxiter(args) == jcli._cg_maxiter(args)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run on it")
    from bayesianinferencedl_tpu_torch.api import make_prior
    from bayesianinferencedl_tpu_torch.config import PriorConfig
    from bayesianinferencedl_tpu_torch.fem.dia import StencilOperator, assemble_fin_dia
    from bayesianinferencedl_tpu_torch.geometry import build_fin_mesh
    from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior
    from bayesianinferencedl_tpu_torch.ops.deflation import DeflationBasis
    from bayesianinferencedl_tpu_torch.rom.galerkin import ReducedOperator

    host = assemble_fin_dia(build_fin_mesh(1))
    V = np.linalg.qr(np.random.default_rng(0).normal(size=(host.n, 4)))[0]
    for make in (lambda: make_prior(PriorConfig()), lambda: GaussianPrior.iid(5),
                 lambda: StencilOperator.from_host(host, 0.1),
                 lambda: DeflationBasis.create(host, m=8),
                 lambda: ReducedOperator.project_host(host, 0.1, V)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    for cmd in (["fom"], ["snapshots"], ["rom"]):
        with pytest.raises(RuntimeError, match="cuda"):
            tcli.main(cmd + ["--resolution", "1"])
