"""The PyTorch port stands alone: every module of bayesianinferencedl_tpu_torch
loads in a process where importing jax or the JAX package fails, no source
of the port (nor chip_smoke.py) names the JAX package in an import, and the
port's own copies of ``config`` and ``geometry`` equal the reference's."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bayesianinferencedl_tpu import config as jcfg
from bayesianinferencedl_tpu.geometry import build_fin_mesh as j_build_fin_mesh
from bayesianinferencedl_tpu.geometry import fin as j_fin
from bayesianinferencedl_tpu_torch import config as tcfg
from bayesianinferencedl_tpu_torch.geometry import build_fin_mesh as t_build_fin_mesh
from bayesianinferencedl_tpu_torch.geometry import fin as t_fin

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = "bayesianinferencedl_tpu"

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["bayesianinferencedl_tpu"] = None  # and so does any import of the JAX package
import bayesianinferencedl_tpu_torch as pkg
names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "bayesianinferencedl_tpu") and sys.modules[m] is not None)
assert not bad, bad
print(" ".join(names))
print(len(names))
"""
# modules the later slices added, which the walk must reach
NEW_MODULES = ("fem.assemble", "fem.operators", "fem.oracle", "utils.adjoint", "experimental.multigrid",
               "parallel.mesh", "parallel.sharding", "parallel.domain", "parallel.dryrun",
               "utils.roofline")


def test_port_imports_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    *_, walked, count = res.stdout.strip().splitlines()
    assert int(count) >= 25
    assert {f"bayesianinferencedl_tpu_torch.{m}" for m in NEW_MODULES} <= set(walked.split())


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_source_imports_the_reference_package():
    files = sorted((ROOT / "bayesianinferencedl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [
        f"{f.relative_to(ROOT)}: {m}"
        for f in files
        for m in _imported_modules(f)
        if m.split(".")[0] in (REFERENCE, "jax", "jaxlib")
    ]
    assert len(files) >= 25 and not bad, bad


def test_config_copy_equals_reference():
    assert dataclasses.asdict(tcfg.PipelineConfig()) == dataclasses.asdict(jcfg.PipelineConfig())
    for name in ("MeshConfig", "FEMConfig", "ROMConfig", "SurrogateConfig", "PriorConfig",
                 "MCMCConfig", "ParallelConfig", "PipelineConfig"):
        tf = [(f.name, f.type) for f in dataclasses.fields(getattr(tcfg, name))]
        jf = [(f.name, f.type) for f in dataclasses.fields(getattr(jcfg, name))]
        assert tf == jf, name
    d = jcfg.PipelineConfig(surrogate=jcfg.SurrogateConfig(hidden=(16, 8))).to_dict()
    assert tcfg.PipelineConfig.from_dict(d).to_dict() == d


@pytest.mark.parametrize("resolution", [1, 2])
def test_mesh_copy_equals_reference(resolution, tmp_path):
    tm, jm = t_build_fin_mesh(resolution), j_build_fin_mesh(resolution)
    for f in dataclasses.fields(jm):
        np.testing.assert_array_equal(getattr(tm, f.name), getattr(jm, f.name), err_msg=f.name)
    np.testing.assert_array_equal(tm.region_areas(), jm.region_areas())
    assert t_fin.N_REGIONS == j_fin.N_REGIONS
    # the npz cache: written on the first call, read back equal on the second
    t_build_fin_mesh(resolution, cache_dir=tmp_path)
    cached = t_build_fin_mesh(resolution, cache_dir=tmp_path)
    assert (tmp_path / f"fin_mesh_r{resolution}.npz").exists()
    for f in dataclasses.fields(jm):
        np.testing.assert_array_equal(getattr(cached, f.name), getattr(jm, f.name), err_msg=f.name)
