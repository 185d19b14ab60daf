"""Full-fp32 matmuls pinned per call (utils/precision.py ``fp32_matmul``).

1. Inside the context TF32 is off for cuBLAS and cuDNN and the float32
   matmul precision reads "highest"; on leaving it the caller's three
   settings come back, also when the body raises, and nested contexts
   restore in turn. As a decorator it does the same around each call.
2. A source scan: nothing in the port writes the TF32 flags or the matmul
   precision except this helper.
3. The port's entry points leave the caller's setting as it was: a build
   and an inversion on the CPU under "high" end with "high". (That TF32
   on the card does not reach the pinned contractions needs a card: it is
   chip_smoke.py's phase 12 (h).)"""

import ast
import pathlib

import pytest
import torch

from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch.config import MCMCConfig, MeshConfig, PipelineConfig, ROMConfig
from bayesianinferencedl_tpu_torch.config import SurrogateConfig
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

PORT = pathlib.Path(__file__).resolve().parents[1] / "bayesianinferencedl_tpu_torch"


def _settings():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.fixture()
def caller_high():
    """The caller's process-wide setting "high" (TF32 matmuls) with cuDNN's
    TF32 off, restored to what it was after the test."""
    before = _settings()
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_float32_matmul_precision(before[2])
    torch.backends.cuda.matmul.allow_tf32 = before[0]
    torch.backends.cudnn.allow_tf32 = before[1]


def test_fp32_matmul_pins_and_restores(caller_high):
    outer = _settings()
    assert outer == (True, False, "high")
    with fp32_matmul():
        assert _settings() == (False, False, "highest")
        with fp32_matmul():
            assert _settings() == (False, False, "highest")
        assert _settings() == (False, False, "highest")
    assert _settings() == outer
    with pytest.raises(RuntimeError, match="inside"):
        with fp32_matmul():
            raise RuntimeError("inside")
    assert _settings() == outer

    @fp32_matmul()
    def body(fail):
        assert _settings() == (False, False, "highest")
        if fail:
            raise ValueError("body")
        return 7

    assert body(False) == 7 and _settings() == outer
    with pytest.raises(ValueError):
        body(True)
    assert _settings() == outer
    # and from the default setting
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    with fp32_matmul():
        pass
    assert _settings() == (False, True, "highest")


def _writes(tree):
    """The TF32 / matmul-precision writes in a module: assignments to an
    ``allow_tf32`` or ``fp32_precision`` attribute and calls of
    ``set_float32_matmul_precision``."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) and t.attr in ("allow_tf32", "fp32_precision"):
                    out.append(node.lineno)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("set_float32_matmul_precision", "setattr"):
            out.append(node.lineno)
    return out


def test_only_the_helper_writes_the_precision_flags():
    helper = PORT / "utils" / "precision.py"
    found = {}
    for path in sorted(PORT.rglob("*.py")):
        lines = _writes(ast.parse(path.read_text(), filename=str(path)))
        if lines:
            found[str(path.relative_to(PORT))] = lines
    assert set(found) == {str(helper.relative_to(PORT))}, found
    assert len(found["utils/precision.py"]) == 6  # the three settings, set and restored


def test_entry_points_leave_the_callers_setting(caller_high):
    cfg = PipelineConfig(
        mesh=MeshConfig(resolution=1), rom=ROMConfig(n_snapshots=16, basis_size=6),
        surrogate=SurrogateConfig(hidden=(8, 8), n_train=16, epochs=2),
        mcmc=MCMCConfig(n_chains=4, n_steps=6, n_burn=2, noise_sigma=1e-2, sampler="mala"),
    )
    pipe = api.build_pipeline(cfg, device="cpu")
    assert _settings() == (True, False, "high")
    api.run_inversion(pipe)
    assert _settings() == (True, False, "high")
