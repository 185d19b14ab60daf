"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name (so ``bayesianinferencedl_tpu_torch`` is not taken for
``bayesianinferencedl_tpu``), and the reference and the yardstick import
nothing of the port."""

import ast
import subprocess
import sys

import pytest

from portbench import harness

JAX_SIDE = {"jax", "jaxlib", "flax", "bayesianinferencedl_tpu"}
PORT = "bayesianinferencedl_tpu_torch"


def _sources(sub=""):
    return sorted(p for p in (harness.BENCH / sub).rglob("*.py") if "tests" not in p.parts)


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not (_top_level_imports(path) & JAX_SIDE)


@pytest.mark.parametrize("sub", ["reference", "yardstick"])
def test_reference_and_yardstick_import_nothing_of_the_port(sub):
    for path in _sources(sub):
        names = _top_level_imports(path)
        assert PORT not in names and "portbench" not in names, path


def test_names_compare_whole():
    import sys as _sys

    _sys.modules.setdefault("bayesianinferencedl_tpu_torch_lookalike", _sys)
    try:
        assert "bayesianinferencedl_tpu_torch_lookalike" not in harness.forbidden_modules()
    finally:
        del _sys.modules["bayesianinferencedl_tpu_torch_lookalike"]


def test_a_run_holds_neither_jax_nor_the_jax_package():
    """A tiny CPU run of each cell in a process where importing JAX or the
    JAX package fails, and which ends holding neither."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'bayesianinferencedl_tpu'): sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
        "from portbench.tests.tiny import tiny_run\n"
        "from portbench import harness\n"
        "for cell in ('fin5_res8.da_fom', 'fin5_res32.fom_sweep'):\n"
        "    run, out = tiny_run(cell, 5, seconds=0.3)\n"
        "    assert out['correct'], out\n"
        "held = [m for m in sys.modules if m.split('.')[0] in harness.FORBIDDEN and sys.modules[m] is not None]\n"
        "assert not held, held\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
