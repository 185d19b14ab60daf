"""The PyTorch port imports without jax: every module of
bayesianinferencedl_tpu_torch loads in a process where importing jax fails."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import bayesianinferencedl_tpu_torch as pkg
names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not [m for m in bad if sys.modules[m] is not None], bad
print(len(names))
"""


def test_port_imports_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 20
