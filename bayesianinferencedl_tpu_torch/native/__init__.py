"""ctypes binding to the native C++ stencil assembler (``native/`` at the
repo root: ``native/src/fin_assemble.cc``, built by ``native/Makefile``).

The library assembles the same host operator as ``fem.dia.assemble_fin_dia``
(the NumPy path, kept as the oracle) and returns the port's own
``FinFEMDiaHost``. It is built from the repo's sources at first use, into
``native/build/libfinfem.so``, under a file lock so that concurrent
processes build it once. ``FiveParamFin.create`` prefers it.

Nothing here falls back quietly: when ``make`` itself is missing,
``native_available()`` is False and the caller takes the NumPy path (and
says so); a build or load that fails for any other reason raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from bayesianinferencedl_tpu_torch.fem.dia import FinFEMDiaHost

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libfinfem.so"
_lib: Optional[ctypes.CDLL] = None

N_REGIONS = 5
N_DIAG = 7


def build_native(force: bool = False) -> bool:
    """Compile libfinfem.so with ``make -C native``. Returns True when the
    library is there, False when ``make`` is missing; raises RuntimeError
    with the compiler's output when the build fails."""
    if _LIB_PATH.exists() and not force:
        return True
    if shutil.which("make") is None:
        return False
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(_LIB_PATH.parent / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if force or not _LIB_PATH.exists():
            cmd = ["make", "-C", str(_NATIVE_DIR)] + (["-B"] if force else [])
            out = subprocess.run(cmd, capture_output=True, text=True)
            if out.returncode != 0 or not _LIB_PATH.exists():
                raise RuntimeError(f"building {_LIB_PATH} failed:\n{out.stdout}\n{out.stderr}")
    return True


def load_native() -> Optional[ctypes.CDLL]:
    """The loaded library (built first if needed), or None when ``make`` is
    missing."""
    global _lib
    if _lib is not None:
        return _lib
    if not build_native():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.fin_grid_nodes.restype = ctypes.c_int
    lib.fin_grid_nodes.argtypes = [ctypes.c_int]
    dptr = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    lib.fin_assemble_dia.restype = ctypes.c_int
    lib.fin_assemble_dia.argtypes = [ctypes.c_int, ctypes.c_int] + [dptr] * 6
    _lib = lib
    return lib


def native_available() -> bool:
    return load_native() is not None


def assemble_fin_dia_native(resolution: int, pad_to: int = 128) -> FinFEMDiaHost:
    """The natively assembled stencil operator; the contract of
    ``fem.dia.assemble_fin_dia`` (equal to it to summation order)."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("the native assembler needs make and a C++ compiler")
    n_grid = int(lib.fin_grid_nodes(resolution))
    n = ((n_grid + pad_to - 1) // pad_to) * pad_to
    ny = 16 * resolution

    comp_vals = np.zeros((n, N_DIAG, N_REGIONS))
    ext_mass = np.zeros((n, N_DIAG))
    fixed = np.zeros((n, N_DIAG))
    F_root = np.zeros(n)
    qoi = np.zeros((N_REGIONS, n))
    qoi_root = np.zeros(n)
    rc = lib.fin_assemble_dia(
        resolution, n, comp_vals.reshape(-1), ext_mass.reshape(-1), fixed.reshape(-1),
        F_root, qoi.reshape(-1), qoi_root,
    )
    if rc != 0:
        raise RuntimeError(f"fin_assemble_dia failed with code {rc}")
    offsets = np.array([-(ny + 2), -(ny + 1), -1, 0, 1, ny + 1, ny + 2], dtype=np.int64)
    return FinFEMDiaHost(
        offsets=offsets, comp_vals=comp_vals, ext_mass=ext_mass, fixed=fixed, F_root=F_root,
        qoi=qoi, qoi_root=qoi_root, n_grid=n_grid, resolution=resolution,
    )
