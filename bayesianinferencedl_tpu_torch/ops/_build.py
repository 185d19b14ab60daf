"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles into its own
shared library for Hopper (``sm_90a``), at first use, from the sources in
this checkout only. Libraries land in ``build/torch_kernels/`` at the root
of the checkout, keyed on a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused. A failed build raises; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in build_logs
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, dict] = {}  # name -> {"seconds", "ptxas", "path"} of this process's builds


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
            "kernels of bayesianinferencedl_tpu_torch are built from source at first use"
        )
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(src)
        out = BUILD_DIR / f"lib{name}_{_digest(name)}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} (exit {res.returncode}):\n{res.stderr[-4000:]}"
                )
            os.replace(tmp, out)
            build_logs[name] = {
                "seconds": time.perf_counter() - t0,
                "ptxas": res.stderr,
                "path": str(out),
            }
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib
