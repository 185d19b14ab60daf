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


def load_libraries(*names: str) -> list[ctypes.CDLL]:
    """Build (if needed) and load ``csrc/<name>.cu`` for each name; cached per
    process. The sources that need building get one nvcc each, all started
    together."""
    with _lock:
        builds = {}
        t0 = time.perf_counter()
        for name in dict.fromkeys(names):
            if name in _libs:
                continue
            src = CSRC / f"{name}.cu"
            if not src.exists():
                raise FileNotFoundError(src)
            out = BUILD_DIR / f"lib{name}_{_digest(name)}.so"
            proc = tmp = None
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            builds[name] = (src, out, tmp, proc)
        for name, (src, out, tmp, proc) in builds.items():
            if proc is not None:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {src.name} (exit {proc.returncode}):\n{err[-4000:]}"
                    )
                os.replace(tmp, out)
                build_logs[name] = {
                    "seconds": time.perf_counter() - t0,
                    "ptxas": err,
                    "path": str(out),
                }
            _libs[name] = ctypes.CDLL(str(out))
        return [_libs[name] for name in names]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    return load_libraries(name)[0]
