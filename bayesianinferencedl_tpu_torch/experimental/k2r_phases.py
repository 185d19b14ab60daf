"""Where K2r's time goes, on the card. From the root of a checkout:

    python -m bayesianinferencedl_tpu_torch.experimental.k2r_phases

1. Phases: an instrumented copy of ``csrc/pcn_fused_r.cu`` (clock64 marks
   between the phases of a step, summed on chain 0) is built with nvcc into
   ``build/k2r_phases/`` and run at C = 132 (one chain an SM) and 1,024 (the
   slice's), cg_iters = 0, 20 and 40; it prints the clocks per step of each
   phase. The kernel the package launches is not changed.
2. Sweeps: K2r and K2 through ``pcn_fused._launch`` over 1,000 steps, by CUDA
   events: over C at r = 40 and cg_iters 0, 10, 20, 40, and over r at C =
   1,024, cg_iters = 20, with ``k2r_plan``'s launch.

The operands are synthetic and made from a seed with numpy (random SPD
components, P0 the inverse of their sum, a random MLP) at the slice's widths:
r = 40, h = 64, d = 5, m = 5. Needs a card; prints one line per run.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.experimental import pcn_fused as K2
from bayesianinferencedl_tpu_torch.ops import _build

PHASES = ("uniforms + proposal", "exp k + assembly", "x0 products + dot", "CG loop",
          "MLP + observables", "accept + write")
_MARKS = '''
__device__ unsigned long long g_prof[8];
__device__ long long g_last;
__device__ __forceinline__ void prof_mark(int ph) {
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    const long long now = clock64();
    g_prof[ph] += now - g_last;
    g_last = clock64();
  }
}
'''
# (anchor in the source, what goes before it or after it): mark n ends phase n
_INSERTS = (
    ("  for (int t = -1; t < a.T; ++t) {\n", "after", "    prof_mark(7);\n"),
    ("    const float phi_prop = misfit<", "before", "    prof_mark(0);\n"),
    ("  assemble<RP>(c, k, A);\n", "after", "  prof_mark(1);\n"),
    ("  for (int it = 0; it < cg_iters; ++it) {\n", "before", "  prof_mark(2);\n"),
    ("  // MLP: xs", "before", "  prof_mark(3);\n"),
    ("  return sq * inv2n2;\n", "before", "  prof_mark(4);\n"),
    ("      a.out[row + lane] = v;\n    }\n", "after", "    prof_mark(5);\n"),
)
_READ = '''
extern "C" int prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
extern "C" int prof_zero() {
  unsigned long long z[8] = {0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
'''


def instrumented_source() -> str:
    """csrc/pcn_fused_r.cu with the phase marks; raises if an anchor moved."""
    s = (_build.CSRC / "pcn_fused_r.cu").read_text()
    s = s.replace("namespace {\n", "namespace {\n" + _MARKS, 1)
    for anchor, where, mark in _INSERTS:
        if anchor not in s:
            raise RuntimeError(f"k2r_phases: the anchor {anchor!r} is not in pcn_fused_r.cu")
        s = s.replace(anchor, anchor + mark if where == "after" else mark + anchor, 1)
    return s + _READ


def synthetic_operands(C: int, r: int, h: int = 64, d: int = 5, m: int = 5, seed: int = 0,
                       device: str = "cuda") -> K2.FusedOperands:
    """K2's packed operands for a well-conditioned synthetic problem."""
    g = np.random.default_rng(seed)
    comps = []
    for j in range(6):
        Q, _ = np.linalg.qr(g.standard_normal((r, r)))
        comps.append((Q * g.uniform(0.5, 2.0, r)) @ Q.T * (0.1 if j == 5 else 1.0))

    def pad(a, shape):
        out = np.zeros(shape)
        a = np.asarray(a)
        out[tuple(slice(0, n) for n in a.shape)] = a
        return out

    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
    return K2.FusedOperands(
        theta0=f(pad(g.normal(0, 0.5, (C, d)), (C, 8))), astack=f(np.concatenate(comps, 1)),
        P0=f(np.linalg.inv(sum(comps))), fhat=f(g.standard_normal(r)),
        bhatT=f(pad(g.standard_normal((r, m)) * 0.3, (r, 8))),
        w1=f(pad(g.standard_normal((d, h)) * 0.5, (8, h))), b1=f(g.standard_normal(h) * 0.1),
        w2=f(g.standard_normal((h, h)) * 0.2), b2=f(g.standard_normal(h) * 0.1),
        w3=f(pad(g.standard_normal((h, m)) * 0.01, (h, 8))), b3=f(pad(g.standard_normal(m) * 0.01, (8,))),
        xnorm=f(np.stack([pad(g.standard_normal(d) * 0.1, (8,)), pad(np.ones(d), (8,))])),
        data=f(pad(g.standard_normal(m) * 0.3, (8,))), consts=f([0.0, 1.0, 0.5 / 0.05**2, 0.25]),
        d=d)


def _build_instrumented() -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR.parent / "k2r_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "pcn_fused_r_phases.cu", out_dir / "libpcn_fused_r_phases.so"
    src.write_text(instrumented_source())
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on the instrumented K2r:\n{res.stderr[-4000:]}")
    inst = None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '.*kernelILi(\d+)E", line)
        if m:
            inst = m[1]
        elif inst == "40" and ("registers" in line or "spill" in line):
            print(f"instrumented <40>: {line.split(':', 1)[-1].strip()}", flush=True)
    return ctypes.CDLL(str(lib))


def phases(T: int = 1000) -> None:
    lib = _build_instrumented()
    fn = lib.pcn_fused_r_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 9 + [ctypes.c_float] * 4
                   + [ctypes.c_ulonglong, ctypes.c_void_p])
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for C in (132, 1024):
        ops = synthetic_operands(C, 40)
        r, (h1, h2) = ops.astack.shape[0], ops.w2.shape
        plan = K2.k2r_plan(C, r, h1, h2, torch.cuda.get_device_properties(0).multi_processor_count)
        operands = [ops.theta0, ops.astack, ops.P0, ops.fhat, ops.bhatT, ops.w1, ops.b1, ops.w2,
                    ops.b2, ops.w3, ops.b3, ops.xnorm, ops.data]
        out = torch.empty((T, C, 8), device="cuda")
        pm, ps, inv2n2, beta0 = (float(v) for v in ops.consts.cpu())
        for cg in (0, 20, 40):
            args = ([t.data_ptr() for t in operands] + [None] * 4
                    + [out.data_ptr(), C, r, h1, h2, ops.d, T, 0, cg, plan.warps, pm, ps, inv2n2,
                       beta0, 3, None])
            if fn(*args) or lib.prof_zero():  # warm-up
                raise RuntimeError("the instrumented K2r failed to launch")
            torch.cuda.synchronize()
            lib.prof_zero()
            e0.record()
            fn(*args)
            e1.record()
            e1.synchronize()
            prof = (ctypes.c_ulonglong * 8)()
            lib.prof_read(prof)
            print(f"phases C={C} cg_iters={cg}: {e0.elapsed_time(e1):.3f} ms per {T} steps; chain 0 "
                  f"clocks per step: " + ", ".join(f"{n} {prof[i] / T:.0f}" for i, n in enumerate(PHASES))
                  + f"; sum {sum(prof[i] for i in range(6)) / T:.0f}", flush=True)


def _timed(ops, T, cg, kernel):
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    kw = dict(n_burn=0, cg_iters=cg, seed=1, uniforms=None, keep_uniforms=False, kernel=kernel)
    K2._launch(ops, n_steps=10, **kw)
    e0.record()
    out, _ = K2._launch(ops, n_steps=T, **kw)
    e1.record()
    e1.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{kernel}: non-finite trace")
    return e0.elapsed_time(e1)


def sweeps(T: int = 1000) -> None:
    for C in (132, 264, 528, 1024, 1056):
        ops = synthetic_operands(C, 40)
        plan = K2.k2r_plan(C, 40, 64, 64)
        row = [f"K2r cg_iters {cg} {_timed(ops, T, cg, 'K2r'):.3f}" for cg in (0, 10, 20, 40)]
        row.append(f"K2 cg_iters 20 {_timed(ops, T, 20, 'K2'):.3f}")
        print(f"sweep C={C} ({plan.warps} warps x {plan.blocks} blocks), r=40: ms per {T} steps: "
              + "; ".join(row), flush=True)
    for r in (8, 16, 24, 32, 40, 48, 56, 64):
        ops = synthetic_operands(1024, r)
        print(f"sweep r={r} C=1024 cg_iters=20: K2r {_timed(ops, T, 20, 'K2r'):.3f} ms, K2 "
              f"{_timed(ops, T, 20, 'K2'):.3f} ms per {T} steps ({K2.k2r_plan(1024, r, 64, 64)})",
              flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("k2r_phases needs a card")
    print(f"{torch.cuda.get_device_name(0)}", flush=True)
    phases()
    sweeps()


if __name__ == "__main__":
    main()
