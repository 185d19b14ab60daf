"""The harness: finds a cell's files by name, runs its driver's set-up, window
and check, reads its metrics, and prints the result line.

Everything that belongs to one cell lives in files of its own, found by the
names in ``BENCHMARK.json``:

- ``workloads/<cell>.json``: the traffic mix: its configuration, its window
  driver, the mix's parameters and the limits of its correctness check;
- ``configs/<config>.json``: the configuration's sizes and source;
- ``drivers/<driver>.py``: ``setup(run)``, ``window(run, state)`` and
  ``check(run, state)``;
- ``metrics/<metric>.py``: ``read(run)``, a per-layer metric from the run's
  spans, counters, solve records or trace (None where it finds nothing).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names the measured process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "bayesianinferencedl_tpu")


def say(msg: str) -> None:
    """One detail line on standard error."""
    print(msg, file=sys.stderr, flush=True)


def load_module(path: Path):
    """A module from a file of the benchmark, by path (names may hold dots)."""
    name = "portbench_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list  # [name, ...] the cell reports with --trace 0
    per_layer: list  # [name, ...] the cell reports with --trace 1
    units: dict  # metric name -> unit
    bench: Path = BENCH  # the folder the cell's files were found in


def find_cell(spec: dict, workload: str, bench: Path = BENCH) -> Cell:
    """The cell's entry, configuration, mix and metric lists, by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    with open(bench.parent / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(bench / "workloads" / f"{workload}.json") as f:
        mix = json.load(f)
    if mix["config"] != w["config"]:
        raise SystemExit(f"{workload}: the mix names config {mix['config']!r}, BENCHMARK.json "
                         f"{w['config']!r}")
    e2e = [m["name"] for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    per_layer = [m["name"] for m in spec["per_layer"] if workload in m["workloads"]]
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    return Cell(name=workload, chips=int(w["chips"]), config=config, mix=mix, end_to_end=e2e,
                per_layer=per_layer, units=units, bench=bench)


@dataclass
class Run:
    """One run of one cell: its inputs, and what its driver measured."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any = None  # torch.device
    t_start: float = field(default_factory=time.perf_counter)
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    e2e: dict = field(default_factory=dict)  # end-to-end metric -> value
    attempted: int = 0
    failed: int = 0
    spans: dict = field(default_factory=dict)  # span name -> [ms, ...]
    solves: list = field(default_factory=list)  # one record per timed FOM solve
    steps: int = 0  # outer steps or batches the window completed
    traced_steps: int = 0  # of them, those inside the trace, with --trace 1
    traced_first: Optional[int] = None  # the first of those
    tracer: Any = None  # trace.Tracer: the driver starts it with its window
    trace_data: Any = None  # trace.Trace of the traced part of the window, with --trace 1
    checks: list = field(default_factory=list)  # [(name, value, limit), ...]
    memory_peak_bytes: int = 0

    @property
    def params(self) -> dict:
        return self.cell.mix["params"]

    @property
    def config(self) -> dict:
        return self.cell.config

    def limit(self, name: str) -> float:
        return float(self.cell.mix["limits"][name])

    def untraced(self, span: str) -> list:
        """A span's values over the window's steps before the trace started:
        in a traced run, the steps that ran as in an untraced one."""
        return list(self.spans.get(span, []))[:self.traced_first or 0]

    def mark_window_start(self) -> None:
        """Set-up ends where the window starts."""
        self.setup_s = time.perf_counter() - self.t_start


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not hold (an
    entry set to None blocks an import and is no module)."""
    return sorted({m for m, mod in list(sys.modules.items())
                   if mod is not None and m.split(".")[0] in FORBIDDEN})


def correct(checks: list) -> bool:
    return bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def read_metrics(run: Run, names: list) -> dict:
    """Each per-layer metric's reader, from ``metrics/<name>.py``; a reader
    that finds nothing to read returns None and its metric is left out."""
    out = {}
    for name in names:
        value = load_module(run.cell.bench / "metrics" / f"{name}.py").read(run)
        if value is not None:
            out[name] = {"value": float(value), "unit": run.cell.units[name]}
    return out


def execute(run: Run, driver) -> dict:
    """Set-up, window (traced with --trace 1), the memory reading, the
    check; returns the result line's object."""
    import torch

    from portbench import trace as tr

    state = driver.setup(run)
    run.tracer = tr.Tracer(run.trace)
    driver.window(run, state)
    run.tracer.stop()
    run.trace_data = run.tracer.trace
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the measured process holds {found} once the window has closed")
    if run.device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(run.device))
    t0 = time.perf_counter()
    driver.check(run, state)
    say(f"[check] {time.perf_counter() - t0:.1f} s after a {run.window_s:.1f} s window")
    del state
    ok = correct(run.checks)
    if run.trace:
        metrics = read_metrics(run, run.cell.per_layer)
    else:
        metrics = {name: {"value": float(run.e2e[name]), "unit": run.cell.units[name]}
                   for name in run.cell.end_to_end if name != "setup_s"}
        metrics["setup_s"] = {"value": float(run.setup_s), "unit": run.cell.units["setup_s"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
              "count": run.cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": ok, "attempted": int(run.attempted), "failed": int(run.failed),
           "metrics": metrics, "device": device}
    if run.trace and run.trace_data is not None:
        device["busy_s"] = run.trace_data.busy_s
        device["window_s"] = run.trace_data.window_s
        out["breakdown"] = run.trace_data.breakdown()
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.checks}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the measured process holds {found}")
    return out


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths. The
    package's own nvcc builds go to ``build/torch_kernels/`` and its native
    assembler to ``native/build/`` by themselves."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
