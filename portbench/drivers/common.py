"""Pieces the window drivers share: the package's launch counters, a bound on
the work queued ahead of the device, and the sizes of a configuration file
as the package's own configuration object."""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from portbench.harness import say

# the package's per-process launch counters (ops/pcg_stencil.py) and the kernel each counts
COUNTERS = (("tile_mma_launches", "K3r"), ("grid_resident_launches", "K4r"),
            ("grid_cluster_launches", "K4c"), ("launches", "K1"), ("tile_launches", "K3"),
            ("grid_launches", "K4"))


def launch_counts() -> dict:
    from bayesianinferencedl_tpu_torch.ops import pcg_stencil

    return {label: int(getattr(pcg_stencil, attr)) for attr, label in COUNTERS}


def carried_by(before: dict, after: dict) -> str:
    """The kernel whose counter moved between two readings ("plain" where
    none did: the package's torch version on a CPU tensor)."""
    moved = [k for k in after if after[k] != before[k]]
    return "+".join(moved) if moved else "plain"


class Queue:
    """Keeps at most ``depth`` steps queued on the device: after a step is
    enqueued, the host waits for the one ``depth`` - 1 before it, so the
    device always has the next step and the host never runs far ahead."""

    def __init__(self, device: torch.device, depth: int = 2):
        self.cuda = device.type == "cuda"
        self.depth = depth
        self.events = deque()

    def enqueued(self) -> None:
        if not self.cuda:
            return
        e = torch.cuda.Event()
        e.record()
        self.events.append(e)
        while len(self.events) >= self.depth:
            self.events.popleft().synchronize()

    def drain(self, device: torch.device) -> None:
        if self.cuda:
            torch.cuda.synchronize(device)
        self.events.clear()


class Traced:
    """Which steps of the window the trace covers. Where the mix names
    ``trace_steps``, that many steps from the first step boundary past half
    the window (a long window of small eager launches makes millions of
    profiler events, and a few steps show the same work), so that the steps
    before them run as in an untraced run; otherwise the whole window."""

    def __init__(self, run, queue: Queue):
        self.run, self.queue = run, queue
        self.limit = run.params.get("trace_steps") if run.trace else None
        self.n = 0  # steps done
        self.first = None  # the first traced step

    def start(self) -> None:
        """Where the window starts."""
        if self.run.trace and self.limit is None:
            self.first = 0
            self.run.tracer.start()

    def step_done(self, elapsed: float) -> None:
        """After each step is queued, ``elapsed`` seconds into the window:
        the traced part starts and ends, fully run, at step boundaries."""
        self.n += 1
        if self.limit is None:
            return
        if self.first is None and elapsed >= self.run.seconds / 2:
            self.queue.drain(self.run.device)
            self.first = self.n
            self.run.tracer.start()
        elif self.first is not None and self.n == self.first + self.limit:
            self.queue.drain(self.run.device)
            self.run.tracer.stop()

    def finished(self) -> bool:
        """Whether the window may end: the traced part, if any, is done."""
        return self.limit is None or (self.first is not None and self.n >= self.first + self.limit)

    def covers(self, i: int) -> bool:
        """Whether step i (from 0) is inside the trace."""
        if self.first is None or i < self.first:
            return False
        return self.limit is None or i < self.first + self.limit


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """The window's host clock: started after a synchronise, stopped after
    the last step queued is done."""

    def __init__(self, device: torch.device):
        self.device = device
        sync(device)
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def stop(self) -> float:
        sync(self.device)
        return time.perf_counter() - self.t0


def pipeline_config(cfg: dict, mix: dict, seeds: list):
    """The package's PipelineConfig for a configuration file and a mix."""
    from bayesianinferencedl_tpu_torch.config import (
        FEMConfig, MCMCConfig, MeshConfig, PipelineConfig, PriorConfig, ROMConfig, SurrogateConfig)

    p = mix["params"]
    return PipelineConfig(
        mesh=MeshConfig(resolution=cfg["resolution"]),
        fem=FEMConfig(biot=cfg["biot"], cg_tol=cfg["cg_tol"], cg_maxiter=cfg["cg_maxiter"]),
        rom=ROMConfig(n_snapshots=cfg["n_snapshots"], basis_size=cfg["basis_size"],
                      online_precision=cfg["online_precision"], online_iters=cfg["online_iters"],
                      seed=seeds[0]),
        surrogate=SurrogateConfig(hidden=tuple(cfg["hidden"]), activation=cfg["activation"],
                                  learning_rate=cfg["learning_rate"], batch_size=cfg["batch_size"],
                                  epochs=cfg["epochs"], n_train=cfg["n_train"], seed=seeds[1]),
        prior=PriorConfig(mean=cfg["prior_mean"], sigma=cfg["prior_sigma"], dim=5),
        mcmc=MCMCConfig(n_chains=p["chains"], noise_sigma=p["noise_sigma"], beta=p["beta"],
                        subchain=p["subchain"], likelihood="fom", sampler="da_pcn",
                        da_coarse="rom_nn", seed=seeds[2]),
    )


def log_events(events: list) -> None:
    """The build's stage events as set-up detail (they are not metrics)."""
    for e in events:
        fields = {k: v for k, v in e.items() if k not in ("event",)}
        say(f"[setup] {e['event']} {fields}")


def stats(a) -> str:
    a = np.asarray(a, dtype=np.float64)
    return f"min {a.min():.0f} mean {a.mean():.1f} max {a.max():.0f}" if a.size else "none"
