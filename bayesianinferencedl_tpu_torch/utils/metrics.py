"""Structured JSONL metrics: every stage emits typed events (ROM rel-err,
NN loss, acceptance rate, ESS/sec, stage timings), and ``profile_trace``,
a Chrome trace of a block of code from ``torch.profiler``."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only JSONL event log with wall-clock stamps and a config echo."""

    def __init__(self, path: Optional[str | Path] = None, run_config: Optional[Dict[str, Any]] = None):
        self.path = Path(path) if path else None
        self.t0 = time.perf_counter()
        self.events: list[dict] = []
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
        if run_config is not None:
            self.log("run_config", **run_config)

    def log(self, event: str, **fields: Any) -> dict:
        rec = {"event": event, "t": round(time.perf_counter() - self.t0, 6), **fields}
        self.events.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, default=_jsonable) + "\n")
        return rec

    def timer(self, event: str):
        """Context manager logging ``event`` with the seconds it took on the
        host clock; code that launches device work inside it synchronises
        before leaving."""
        return _Timer(self, event)

    def summary(self) -> Dict[str, Any]:
        """Last value per event name."""
        out: Dict[str, Any] = {}
        for e in self.events:
            out[e["event"]] = {k: v for k, v in e.items() if k != "event"}
        return out


class profile_trace:
    """Context manager that records ``torch.profiler`` activity (the CPU's,
    and the card's when one is present) over its block and writes a Chrome
    trace, ``trace.json``, into ``log_dir``:

        with profile_trace("traces/run"):
            run_hot_path()

    A profiler that fails to start raises: nothing runs untraced in its
    place. ``self.profiler`` holds the finished profile (``key_averages``)."""

    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
        self.profiler = None

    @property
    def path(self) -> Path:
        return self.log_dir / "trace.json"

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.profiler = profile(activities=acts)
        self.profiler.__enter__()
        return self

    def __exit__(self, *exc):
        self.profiler.__exit__(*exc)
        self.profiler.export_chrome_trace(str(self.path))
        return False


class _Timer:
    def __init__(self, logger: MetricsLogger, event: str):
        self.logger = logger
        self.event = event

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.logger.log(self.event, seconds=round(time.perf_counter() - self.start, 6))
        return False


def _jsonable(x):
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)
