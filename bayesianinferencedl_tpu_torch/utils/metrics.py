"""Structured JSONL metrics: every stage emits typed events (ROM rel-err,
NN loss, acceptance rate, ESS/sec, stage timings)."""

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
