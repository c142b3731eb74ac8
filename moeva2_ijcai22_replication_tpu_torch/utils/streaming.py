"""Experiment metric streaming: an append-only JSONL event file per run.

Port of ``utils/streaming.py``. Events are one JSON object per line,
``{"t": <unix>, "event": "start"|"params"|"metric"|"end", ...}``; metrics
carry ``name``, ``value`` and an optional ``step``. For the same calls the
port writes the same events as the JAX package.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Iterator


class ExperimentStream:
    """Append-only JSONL event stream for one experiment run."""

    def __init__(self, path: str, name: str = "", enabled: bool = True):
        self.path = path
        self.enabled = enabled
        self._fh = None
        if enabled:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # overwrite: the sibling artifacts are keyed by config hash and
            # overwritten on a re-run, whose events must not mix with these
            self._fh = open(path, "w", buffering=1)
            self._emit({"event": "start", "name": name})

    def _emit(self, obj: dict):
        if self._fh is None:
            return
        obj = {"t": round(time.time(), 3), **obj}
        self._fh.write(json.dumps(obj, default=_jsonable) + "\n")

    def log_parameters(self, params: dict):
        self._emit({"event": "params", "params": params})

    def log_metric(self, name: str, value, step: int | None = None):
        ev: dict[str, Any] = {"event": "metric", "name": name, "value": value}
        if step is not None:
            ev["step"] = step
        self._emit(ev)

    def log_event(self, kind: str, **fields):
        """A generic structured event, ``{"event": kind, **fields}``."""
        self._emit({"event": kind, **fields})

    def log_series(self, name: str, values, start_step: int = 0):
        """One metric event per step of a recorded per-step history."""
        for i, v in enumerate(values):
            self.log_metric(name, v, step=start_step + i)

    def end(self):
        if self._fh is not None:
            self._emit({"event": "end"})
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()


def _jsonable(x):
    import numpy as np

    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def read_events(path: str) -> Iterator[dict]:
    with open(path) as fh:
        for line in fh:
            if line.strip():
                yield json.loads(line)


def stream_for(config: dict, mid_fix: str, config_hash: str) -> ExperimentStream:
    """The runner's stream, keyed like its metrics artifacts and enabled by
    the config's ``streaming`` flag."""
    enabled = bool(config.get("streaming"))
    out_dir = config.get("dirs", {}).get("results", ".")
    return ExperimentStream(
        f"{out_dir}/events_{mid_fix}_{config_hash}.jsonl",
        name=f"{config.get('project_name', '')}:{mid_fix}",
        enabled=enabled,
    )
