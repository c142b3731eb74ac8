"""Grid pipeline: the host's judgement and writes beside the card's attacks.

Port of ``experiments/pipeline.py::GridPipeline``. An in-process grid
(``experiments/rq.py``) hands each point's ``finalize`` closure (evaluate,
save ``x_attacks``, stream, metrics last) to one background writer thread,
while the launching thread goes on to the next point's attack:

- :meth:`GridPipeline.submit` queues a closure; one FIFO worker writes the
  points in submission order, and within a point the metrics JSON lands
  last, so "metrics exists" still implies its siblings exist. A queued
  point's metrics path is pending (:meth:`is_pending`) until its closure
  has run, so ``common.should_skip`` skips a duplicate point before its
  file lands.
- A failed closure is logged and reported (``writer.failures``), and the
  writer goes on, as a failed attack is logged and the sweep goes on.
- :meth:`point` records each launched or skipped point with its
  ``PhaseTimer``; :meth:`finish` drains the writer and writes
  ``grid_report_{hash}.json``.

The closures touch host arrays only: the runners bring ``x_attacks`` to
numpy after the attack has finished on the card, before they submit. The
port's judgement is float64 torch on the CPU, so the writer's intra-op
threads share the host with the launching thread.

The report keeps the JAX report's keys where the port has the quantity:
``grid_config_hash``, ``grid_wallclock_s``, ``points_total``,
``points_launched``, ``points_skipped``, the span totals
``attack_compile_s``, ``attack_run_s``, ``setup_s``, ``evaluate_s`` and
``write_s``, the ``artifact_cache`` and ``engine_cache`` deltas over the
grid, ``cold`` (``first_point_attack_s``, ``steady_point_attack_s``,
``cold_steady_ratio``), ``writer``, ``execution`` and ``points``. Left out:

- ``telemetry``, ``ledger`` and ``cold.process``: the tracing layer, the
  cost ledger and the cold-start ledger are ROADMAP A14's, as the runners'
  metrics leave out ``telemetry``;
- ``distinct_compiled_programs``: the port traces no programs. In its place
  ``library_loads`` sums the points' ``PhaseTimer`` counter of that name
  (the kernel library built or loaded during an attack).

The pipeline takes no recorder: a grid config that sets
``system.trace_log`` is refused by name (A14) before any point runs, as the
runners refuse it. ``execution`` is ``{"pipeline": true, "mesh_devices":
0, "mesh": null}``: one card, no mesh.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time

from ..utils.config import get_dict_hash
from . import common

logger = logging.getLogger(__name__)

#: the JAX report's keys that the port's report leaves out, and what ports them
NOT_PORTED = {
    "telemetry": "the tracing layer (ROADMAP A14)",
    "ledger": "the cost ledger (ROADMAP A14)",
    "cold.process": "the cold-start ledger (ROADMAP A14)",
    "distinct_compiled_programs": "nothing: the port traces no programs (see library_loads)",
}


class GridPipeline:
    """Shared execution context of one in-process grid sweep."""

    def __init__(self):
        self._queue: queue.Queue = queue.Queue()
        self._pending: set[str] = set()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._submitted = 0
        self.points: list[dict] = []
        self.write_failures: list[dict] = []
        self._t0 = time.perf_counter()
        self._artifacts0 = common.ARTIFACTS.stats()
        self._engines0 = common.ENGINES.stats()

    # -- background writer ---------------------------------------------------
    def _worker(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                label, metrics_path, finalize = item
                try:
                    finalize()
                except Exception as e:
                    logger.exception("grid point finalize failed: %s", label)
                    self.write_failures.append({"point": label, "error": repr(e)})
                finally:
                    with self._lock:
                        self._pending.discard(metrics_path)
            finally:
                self._queue.task_done()

    def submit(self, label: str, metrics_path: str, finalize) -> None:
        """Queue a point's finalize closure on the writer thread."""
        with self._lock:
            self._pending.add(metrics_path)
            if self._thread is None:
                self._thread = threading.Thread(target=self._worker, name="grid-writer", daemon=True)
                self._thread.start()
        self._submitted += 1
        self._queue.put((label, metrics_path, finalize))

    def is_pending(self, metrics_path: str) -> bool:
        with self._lock:
            return metrics_path in self._pending

    def drain(self) -> None:
        """Block until every queued finalize has run."""
        self._queue.join()

    def close(self) -> None:
        self.drain()
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join()
            self._thread = None

    # -- the report ----------------------------------------------------------
    def point(self, attack: str, config_hash: str, timer, skipped: bool = False) -> None:
        """Record one launched or skipped point; ``timer`` (its
        ``PhaseTimer``) is read at :meth:`finish`, so the writer's spans are
        in."""
        self.points.append({"attack": attack, "config_hash": config_hash, "skipped": skipped, "_timer": timer})

    @staticmethod
    def _delta(now: dict, before: dict) -> dict:
        return {k: now[k] - before.get(k, 0) for k in now}

    def finish(self, grid_config: dict, out_dirs) -> dict:
        """Drain the writer and write ``grid_report_{hash}.json`` into the
        first of ``out_dirs`` that takes it."""
        self.close()
        points = []
        for p in self.points:
            timer = p.pop("_timer", None)
            if timer is not None:
                p["spans"] = {k: round(v, 4) for k, v in timer.spans.items()}
                p["counters"] = dict(timer.counters)
            points.append(p)

        def span_total(name):
            return round(sum(p.get("spans", {}).get(name, 0.0) for p in points), 3)

        launched = [p for p in points if not p["skipped"]]
        # the first launched point's attack (where the kernel library is
        # built or loaded) against the median of the rest
        attack_walls = [p["spans"]["attack"] for p in launched if "attack" in p.get("spans", {})]
        steady_walls = sorted(attack_walls[1:])
        steady = steady_walls[len(steady_walls) // 2] if steady_walls else None
        cold = {
            "first_point_attack_s": round(attack_walls[0], 4) if attack_walls else None,
            "steady_point_attack_s": round(steady, 4) if steady is not None else None,
            "cold_steady_ratio": round(attack_walls[0] / steady, 3) if attack_walls and steady else None,
        }
        report = {
            "grid_config_hash": get_dict_hash(grid_config),
            "grid_wallclock_s": round(time.perf_counter() - self._t0, 3),
            "points_total": len(points),
            "points_launched": len(launched),
            "points_skipped": len(points) - len(launched),
            "library_loads": sum(p.get("counters", {}).get("library_loads", 0) for p in points),
            "attack_compile_s": span_total("attack_compile"),
            "attack_run_s": span_total("attack_run"),
            "setup_s": span_total("setup"),
            "evaluate_s": span_total("evaluate"),
            "write_s": span_total("write"),
            "artifact_cache": self._delta(common.ARTIFACTS.stats(), self._artifacts0),
            "engine_cache": self._delta(common.ENGINES.stats(), self._engines0),
            "cold": cold,
            "writer": {"submitted": self._submitted, "failures": self.write_failures},
            "execution": {"pipeline": True, "mesh_devices": 0, "mesh": None},
            "points": points,
        }
        for out_dir in out_dirs:
            try:
                os.makedirs(out_dir, exist_ok=True)
                path = os.path.join(out_dir, f"grid_report_{report['grid_config_hash']}.json")
                with open(path, "w") as f:
                    json.dump(report, f, indent=1)
                report["report_path"] = path
                break
            except OSError as e:
                logger.warning("could not write grid report to %s: %s", out_dir, e)
        return report
