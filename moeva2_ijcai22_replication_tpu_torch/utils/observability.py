"""Per-phase timers of an experiment run.

Port of ``utils/observability.py``'s :class:`PhaseTimer`: named
monotonic-clock spans and integer counters that the runners write into the
metrics JSON. The JAX package splits an attack's span by whether its engine
traced a new program; the port traces nothing, and what a first call pays
for is the kernel library: :meth:`PhaseTimer.attack` puts the span under
``attack_compile`` when the library was built or loaded during the call
(``kernels.build.library``'s cache went from empty to full) and under
``attack_run`` otherwise.

A grid point's timer is shared by two threads: the launching thread adds
``setup`` and the attack's spans, the grid's background writer then adds
``evaluate`` and ``write``; :meth:`PhaseTimer.add` and :meth:`PhaseTimer.count`
take a lock, so the spans sum as in a serial run.

``ServiceMetrics`` (serving) and ``maybe_profile`` (profiler traces) are not
ported yet; a config that sets ``system.profile_dir`` is refused by the
runners.
"""

from __future__ import annotations

import contextlib
import threading
import time


def _library_loaded() -> bool:
    from ..kernels import build

    return build.library.cache_info().currsize > 0


class PhaseTimer:
    """Named spans (seconds) and counters; ``.spans`` and ``.counters`` are
    JSON-ready."""

    def __init__(self):
        self.spans: dict[str, float] = {}
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        with self._lock:
            self.spans[name] = self.spans.get(name, 0.0) + seconds

    def count(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    @contextlib.contextmanager
    def attack(self, name: str = "attack"):
        """Time an attack call into ``name`` and into ``{name}_compile`` when
        the kernel library was built or loaded during it (counted under
        ``library_loads``), else ``{name}_run``."""
        loaded0 = _library_loaded()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            loaded = _library_loaded() and not loaded0
            self.add(name, dt)
            self.add(f"{name}_compile" if loaded else f"{name}_run", dt)
            if loaded:
                self.count("library_loads")
