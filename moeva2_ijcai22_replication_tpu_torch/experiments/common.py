"""Shared runner plumbing: artifact loading, skip-if-done, SAT builders.

Port of the parts of ``experiments/common.py`` that the runners and the
grid runner call: the memoizing :class:`ArtifactCache` and the engine cache
:class:`EngineCache` (``ENGINES``: one engine per static config, shared by
the points of a grid), :func:`metrics_path_for` and :func:`should_skip`, the
loaders of constraints, candidates, scaler and surrogate,
:func:`get_sat_builder`, :func:`evaluation_constraints` and the runners'
``reconstruction`` (:func:`reconstruct`), and the batch-shape menu
(:class:`BucketMenu`, ``DEFAULT_BUCKET_SIZES``) that MoEvA's early exit
repacks its active set down, with :func:`pad_states`.

The scaler's suffix picks its format: ``.joblib`` (an sklearn
``MinMaxScaler``, read through joblib on the CPU, as the JAX package reads
it) or ``.npz`` (``models.scalers.save_npz``, numpy alone: the format a
machine without sklearn reads).

Not ported yet: the cold-start hook of the artifact cache (A14). A device
mesh and the JAX compilation cache have no counterpart on one card:
``system.mesh_devices`` other than 0 is refused (:func:`refuse_knobs`), and
the menu and :func:`pad_states` take no mesh: their JAX counterparts' mesh
arguments only hold sizes to multiples of the mesh size, which is 1 here.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..domains import augmentation, get_constraints_class
from ..domains.botnet_sat import make_botnet_sat_builder
from ..domains.lcld_sat import make_lcld_sat_builder
from ..models.scalers import MinMaxParams, load_joblib_scaler, load_npz
from ..utils.config import get_dict_hash
from ..utils.in_out import load_model


#: The batch-shape menu of the early exit's compaction (and of the serving
#: microbatcher, ROADMAP A13): powers of two keep the number of distinct
#: shapes logarithmic in the largest batch while padding wastes under 2x.
DEFAULT_BUCKET_SIZES = (8, 16, 32, 64, 128, 256)


class RequestTooLarge(ValueError):
    """A row count exceeds the largest bucket; it can never dispatch."""


class BucketMenu:
    """The fixed menu of allowed batch shapes, sorted, positive and without
    duplicates."""

    def __init__(self, sizes=DEFAULT_BUCKET_SIZES):
        sizes = sorted(int(s) for s in sizes)
        if not sizes or sizes[0] < 1:
            raise ValueError(f"bucket menu must be non-empty positive: {sizes}")
        if len(set(sizes)) != len(sizes):
            raise ValueError(f"bucket menu has duplicates: {sizes}")
        self.sizes = tuple(sizes)
        self.max_size = sizes[-1]

    def bucket_for(self, n_rows: int) -> int:
        """Smallest menu size that fits ``n_rows``."""
        for s in self.sizes:
            if n_rows <= s:
                return s
        raise RequestTooLarge(f"{n_rows} rows exceed the largest bucket {self.max_size}")

    def shrink_bucket(self, n_rows: int, current: int) -> int | None:
        """Smallest menu size that fits ``n_rows`` and lies strictly below
        the ``current`` batch shape; None when no menu size improves on
        ``current`` (also when ``n_rows`` is above the menu)."""
        for s in self.sizes:
            if n_rows <= s:
                return s if s < current else None
        return None


def pad_states(x: np.ndarray, bucket: int | None = None) -> tuple[np.ndarray, int]:
    """``(x, n)`` padded on its leading (states) axis to exactly ``bucket``
    rows with copies of the last row, and its original row count ``n``; a
    no-op without ``bucket`` (one card: no mesh multiple to pad to)."""
    n = x.shape[0]
    if bucket is None or bucket == n:
        return x, n
    if bucket < n:
        raise ValueError(f"bucket={bucket} smaller than n_states={n}")
    return np.concatenate([x, np.repeat(x[-1:], bucket - n, axis=0)]), n


class ArtifactCache:
    """Path-keyed memoizer for on-disk experiment artifacts.

    An entry is valid while every file it was built from keeps its
    (mtime_ns, size) stamp; a touched or rewritten file invalidates exactly
    that entry on the next lookup. ``hits``, ``misses`` and ``evictions``
    (a rebuild because a file changed under a live key) feed the grid
    report. Lookups are serialized: a grid's background writer and its
    launching thread look up at once, and a racing miss must never build
    twice (a second constraints object would change a later ``id()``-keyed
    engine key)."""

    def __init__(self):
        self._entries: dict = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def _stamp(paths: tuple) -> tuple:
        return tuple((p, st.st_mtime_ns, st.st_size) for p, st in ((p, os.stat(p)) for p in paths))

    def get(self, kind: str, paths, extra, builder):
        """``builder()``'s result memoized under ``(kind, paths, extra)``,
        rebuilt when any of ``paths`` changed on disk."""
        paths = tuple(os.path.abspath(p) for p in paths)
        key = (kind, paths, extra)
        stamp = self._stamp(paths)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[0] == stamp:
                self.hits += 1
                return entry[1]
            if entry is not None:
                self.evictions += 1
            self.misses += 1
            value = builder()
            self._entries[key] = (stamp, value)
            return value

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses, "evictions": self.evictions,
                "entries": len(self._entries)}

    def clear(self):
        self._entries.clear()


#: process-wide artifact cache: one disk read per artifact per process
ARTIFACTS = ArtifactCache()


class EngineCache:
    """Attack engines keyed by their static config.

    An engine holds its model copy and tables on the device, so the points
    of a grid that share a static config share one engine; per-point knobs
    (seed, MoEvA's ``n_gen``) are set again on the cached instance, and PGD
    takes ε and its budget per call. A key holds every constructor argument
    that shapes the engine. ``hits`` and ``misses`` feed the grid report; a
    miss beside a cached key of the same family records which of the key's
    ``fields`` differed (``recompile_causes``, the newest ``MAX_CAUSES``).

    :meth:`stats` reports ``hits``, ``misses`` and ``engines``. The JAX
    package's ``traces`` (programs its engines traced) has no counterpart:
    the port's engines trace nothing, and the kernel library they load once
    is counted by ``PhaseTimer`` as ``library_loads``."""

    MAX_CAUSES = 32

    def __init__(self):
        self._engines: dict = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.recompile_causes: list[dict] = []

    def get(self, key: tuple, builder, fields: tuple | None = None):
        """The engine under ``key``, built by ``builder()`` on a miss;
        ``fields`` names the key's positions for ``recompile_causes``."""
        with self._lock:
            engine = self._engines.get(key)
            if engine is not None:
                self.hits += 1
                return engine
            self.misses += 1
            cause = self._recompile_cause(key, fields)
            if cause is not None:
                self.recompile_causes.append(cause)
                del self.recompile_causes[: -self.MAX_CAUSES]
            engine = self._engines[key] = builder()
            return engine

    def _recompile_cause(self, key: tuple, fields: tuple | None) -> dict | None:
        """The fields in which ``key`` differs from the cached key of its
        family that differs in the fewest; None when none is cached."""
        names = list(fields or ())
        name = lambda i: names[i] if i < len(names) else f"field_{i}"  # noqa: E731
        best = None
        for k in self._engines:
            if k[0] != key[0] or len(k) != len(key):
                continue
            changed = {name(i): {"from": repr(k[i]), "to": repr(key[i])} for i in range(len(key)) if k[i] != key[i]}
            if best is None or len(changed) < len(best):
                best = changed
        return None if best is None else {"family": str(key[0]), "changed": best}

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses, "engines": len(self._engines)}

    def clear(self):
        self._engines.clear()


#: process-wide engine cache, shared by every grid of the process
ENGINES = EngineCache()


def refuse_knobs(config: dict, refused: dict) -> None:
    """Raise ``NotImplementedError`` for the first knob of ``refused``
    (``name -> (is set in config, what ports it)``) that the config sets,
    and for the knobs no runner of the port takes: ``system.mesh_devices``
    other than 0, ``system.trace_log`` and ``system.profile_dir``."""
    system = config.get("system", {}) or {}
    common = {
        "system.mesh_devices": (int(system.get("mesh_devices", 0) or 0) != 0,
                                "a device mesh, which one card does not have"),
        "system.trace_log": (bool(system.get("trace_log")), "the tracing layer (ROADMAP A14)"),
        "system.profile_dir": (bool(system.get("profile_dir")), "the profiler hook maybe_profile (ROADMAP A14)"),
    }
    for name, (is_set, item) in {**refused, **common}.items():
        if is_set:
            raise NotImplementedError(f"config sets {name}, which the port does not run yet: it needs {item}")


def metrics_path_for(config: dict, mid_fix: str) -> str:
    out_dir = config["dirs"]["results"]
    return f"{out_dir}/metrics_{mid_fix}_{get_dict_hash(config)}.json"


def should_skip(config: dict, mid_fix: str, pipeline=None) -> bool:
    """Config-hash idempotency: a metrics file for this exact config means
    the experiment already ran. Under a grid pipeline a metrics file still
    queued on the background writer skips too."""
    path = metrics_path_for(config, mid_fix)
    if os.path.exists(path) or (pipeline is not None and pipeline.is_pending(path)):
        print(f"Configuration with hash {get_dict_hash(config)} already executed. Skipping")
        return True
    return False


def load_constraints(config: dict):
    """The project's constraint class from the registry, over the config's
    schema files and, where the config names one,
    ``paths.important_features`` (passed as ``important_features_path``;
    it is part of the memo key); memoized, so runs naming the same files
    share one object. A ``spec:`` key names a spec file (a domain compiled
    from the constraint IR) that is compiled under the project's name in
    place of the registry's class; the file is part of the memo key and of
    its stamp, so an edited spec is compiled again, a new identity."""
    project = config["project_name"]
    spec_path = config.get("spec")
    paths = [config["paths"]["features"], config["paths"]["constraints"]]
    important = config["paths"].get("important_features")
    if important:
        paths.append(important)
    if spec_path:
        paths.append(spec_path)
    kwargs = {"important_features_path": important} if important else {}

    def build():
        if spec_path:
            from ..domains.ir import compile_spec_path

            cls = compile_spec_path(spec_path, name=project)
        else:
            cls = get_constraints_class(project)
        return cls(paths[0], paths[1], **kwargs)

    return ARTIFACTS.get("constraints", paths, (project, bool(important)), build)


def load_candidates(config: dict) -> np.ndarray:
    """The candidate set, sliced to the configured window;
    ``n_initial_state=-1`` keeps everything. The full ``np.load`` is
    memoized per file, the slice is a view of it (read-only to runners)."""
    path = config["paths"]["x_candidates"]
    x = ARTIFACTS.get("candidates", [path], None, lambda: np.load(path))
    offset, count = config["initial_state_offset"], config["n_initial_state"]
    return x if count == -1 else x[offset : offset + count]


def load_scaler_file(path: str) -> MinMaxParams:
    """A scaler by its suffix: ``.npz`` (numpy alone) or ``.joblib``
    (joblib and sklearn, on the CPU)."""
    if path.endswith(".npz"):
        return load_npz(path)
    if path.endswith(".joblib"):
        return load_joblib_scaler(path)
    raise ValueError(f"Unknown scaler artifact {path!r}: expected .npz or .joblib")


def load_scaler(config: dict) -> MinMaxParams:
    path = config["paths"]["ml_scaler"]
    return ARTIFACTS.get("scaler", [path], None, lambda: load_scaler_file(path))


def load_surrogate(config: dict):
    path = config["paths"]["model"]

    def build():
        model = load_model(path)
        from ..models.io import Surrogate

        if not isinstance(model, Surrogate):
            raise TypeError(
                f"{path} is not a device-runnable surrogate; attack runners need a Keras/Flax artifact"
            )
        return model

    return ARTIFACTS.get("surrogate", [path], None, build)


def get_sat_builder(project_name: str, constraints):
    """Project name -> MILP row builder (lcld and botnet prefixes). A domain
    compiled from a spec routes to the IR's MILP backend first, before the
    prefixes match, so that ``lcld_spec`` gets its own linearization and not
    its hand-written twin's (as the JAX package's runner does)."""
    from ..domains.ir import SpecConstraintSet, make_spec_sat_builder

    if isinstance(constraints, SpecConstraintSet):
        return make_spec_sat_builder(constraints)
    if project_name.startswith("lcld"):
        return make_lcld_sat_builder(constraints.schema)
    if project_name.startswith("botnet"):
        return make_botnet_sat_builder(constraints)
    raise ValueError(f"No SAT constraint builder for project {project_name!r}")


def reconstruct(x_attacks: np.ndarray, constraints) -> np.ndarray:
    """The attacked rows with their last P (augmented) columns stripped and
    re-derived from the base features (``augmentation.augment``), in the
    rows' dtype."""
    important = constraints.important_features
    base = torch.as_tensor(np.asarray(x_attacks)[..., : -augmentation.n_pairs(important)])
    return augmentation.augment(base, important).numpy()


def evaluation_constraints(config: dict, attack_constraints):
    """RQ2's evaluation override: success judged under another constraint
    set than the attack used (``lcld_augmented`` reads the
    ``important_features.npy`` beside the features file,
    ``botnet_augmented`` the ``important_features_19.npy``)."""
    ev = config.get("evaluation")
    if not ev:
        return attack_constraints
    paths = [config["paths"]["features"], ev["constraints"]]
    return ARTIFACTS.get(
        "constraints",
        paths,
        (ev["project_name"], False),
        lambda: get_constraints_class(ev["project_name"])(paths[0], paths[1]),
    )
