"""The port's grid runner (``experiments/rq.py``, ``pipeline.py``,
``run_all.py``) against the JAX package's, on the CPU.

- Expansion: for each grid file of ``config/``, over the repo's own
  ``config_dir``, both packages' ``GridRunner`` launch the same ordered list
  of (runner module, composed config). Host work only: no artifact is read.
- ``run_all``: the same sequence of grid and rq4 runs.
- End to end: a tiny synthetic LCLD grid (MoEvA at budgets 3 and 5, PGD
  ``flip`` and ``constraints+flip`` at one ε, 8 states) through both
  packages' ``rq.run``, the JAX runners patched as in
  ``test_torch_runners.py`` (``ObjectiveCalculator(precise=False)``, float64
  ``ConstrainedPGD``, built by a function so that the engine stays of the
  class itself and takes its budget per call) and the port in float64: the
  same file names, PGD metrics within that file's float64 tolerances, the same report points,
  counts, writer and artifact-cache deltas; a rerun that skips every point;
  the port's MoEvA points equal to its standalone runner with a fresh engine;
  ``pipeline: false`` equal to the pipelined grid; a cached PGD engine's
  random starts equal to a fresh engine's.
- The background writer, as ``test_grid_pipeline.py::TestBackgroundWriter``
  holds the JAX one, and the report's keys.
- Refusals and errors: a missing card, ``system.trace_log``, a poisoned
  point, and one point in a subprocess on the CPU.
"""

from __future__ import annotations

import copy
import functools
import json
import logging
import os
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from moeva2_ijcai22_replication_tpu.attacks.objective import ObjectiveCalculator as JObjective
from moeva2_ijcai22_replication_tpu.attacks.pgd import ConstrainedPGD as JPGD
from moeva2_ijcai22_replication_tpu.experiments import common as jcommon
from moeva2_ijcai22_replication_tpu.experiments import moeva as jmoeva
from moeva2_ijcai22_replication_tpu.experiments import pgd as jpgd
from moeva2_ijcai22_replication_tpu.experiments import rq as jrq
from moeva2_ijcai22_replication_tpu.experiments import run_all as jrun_all
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu_torch.domains.lcld import LcldConstraints
from moeva2_ijcai22_replication_tpu_torch.domains.synth import synth_lcld, synth_lcld_schema
from moeva2_ijcai22_replication_tpu_torch.experiments import common
from moeva2_ijcai22_replication_tpu_torch.experiments import moeva as pmoeva
from moeva2_ijcai22_replication_tpu_torch.experiments import pipeline as ppipeline
from moeva2_ijcai22_replication_tpu_torch.experiments import rq as prq
from moeva2_ijcai22_replication_tpu_torch.experiments import run_all as prun_all
from moeva2_ijcai22_replication_tpu_torch.experiments.pipeline import GridPipeline
from moeva2_ijcai22_replication_tpu_torch.utils.config import get_dict_hash, load_config_file
from moeva2_ijcai22_replication_tpu_torch.utils.observability import PhaseTimer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRIDS = [f"{q}.{d}.yaml" for q in ("rq1", "rq2", "rq3", "sm1.1", "sm1.2") for d in ("lcld", "botnet")]
N_STATES = 8
LOSSES = ["flip", "constraints+flip"]


def _port_module(jax_module: str) -> str:
    return jax_module.replace("moeva2_ijcai22_replication_tpu.", "moeva2_ijcai22_replication_tpu_torch.")


def _expand(rq_module, grid: dict, **kwargs) -> list:
    """The (module, config) list that ``rq_module``'s ``GridRunner`` launches."""
    launched = []
    runner = rq_module.GridRunner(copy.deepcopy(grid), **kwargs)
    runner._launch = lambda module, cfg: launched.append((module, cfg))
    runner.run()
    return launched


@pytest.mark.parametrize("name", GRIDS)
def test_grid_expands_as_jax(monkeypatch, name):
    monkeypatch.chdir(REPO)
    grid = load_config_file(os.path.join("config", name))
    want = [(_port_module(m), c) for m, c in _expand(jrq, grid)]
    got = _expand(prq, grid, device="cpu")
    assert len(got) > 0
    assert got == want


def test_run_all_calls_as_jax(monkeypatch):
    monkeypatch.chdir(REPO)
    calls = {"jax": [], "port": []}
    for key, rq_module, moeva_module in (("jax", jrq, jmoeva), ("port", prq, pmoeva)):
        monkeypatch.setattr(rq_module, "run", lambda cfg, key=key, **kw: calls[key].append(("rq", cfg)))
        monkeypatch.setattr(moeva_module, "run", lambda cfg, key=key, **kw: calls[key].append(("moeva", cfg)))
    jrun_all.run("./config")
    prun_all.run("./config", device="cpu")
    assert [kind for kind, _ in calls["port"]] == ["rq"] * 6 + ["moeva"] * 2 + ["rq"] * 4
    assert calls["port"] == calls["jax"]


# -- end to end on a tiny grid ---------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A config_dir over synthetic LCLD artifacts: ``pgd.yaml`` as it is,
    ``moeva.yaml`` with a small population, a static project yaml, and the
    grid."""
    tmp = tmp_path_factory.mktemp("grid")
    paths = synth_lcld_schema(str(tmp))
    cons = LcldConstraints(paths["features"], paths["constraints"])
    x = synth_lcld(N_STATES, cons.schema, seed=3)
    np.save(tmp / "x_candidates.npy", x)
    model = jmlp.lcld_mlp()
    jio.save_params(jio.Surrogate(model, jmlp.init_params(model, cons.schema.n_features, seed=1)),
                    str(tmp / "nn.msgpack"))
    import joblib
    from sklearn.preprocessing import MinMaxScaler

    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in cons.get_feature_min_max(x))
    joblib.dump(MinMaxScaler().fit(np.vstack([x, xl, xu])), tmp / "scaler.joblib")
    config_dir = tmp / "config"
    config_dir.mkdir()
    shutil.copy(os.path.join(REPO, "config", "pgd.yaml"), config_dir / "pgd.yaml")
    moeva_yaml = load_config_file(os.path.join(REPO, "config", "moeva.yaml"))
    moeva_yaml.update(n_pop=16, n_offsprings=8, archive_size=4, max_states_per_call=4)
    static = {
        "project_name": "lcld",
        "paths": {
            "model": str(tmp / "nn.msgpack"),
            "features": paths["features"],
            "constraints": paths["constraints"],
            "x_candidates": str(tmp / "x_candidates.npy"),
            "min_max_scaler": str(tmp / "scaler.joblib"),
            "ml_scaler": str(tmp / "scaler.joblib"),
        },
        "dirs": {"results": str(tmp / "out")},
        "misclassification_threshold": 0.25, "norm": 2, "n_initial_state": -1, "initial_state_offset": 0,
        "system": {"n_jobs": 1, "verbose": 0, "mesh_devices": 0, "jax_cache_dir": ""},
        "save_history": False, "reconstruction": False,
    }
    for name, body in (("moeva", moeva_yaml), ("tiny.static", static)):
        with open(config_dir / f"{name}.yaml", "w") as f:
            yaml.safe_dump(body, f)
    grid = {"config_dir": str(config_dir), "attacks": ["moeva", "pgd"], "seeds": [42], "projects": ["tiny.static"],
            "eps_list": [0.2], "budgets": [3, 5], "loss_evaluations": LOSSES}
    return dict(dir=tmp, out=tmp / "out", grid=grid)


@pytest.fixture
def jax_runners(monkeypatch):
    """The JAX runners with ``test_torch_runners.py``'s patches, and empty
    caches in both packages."""

    def ConstrainedPGD(*args, **kwargs):  # noqa: N802 - the key takes the class's name
        # an instance of the class itself: JAX's PGD takes its budget per
        # call only when ``type(self) is ConstrainedPGD``
        return JPGD(*args, dtype=jnp.float64, **kwargs)

    precise_off = functools.partial(JObjective, precise=False)
    monkeypatch.setattr(jmoeva, "ObjectiveCalculator", precise_off)
    monkeypatch.setattr(jpgd, "ObjectiveCalculator", precise_off)
    monkeypatch.setattr(jpgd, "ConstrainedPGD", ConstrainedPGD)
    for cache in (jcommon.ENGINES, jcommon.ARTIFACTS, common.ENGINES, common.ARTIFACTS):
        cache.clear()
    yield
    jcommon.ENGINES.clear()
    common.ENGINES.clear()


def _report(out) -> dict:
    (name,) = [f for f in os.listdir(out) if f.startswith("grid_report_")]
    with open(out / name) as f:
        return json.load(f)


def _metrics(out, name: str) -> dict:
    with open(out / name) as f:
        return json.load(f)


def test_tiny_grid_matches_jax_end_to_end(tiny, jax_runners, tmp_path):
    grid, out = tiny["grid"], tiny["out"]
    if out.exists():
        shutil.rmtree(out)
    assert jrq.run(copy.deepcopy(grid)) == 6
    jreport = _report(out)
    jdir = tmp_path / "jax"
    shutil.move(str(out), str(jdir))

    assert prq.run(copy.deepcopy(grid), device="cpu", dtype=torch.float64) == 6
    preport = _report(out)
    assert sorted(os.listdir(out)) == sorted(os.listdir(jdir))
    strip = lambda points: [(p["attack"], p["config_hash"], p["skipped"]) for p in points]  # noqa: E731
    assert strip(preport["points"]) == strip(jreport["points"])
    for key in ("grid_config_hash", "points_total", "points_launched", "points_skipped", "artifact_cache"):
        assert preport[key] == jreport[key], key
    assert preport["writer"] == jreport["writer"] == {"submitted": 6, "failures": []}
    assert preport["engine_cache"] == {"hits": 3, "misses": 3, "engines": 3}
    assert preport["execution"] == {"pipeline": True, "mesh_devices": 0, "mesh": None}

    # PGD: float64 in both, so the rates are equal and x_attacks agree to 1e-9
    for p in preport["points"]:
        if not p["attack"].startswith("pgd_"):
            continue
        name = f"{p['attack']}_{p['config_hash']}"
        got, want = _metrics(out, f"metrics_{name}.json"), _metrics(jdir, f"metrics_{name}.json")
        assert got["objectives"] == want["objectives"]
        np.testing.assert_allclose(np.load(out / f"x_attacks_{name}.npy"), np.load(jdir / f"x_attacks_{name}.npy"),
                                   rtol=1e-9, atol=0)

    # MoEvA's draws differ between the packages: the grid's points, served
    # by one cached engine, against the standalone runner on a fresh one
    moeva_points = [p for p in preport["points"] if p["attack"] == "moeva"]
    assert len(moeva_points) == 2
    for budget, p in zip(grid["budgets"], moeva_points):
        cfg = prq._compose(grid["config_dir"], "moeva", "tiny.static",
                           [{"seed": 42, "budget": budget}, {"eps_list": grid["eps_list"]}])
        assert get_dict_hash(cfg) == p["config_hash"]
        alone = copy.deepcopy(cfg)
        alone["dirs"]["results"] = str(tmp_path / "alone")
        common.ENGINES.clear()
        want = pmoeva.run(alone, device="cpu", dtype=torch.float64)
        got = _metrics(out, f"metrics_moeva_{p['config_hash']}.json")
        assert got["objectives_list"] == want["objectives_list"]
        np.testing.assert_array_equal(np.load(out / f"x_attacks_moeva_{p['config_hash']}.npy"),
                                      np.load(tmp_path / "alone" / f"x_attacks_moeva_{get_dict_hash(alone)}.npy"))
        # the writer's spans are in the point's timings
        assert {"setup", "attack", "attack_run", "write", "evaluate"} <= set(got["timings"])

    # a rerun skips every point and writes nothing
    before = sorted(os.listdir(out))
    runner = prq.GridRunner(copy.deepcopy(grid), device="cpu", dtype=torch.float64)
    assert runner.run() == 6
    assert [p["skipped"] for p in runner.report["points"]] == [True] * 6
    assert runner.report["writer"]["submitted"] == 0
    assert sorted(os.listdir(out)) == before


def test_serial_grid_equals_the_pipelined_one(tiny, jax_runners, tmp_path):
    """``pipeline: false`` runs each point's judgement inline, writes no
    report, and gives the pipelined grid's files and metrics."""
    grid, out = copy.deepcopy(tiny["grid"]), tiny["out"]
    grid["budgets"] = [3]
    for pipelined in (True, False):
        if out.exists():
            shutil.rmtree(out)
        assert prq.run(dict(grid, pipeline=pipelined), device="cpu", dtype=torch.float64) == 3
        shutil.move(str(out), str(tmp_path / str(pipelined)))
    serial, piped = tmp_path / "False", tmp_path / "True"
    assert sorted(os.listdir(serial)) == sorted(f for f in os.listdir(piped) if not f.startswith("grid_report_"))
    for f in os.listdir(serial):
        if f.startswith("metrics_"):
            a, b = _metrics(serial, f), _metrics(piped, f)
            assert a.get("objectives", a.get("objectives_list")) == b.get("objectives", b.get("objectives_list"))
        if f.startswith("x_attacks_"):
            np.testing.assert_array_equal(np.load(serial / f), np.load(piped / f))


def test_a_cached_pgd_engine_restarts_as_a_fresh_one(tiny, jax_runners, tmp_path):
    """PGD's random starts are drawn from a generator seeded from the
    engine's ``seed`` on every call: a point served by an engine that ran
    another seed first gives the fresh engine's result, bit for bit."""
    from moeva2_ijcai22_replication_tpu_torch.experiments import pgd as ppgd

    def point(seed: int, out: str) -> dict:
        cfg = prq._compose(tiny["grid"]["config_dir"], "pgd", "tiny.static",
                           [{"seed": seed, "budget": 4}, {"eps": 0.2, "loss_evaluation": "constraints+flip"}])
        cfg.update(nb_random=2, dirs={"results": str(tmp_path / out)})
        return cfg

    before = common.ENGINES.stats()
    for seed in (7, 42):
        ppgd.run(point(seed, "cached"), device="cpu", dtype=torch.float64)
    after = common.ENGINES.stats()
    assert (after["hits"] - before["hits"], after["misses"] - before["misses"], after["engines"]) == (1, 1, 1)
    common.ENGINES.clear()
    ppgd.run(point(42, "fresh"), device="cpu", dtype=torch.float64)
    cached, fresh = point(42, "cached"), point(42, "fresh")
    name = lambda cfg: f"x_attacks_pgd_constraints+flip_{get_dict_hash(cfg)}.npy"  # noqa: E731
    np.testing.assert_array_equal(np.load(tmp_path / "cached" / name(cached)),
                                  np.load(tmp_path / "fresh" / name(fresh)))
    seven = point(7, "cached")
    assert not np.array_equal(np.load(tmp_path / "cached" / name(seven)), np.load(tmp_path / "fresh" / name(fresh)))


# -- the background writer ---------------------------------------------------------


class TestBackgroundWriter:
    def test_fifo_ordering_and_drain(self):
        pipe = GridPipeline()
        done = []
        for i in range(8):
            pipe.submit(f"p{i}", f"/tmp/metrics_{i}", lambda i=i: done.append(i))
        pipe.drain()
        assert done == list(range(8))
        pipe.close()

    def test_pending_until_written(self):
        pipe = GridPipeline()
        gate = threading.Event()
        pipe.submit("p", "/x/metrics.json", lambda: gate.wait(10))
        assert pipe.is_pending("/x/metrics.json")
        gate.set()
        pipe.drain()
        assert not pipe.is_pending("/x/metrics.json")
        pipe.close()

    def test_failure_is_isolated_and_reported(self, tmp_path):
        pipe = GridPipeline()
        done = []

        def boom():
            raise RuntimeError("disk on fire")

        pipe.submit("bad", "/x/a", boom)
        pipe.submit("good", "/x/b", lambda: done.append("ok"))
        report = pipe.finish({"grid": 1}, [str(tmp_path)])
        assert done == ["ok"]
        assert report["writer"]["failures"] == [{"point": "bad", "error": "RuntimeError('disk on fire')"}]
        assert not pipe.is_pending("/x/a")

    def test_should_skip_sees_queued_hashes(self, tmp_path):
        pipe = GridPipeline()
        cfg = {"dirs": {"results": str(tmp_path)}, "attack_name": "moeva"}
        path = common.metrics_path_for(cfg, "moeva")
        gate = threading.Event()
        pipe.submit("moeva", path, lambda: gate.wait(10))
        assert common.should_skip(cfg, "moeva", pipe)
        assert not common.should_skip(cfg, "moeva", None)
        gate.set()
        pipe.close()

    def test_grid_report_contents(self, tmp_path):
        pipe = GridPipeline()
        timer = PhaseTimer()
        timer.add("attack", 2.0)
        timer.add("attack_compile", 1.5)
        timer.count("library_loads")
        later = PhaseTimer()
        later.add("attack", 0.5)
        later.add("attack_run", 0.5)
        pipe.point("pgd_flip", "abc", timer)
        pipe.point("pgd_flip", "def", None, skipped=True)
        pipe.point("pgd_flip", "ghi", later)
        pipe.submit("pgd_flip", "/x/m", lambda: later.add("evaluate", 0.25))
        report = pipe.finish({"seeds": [42]}, [str(tmp_path)])
        assert (report["points_total"], report["points_launched"], report["points_skipped"]) == (3, 2, 1)
        assert report["library_loads"] == 1
        assert report["attack_compile_s"] == pytest.approx(1.5)
        assert report["attack_run_s"] == pytest.approx(0.5)
        assert report["evaluate_s"] == pytest.approx(0.25)
        assert report["cold"] == {"first_point_attack_s": 2.0, "steady_point_attack_s": 0.5, "cold_steady_ratio": 4.0}
        assert report["execution"] == {"pipeline": True, "mesh_devices": 0, "mesh": None}
        assert os.path.basename(report["report_path"]) == f"grid_report_{get_dict_hash({'seeds': [42]})}.json"
        with open(report["report_path"]) as f:
            on_disk = json.load(f)
        assert set(on_disk) == {
            "grid_config_hash", "grid_wallclock_s", "points_total", "points_launched", "points_skipped",
            "library_loads", "attack_compile_s", "attack_run_s", "setup_s", "evaluate_s", "write_s",
            "artifact_cache", "engine_cache", "cold", "writer", "execution", "points",
        }
        # what the JAX report has and the port's leaves out, each named
        assert set(ppipeline.NOT_PORTED) == {"telemetry", "ledger", "cold.process", "distinct_compiled_programs"}
        assert not set(ppipeline.NOT_PORTED) & set(on_disk) and "process" not in on_disk["cold"]
        assert all("A14" in why for key, why in ppipeline.NOT_PORTED.items() if key != "distinct_compiled_programs")


def test_engine_cache_counts_and_names_what_changed():
    from moeva2_ijcai22_replication_tpu_torch.experiments.common import EngineCache

    cache, fields = EngineCache(), ("engine", "surrogate", "n_pop")
    first = cache.get(("moeva", 1, 100), object, fields)
    assert cache.get(("moeva", 1, 100), object, fields) is first
    cache.get(("moeva", 1, 200), object, fields)
    cache.get(("pgd", 1, None), object)
    assert cache.stats() == {"hits": 1, "misses": 3, "engines": 3}
    assert cache.recompile_causes == [{"family": "moeva", "changed": {"n_pop": {"from": "100", "to": "200"}}}]


def test_shared_timer_and_caches_lose_no_update():
    """A point's ``PhaseTimer`` and the process's caches are shared by the
    launching and the writer threads: more threads than cores, switching
    often, lose no span, count or hit and build no key twice."""
    import sys

    from moeva2_ijcai22_replication_tpu_torch.experiments.common import ArtifactCache, EngineCache

    timer, engines, artifacts = PhaseTimer(), EngineCache(), ArtifactCache()
    n_threads, n_calls = 2 * (os.cpu_count() or 1) + 2, 400
    builds = []

    def work():
        for i in range(n_calls):
            timer.add("evaluate", 1.0)
            timer.count("points")
            engines.get(("pgd", i % 4), lambda i=i: builds.append(i % 4) or object())
            artifacts.get("candidates", [__file__], i % 3, lambda: builds.append("artifact") or object())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * n_calls
    assert timer.spans == {"evaluate": float(total)} and timer.counters == {"points": total}
    assert engines.stats() == {"hits": total - 4, "misses": 4, "engines": 4}
    assert artifacts.stats() == {"hits": total - 3, "misses": 3, "evictions": 0, "entries": 3}
    assert sorted(b for b in builds if b != "artifact") == [0, 1, 2, 3] and builds.count("artifact") == 3


# -- refusals and errors ------------------------------------------------------------


def test_missing_card_raises_before_any_point(tiny, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the grid runs on it")
    launched = []
    monkeypatch.setattr(prq.GridRunner, "_launch", lambda self, module, cfg: launched.append(module))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prq.run(copy.deepcopy(tiny["grid"]))
    assert launched == []


def test_trace_log_is_refused_by_name(tiny, monkeypatch):
    launched = []
    monkeypatch.setattr(prq.GridRunner, "_launch", lambda self, module, cfg: launched.append(module))
    grid = dict(copy.deepcopy(tiny["grid"]), system={"trace_log": "trace.jsonl"})
    with pytest.raises(NotImplementedError, match=r"config sets system\.trace_log.*ROADMAP A14"):
        prq.GridRunner(grid, device="cpu")
    assert launched == []


def test_a_poisoned_point_is_logged_and_the_sweep_goes_on(tiny, jax_runners, tmp_path, caplog):
    grid = dict(copy.deepcopy(tiny["grid"]), attacks=["pgd"], budgets=[3], loss_evaluations=["flip"],
                models=[str(tmp_path / "missing.msgpack"), str(tiny["dir"] / "nn.msgpack")])
    out = tiny["out"]
    if out.exists():
        shutil.rmtree(out)
    with caplog.at_level(logging.ERROR, logger=prq.logger.name):
        runner = prq.GridRunner(grid, device="cpu", dtype=torch.float64)
        assert runner.run() == 2
    failed = [r for r in caplog.records if "grid point failed" in r.getMessage()]
    assert len(failed) == 1 and "missing.msgpack" in str(failed[0].exc_info[1])
    assert len([f for f in os.listdir(out) if f.startswith("metrics_pgd_flip_")]) == 1
    assert runner.report["points_launched"] == 1 and runner.report["writer"]["failures"] == []


def test_a_subprocess_point_runs_on_the_cpu(tiny, monkeypatch, tmp_path):
    """``use_subprocess=True`` launches the runner's command line with the
    device and dtype as its arguments; the point writes the in-process
    point's file names."""
    monkeypatch.chdir(REPO)
    grid = dict(copy.deepcopy(tiny["grid"]), attacks=["pgd"], budgets=[3], loss_evaluations=["flip"])
    out = tiny["out"]
    names = {}
    for use_subprocess in (True, False):
        if out.exists():
            shutil.rmtree(out)
        common.ENGINES.clear()
        assert prq.run(copy.deepcopy(grid), use_subprocess=use_subprocess, device="cpu", dtype=torch.float64) == 1
        names[use_subprocess] = sorted(f for f in os.listdir(out) if not f.startswith("grid_report_"))
    assert len(names[True]) == 4 and names[True] == names[False]


def test_a_grid_runs_moeva_points_with_an_early_exit(tiny, tmp_path):
    """A grid whose ``moeva.yaml`` sets the early exit, quality samples and
    checkpoints runs its points through the runner unchanged: each point's
    ``execution`` records the gate and the steps it ran, and no checkpoint
    is left behind."""
    config_dir = tmp_path / "config"
    shutil.copytree(tiny["grid"]["config_dir"], config_dir)
    moeva_yaml = load_config_file(str(config_dir / "moeva.yaml"))
    moeva_yaml.update(early_stop_check_every=2, early_stop_threshold=0.55, compaction_buckets=[1, 2, 4],
                      quality_every=2, checkpoint_every=3)
    with open(config_dir / "moeva.yaml", "w") as f:
        yaml.safe_dump(moeva_yaml, f)
    static = load_config_file(str(config_dir / "tiny.static.yaml"))
    static["dirs"] = {"results": str(tmp_path / "out")}
    with open(config_dir / "tiny.static.yaml", "w") as f:
        yaml.safe_dump(static, f)
    grid = dict(tiny["grid"], config_dir=str(config_dir), attacks=["moeva"], budgets=[5, 9])
    common.ENGINES.clear()
    assert prq.run(grid, device="cpu") == 2
    out = tmp_path / "out"
    metrics = [_metrics(out, f) for f in sorted(os.listdir(out)) if f.startswith("metrics_")]
    assert len(metrics) == 2 and not [f for f in os.listdir(out) if f.startswith("checkpoint_")]
    chunks = -(-N_STATES // 4)
    for m in metrics:
        ex = m["execution"]
        assert ex["early_stop_check_every"] == 2 and ex["max_states_per_call"] == 4
        assert 0 < ex["gens_executed"] <= chunks * (m["config"]["budget"] - 1)
    assert any(m["execution"]["gens_executed"] < chunks * (m["config"]["budget"] - 1) for m in metrics)
    common.ENGINES.clear()
