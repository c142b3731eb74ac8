"""The port's experiment runners against the JAX package's, on the CPU.

Both packages' ``experiments.moeva.run`` and ``experiments.pgd.run`` take
one composed config (``config/moeva.yaml`` or ``config/pgd.yaml`` with an
rq1-shaped project block) over the same artifacts: synthetic LCLD
candidates, a surrogate written by the JAX package's ``save_params`` and an
sklearn scaler in a ``.joblib``. They must agree on the config hash, the
metrics path and every file name, on the metrics' keys (the port's lacks
only ``telemetry``) and on ``execution``. PGD runs in float64 in both (the
JAX runner's ``ConstrainedPGD`` is patched to float64 here, as
``test_torch_pgd.py`` compares runs), so that on every rq1 loss, ``flip+sat``
included, o1..o7 are equal and ``x_attacks`` agree to 1e-9 relative.
MoEvA's draws differ between the packages, so the port runner's rates are
held against the port's own ``Moeva2.generate`` and ``ObjectiveCalculator``
on the same inputs (``test_torch_engine.py`` holds those against
``oracle_ga``).

Two patches of the JAX runners' namespaces, test side only:
``ObjectiveCalculator`` with ``precise=False`` (its ``precise=True`` path
imports ``jax.experimental.enable_x64``, which jax 0.9.0 lacks; under the
tests' x64 the judgement is float64 all the same) and the float64 PGD.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import shutil

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
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator
from moeva2_ijcai22_replication_tpu_torch.domains.lcld import LcldConstraints
from moeva2_ijcai22_replication_tpu_torch.domains.synth import synth_lcld, synth_lcld_schema
from moeva2_ijcai22_replication_tpu_torch.experiments import common
from moeva2_ijcai22_replication_tpu_torch.experiments import moeva as pmoeva
from moeva2_ijcai22_replication_tpu_torch.experiments import pgd as ppgd
from moeva2_ijcai22_replication_tpu_torch.models.io import load_params
from moeva2_ijcai22_replication_tpu_torch.models.scalers import from_sklearn_minmax, save_npz
from moeva2_ijcai22_replication_tpu_torch.utils.config import get_dict_hash

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RQ1_LOSSES = (
    "flip", "flip+sat", "constraints+flip", "constraints+flip+adaptive_eps_step",
    "constraints+flip+adaptive_eps_step+repair",
)
N_STATES = 12


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runner_artifacts")
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
    scaler = MinMaxScaler().fit(np.vstack([x, xl, xu]))
    joblib.dump(scaler, tmp / "scaler.joblib")
    save_npz(from_sklearn_minmax(scaler), str(tmp / "scaler.npz"))
    return dict(dir=tmp, paths=paths, x=x)


@pytest.fixture
def jax_runners(monkeypatch):
    """The JAX runners with the test-side patches, and empty caches."""

    class Float64PGD(JPGD):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, dtype=jnp.float64, **kwargs)

    precise_off = functools.partial(JObjective, precise=False)
    monkeypatch.setattr(jmoeva, "ObjectiveCalculator", precise_off)
    monkeypatch.setattr(jpgd, "ObjectiveCalculator", precise_off)
    monkeypatch.setattr(jpgd, "ConstrainedPGD", Float64PGD)
    jcommon.ENGINES.clear()
    jcommon.ARTIFACTS.clear()
    common.ARTIFACTS.clear()
    yield
    jcommon.ENGINES.clear()


def _config(artifacts, out_dir, base: str, scaler: str = "scaler.joblib", **over) -> dict:
    """``config/{base}.yaml`` with an rq1-shaped project block over the
    test's artifacts, then ``over``."""
    with open(os.path.join(REPO, "config", f"{base}.yaml")) as f:
        cfg = yaml.safe_load(f)
    tmp = artifacts["dir"]
    cfg.update({
        "project_name": "lcld",
        "paths": {
            "model": str(tmp / "nn.msgpack"),
            "features": artifacts["paths"]["features"],
            "constraints": artifacts["paths"]["constraints"],
            "x_candidates": str(tmp / "x_candidates.npy"),
            "min_max_scaler": str(tmp / scaler),
            "ml_scaler": str(tmp / scaler),
        },
        "dirs": {"results": str(out_dir)},
        "misclassification_threshold": 0.25,
        "norm": 2,
        "n_initial_state": -1,
        "initial_state_offset": 0,
        "system": {"n_jobs": 1, "verbose": 0, "mesh_devices": 0, "jax_cache_dir": ""},
        "save_history": False,
        "reconstruction": False,
        "seed": 42,
    })
    cfg.update(over)
    return cfg


def _run_both(jrun, prun, cfg, out_dir, dtype):
    """The JAX runner, its files moved aside, then the port's in the same
    results directory: (jax metrics, jax files, port metrics, port files)."""
    jm = jrun(copy.deepcopy(cfg))
    jdir = out_dir.parent / (out_dir.name + "_jax")
    shutil.move(str(out_dir), str(jdir))
    pm = prun(copy.deepcopy(cfg), device="cpu", dtype=dtype)
    return jm, sorted(os.listdir(jdir)), pm, sorted(os.listdir(out_dir)), jdir


def _same_identity(cfg, jm, jfiles, pm, pfiles, mid_fix):
    h = get_dict_hash(cfg)
    assert pm["config_hash"] == jm["config_hash"] == h
    assert common.metrics_path_for(cfg, mid_fix) == jcommon.metrics_path_for(cfg, mid_fix)
    assert pfiles == jfiles
    assert set(pm) == set(jm) - {"telemetry"}
    assert pm["execution"] == jm["execution"]
    assert pm["config"] == jm["config"] == cfg


@pytest.mark.parametrize("loss", RQ1_LOSSES)
def test_pgd_runner_matches_jax_float64(artifacts, jax_runners, tmp_path, loss):
    out = tmp_path / "out"
    cfg = _config(artifacts, out, "pgd", budget=20, eps=0.2, loss_evaluation=loss)
    jm, jfiles, pm, pfiles, jdir = _run_both(jpgd.run, ppgd.run, cfg, out, torch.float64)
    mid_fix = f"pgd_{loss}"
    _same_identity(cfg, jm, jfiles, pm, pfiles, mid_fix)
    assert pm["objectives"] == jm["objectives"]
    name = f"x_attacks_{mid_fix}_{pm['config_hash']}.npy"
    np.testing.assert_allclose(np.load(out / name), np.load(jdir / name), rtol=1e-9, atol=0)
    csv = f"success_rate_{mid_fix}_{pm['config_hash']}.csv"
    assert (out / csv).read_bytes() == (jdir / csv).read_bytes()
    with open(out / f"metrics_{mid_fix}_{pm['config_hash']}.json") as f:
        assert json.load(f)["objectives"] == pm["objectives"]
    # skip-if-done, in both packages
    assert ppgd.run(copy.deepcopy(cfg), device="cpu", dtype=torch.float64) is None
    shutil.move(str(out), str(tmp_path / "out_port"))
    shutil.move(str(jdir), str(out))
    assert jpgd.run(copy.deepcopy(cfg)) is None


def test_moeva_runner_matches_jax_and_the_port_engine(artifacts, jax_runners, tmp_path):
    out = tmp_path / "out"
    cfg = _config(artifacts, out, "moeva", budget=5, n_pop=16, n_offsprings=8, archive_size=4,
                  max_states_per_call=8, eps_list=[0.2, 0.5])
    jm, jfiles, pm, pfiles, _ = _run_both(jmoeva.run, pmoeva.run, cfg, out, torch.float32)
    _same_identity(cfg, jm, jfiles, pm, pfiles, "moeva")
    assert pm["execution"] == {"max_states_per_call": 8, "mesh": None, "early_stop_check_every": 0,
                               "gens_executed": 8}
    # the port's engine and judgement on the same inputs
    tmp = artifacts["dir"]
    cons = LcldConstraints(artifacts["paths"]["features"], artifacts["paths"]["constraints"])
    sur = load_params(str(tmp / "nn.msgpack"))
    scaler = common.load_scaler_file(str(tmp / "scaler.joblib"))
    res = Moeva2(sur, cons, ml_scaler=scaler, norm=2, n_gen=5, n_pop=16, n_offsprings=8, seed=42, archive_size=4,
                 max_states_per_call=8, device="cpu").generate(artifacts["x"], 1)
    np.testing.assert_array_equal(np.load(out / f"x_attacks_moeva_{pm['config_hash']}.npy"), res.x_ml)
    rates = []
    for eps in (0.2, 0.5):
        calc = ObjectiveCalculator(sur, cons, {"f1": 0.25, "f2": eps}, scaler, minimize_class=1, norm=2,
                                   ml_scaler=scaler)
        rates.append(calc.success_rate_3d_record(artifacts["x"], res.x_ml))
    assert pm["objectives_list"] == rates
    assert pmoeva.run(copy.deepcopy(cfg), device="cpu") is None


def test_npz_scaler_runs_as_the_joblib_one(artifacts, jax_runners, tmp_path):
    metrics = {}
    for scaler in ("scaler.joblib", "scaler.npz"):
        cfg = _config(artifacts, tmp_path / scaler, "pgd", scaler=scaler, budget=10, eps=0.2,
                      loss_evaluation="constraints+flip")
        metrics[scaler] = ppgd.run(cfg, device="cpu")
    assert metrics["scaler.npz"]["objectives"] == metrics["scaler.joblib"]["objectives"]
    assert metrics["scaler.npz"]["config_hash"] != metrics["scaler.joblib"]["config_hash"]


def test_pgd_runner_refuses_nan_rows_as_jax(jax_runners, tmp_path):
    """State 1609 of ``synth_lcld(4000, seed=42)`` under the seeded LCLD
    surrogate and ``constraints+flip`` runs into an infinite gradient entry:
    its row of x_adv turns NaN (under L2, in both packages, in float64), and
    both runners' judgement refuses the result with the same
    ``AssertionError`` before writing any file."""
    from sklearn.preprocessing import MinMaxScaler
    import joblib

    from moeva2_ijcai22_replication_tpu_torch.models.io import save_params
    from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_lcld_problem

    _, sur, scaler, x = synthetic_lcld_problem(str(tmp_path), 4000)
    np.save(tmp_path / "x_candidates.npy", x[[1609, 0, 1]])
    save_params(sur, str(tmp_path / "nn.msgpack"))
    lo = -scaler.min_ / scaler.scale
    joblib.dump(MinMaxScaler().fit(np.vstack([lo, lo + 1.0 / scaler.scale])), tmp_path / "scaler.joblib")
    art = {"dir": tmp_path, "paths": {"features": str(tmp_path / "features.csv"),
                                      "constraints": str(tmp_path / "constraints.csv")}}
    cfg = _config(art, tmp_path / "out", "pgd", budget=1000, eps=0.2, loss_evaluation="constraints+flip")
    with pytest.raises(AssertionError, match="min-max scaled values outside") as want:
        jpgd.run(copy.deepcopy(cfg))
    with pytest.raises(AssertionError) as got:
        ppgd.run(copy.deepcopy(cfg), device="cpu", dtype=torch.float64)
    assert str(got.value) == str(want.value)
    assert not [f for f in os.listdir(tmp_path / "out") if f.startswith("metrics_")]


REFUSED = [
    ("moeva", {"system": {"trace_log": "trace.jsonl"}}, "system.trace_log"),
    ("moeva", {"system": {"profile_dir": "prof"}}, "system.profile_dir"),
    ("moeva", {"system": {"mesh_devices": 8}}, "system.mesh_devices"),
    ("pgd", {"system": {"trace_log": "trace.jsonl"}}, "system.trace_log"),
    ("pgd", {"system": {"profile_dir": "prof"}}, "system.profile_dir"),
    ("pgd", {"system": {"mesh_devices": -1}}, "system.mesh_devices"),
]


@pytest.mark.parametrize("base, over, knob", REFUSED, ids=[f"{b}-{k}" for b, _, k in REFUSED])
def test_refused_knob_raises_before_any_device_work(artifacts, tmp_path, base, over, knob):
    """Each refused knob raises its own error before the device is looked
    at (``device="cuda"`` here, where there is no card) and before any file
    is written."""
    extra = {"budget": 5, "eps": 0.2, "loss_evaluation": "flip"} if base == "pgd" else {"budget": 5, "eps_list": [0.2]}
    cfg = _config(artifacts, tmp_path / "out", base, **{**extra, **over})
    runner = pmoeva if base == "moeva" else ppgd
    with pytest.raises(NotImplementedError, match=f"config sets {knob}"):
        runner.run(cfg, device="cuda")
    assert not (tmp_path / "out").exists()


def test_save_history_is_refused_naming_its_item(artifacts, tmp_path):
    """``save_history`` runs through the runner, which writes its
    ``x_history`` file; with ``early_stop_check_every`` it raises the JAX
    engine's ``ValueError`` (the early exit's repacks would cut the records'
    states axis) before the attack writes anything."""
    cfg = _config(artifacts, tmp_path / "out", "moeva", budget=5, eps_list=[0.2], save_history="reduced",
                  early_stop_check_every=2)
    common.ENGINES.clear()
    with pytest.raises(ValueError, match="early_stop_check_every is incompatible with save_history"):
        pmoeva.run(copy.deepcopy(cfg), device="cpu")
    assert not list((tmp_path / "out").iterdir())
    cfg["early_stop_check_every"] = 0
    metrics = pmoeva.run(cfg, device="cpu")
    history = np.load(tmp_path / "out" / f"x_history_moeva_{metrics['config_hash']}.npy")
    assert history.shape == (4, N_STATES, cfg["n_offsprings"], 3)
    common.ENGINES.clear()


#: the engine's extras, each run by the runner on the CPU: (id, config
#: overrides, the engine knobs the runner must set from them)
EXTRAS = [
    ("early_stop_check_every", {"early_stop_check_every": 2, "early_stop_threshold": 0.5,
                                "compaction_buckets": [2, 4]},
     dict(early_stop_check_every=2, early_stop_threshold=0.5, compaction_buckets=(2, 4))),
    ("early_stop_defaults", {"early_stop_check_every": 3},
     dict(early_stop_check_every=3, early_stop_threshold=0.25)),
    ("early_stop_eps", {"early_stop_check_every": 2, "early_stop_threshold": 0.55, "early_stop_eps": 0.01},
     dict(early_stop_check_every=2, early_stop_threshold=0.55, early_stop_eps=0.01)),
    ("quality_every", {"quality_every": 2}, dict(quality_every=2)),
    ("checkpoint_every", {"checkpoint_every": 2}, dict(checkpoint_every=2)),
    ("init", {"init": "lp_ratio", "init_eps": 0.2, "init_ratio": 0.25},
     dict(init="lp_ratio", init_eps=0.2, init_ratio=0.25)),
]


@pytest.mark.parametrize("over, knobs", [e[1:] for e in EXTRAS], ids=[e[0] for e in EXTRAS])
def test_moeva_runner_runs_the_engine_extras(artifacts, tmp_path, over, knobs):
    """Each knob of the engine's extras runs through the runner on the CPU:
    the populations equal the port's engine set as the JAX runner sets it
    (``early_stop_threshold`` defaults to ``misclassification_threshold``,
    quality on), ``execution`` records the knob and the generation steps
    run, and a completed run leaves no checkpoint."""
    out = tmp_path / "out"
    cfg = _config(artifacts, out, "moeva", budget=9, n_pop=16, n_offsprings=8, archive_size=4,
                  max_states_per_call=8, eps_list=[0.2], **over)
    common.ENGINES.clear()
    pm = pmoeva.run(copy.deepcopy(cfg), device="cpu")
    tmp = artifacts["dir"]
    cons = LcldConstraints(artifacts["paths"]["features"], artifacts["paths"]["constraints"])
    eng = Moeva2(load_params(str(tmp / "nn.msgpack")), cons, ml_scaler=common.load_scaler_file(str(tmp / "scaler.joblib")),
                 norm=2, n_gen=9, n_pop=16, n_offsprings=8, seed=42, archive_size=4, max_states_per_call=8,
                 device="cpu", record_quality=True, **{"early_stop_threshold": 0.25, **knobs})
    res = eng.generate(artifacts["x"], 1)
    np.testing.assert_array_equal(np.load(out / f"x_attacks_moeva_{pm['config_hash']}.npy"), res.x_ml)
    assert pm["execution"] == {"max_states_per_call": 8, "mesh": None,
                               "early_stop_check_every": knobs.get("early_stop_check_every", 0),
                               "gens_executed": res.gens_executed}
    if "early_stop_check_every" in over and "compaction_buckets" in over:
        assert res.early_stop["compaction"]  # states parked
    assert not [f for f in os.listdir(out) if f.startswith("checkpoint_")]
    assert pmoeva.run(copy.deepcopy(cfg), device="cpu") is None


def test_cached_engine_takes_init_eps_and_ratio(artifacts, tmp_path):
    """The engine cache keys MoEvA's engine on ``init_eps`` and
    ``init_ratio``; the engine it builds carries them."""
    tmp = artifacts["dir"]
    cons = LcldConstraints(artifacts["paths"]["features"], artifacts["paths"]["constraints"])
    sur, scaler = load_params(str(tmp / "nn.msgpack")), common.load_scaler_file(str(tmp / "scaler.joblib"))
    common.ENGINES.clear()
    engines = []
    for eps, ratio in ((0.3, 0.75), (0.05, 0.75), (0.3, 0.1)):
        cfg = _config(artifacts, tmp_path, "moeva", budget=3, n_pop=16, n_offsprings=8, archive_size=4, init="lp_ratio",
                      init_eps=eps, init_ratio=ratio)
        eng = pmoeva._cached_engine(cfg, sur, cons, scaler, torch.device("cpu"), torch.float32)
        assert (eng.init, eng.init_eps, eng.init_ratio) == ("lp_ratio", eps, ratio)
        engines.append(eng)
    assert len({id(e) for e in engines}) == 3
    common.ENGINES.clear()


class _Reached(Exception):
    """Raised by the stand-in kernel once the run has reached it."""


def test_autopgd_on_botnet_is_refused_on_the_card_before_any_device_work(tmp_path, monkeypatch):
    """AutoPGD runs on the card wherever constrained PGD has a kernel, the
    augmented botnet domain too: on a pretended card (every tensor reads
    ``is_cuda``, the labels' and the run's kernels stood in for) the runner
    reaches ``kernels.pgd_botnet``, K7b, with the set's 927-feature rows and
    its pairs' tables."""
    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.models.io import save_params
    from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_botnet_augmented_problem

    _, sur, scaler, x = synthetic_botnet_augmented_problem(str(tmp_path), 8)
    np.save(tmp_path / "x_candidates.npy", x)
    save_params(sur, str(tmp_path / "nn.msgpack"))
    save_npz(scaler, str(tmp_path / "scaler.npz"))
    art = {"dir": tmp_path, "paths": {"features": str(tmp_path / "features_augmented.csv"),
                                      "constraints": str(tmp_path / "constraints_augmented.csv")}}
    cfg = _config(art, tmp_path / "out", "pgd", scaler="scaler.npz", budget=5, eps=4.0, nb_random=0,
                  loss_evaluation="autopgd+constraints+flip", project_name="botnet_augmented")
    cfg["paths"]["important_features"] = str(tmp_path / "important_features_19.npy")
    calls = []

    def pgd_botnet(*args, **kw):
        calls.append((args, kw))
        raise _Reached

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True), raising=False)
    monkeypatch.setattr(kernels, "forward_labels", lambda x, params, widths: torch.zeros(len(x), dtype=torch.int64))
    monkeypatch.setattr(kernels, "pgd_botnet", pgd_botnet)
    common.ENGINES.clear()
    with pytest.raises(_Reached):
        ppgd.run(cfg, device="cpu")
    common.ENGINES.clear()
    (args, kw), = calls
    tables, x_init = args[0], args[2]
    assert tuple(x_init.shape) == (8, 927) and kw["auto"] is not None
    assert tables.cons.pair_idx.shape == (171, 2) and tables.cons.pair_thr.dtype == torch.float32
    assert not [f for f in os.listdir(tmp_path / "out") if f.startswith(("metrics_", "x_attacks_"))]


@pytest.mark.parametrize("base", ["moeva", "pgd"])
def test_run_without_device_needs_the_card(artifacts, tmp_path, base):
    if torch.cuda.is_available():
        pytest.skip("a card is present: run(config) runs on it")
    extra = {"eps": 0.2, "loss_evaluation": "flip"} if base == "pgd" else {"eps_list": [0.2]}
    cfg = _config(artifacts, tmp_path / "out", base, budget=5, **extra)
    runner = pmoeva if base == "moeva" else ppgd
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.run(cfg)
    assert not (tmp_path / "out").exists()
