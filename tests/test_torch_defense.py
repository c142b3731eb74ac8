"""The port's defense and RQ4 pipelines against the JAX package's, on the CPU.

``tests/test_defense.py``'s small LCLD setup (384 ``synth_lcld`` rows at
seed 11, a learnable label, 4 epochs, MoEvA at budget 3), on the port's
synthetic schema (``synth_lcld_schema``: the reference's data is not
shipped). The JAX pipelines run first; the port's then run with the JAX
run's attack artifacts (``x_train_moeva.npy``, ``x_train_adv_*.npy``,
``x_train_augmented_moeva.npy``) pre-seeded, so both train on the same
rows, and with the JAX package's flax init fed through the trainer
(random draws are inputs). They must write the same artifact family (the
port's scalers as ``.npz``), the same important features and candidate
sets row for row, models within ``test_torch_train.py``'s 20-step
tolerance (1e-5 of max(|p|, lr)) and scalers equal to sklearn's bit for
bit. A free run of the port (its own attacks and init) is held to the
properties ``tests/test_defense.py`` checks, memoisation included.

The JAX runs patch their ``ObjectiveCalculator`` to ``precise=False``, test
side only, as ``tests/test_torch_runners.py`` does: its ``precise=True``
path imports ``jax.experimental.enable_x64``, which this jax lacks; under
the tests' x64 the judgement is float64 all the same.
"""

from __future__ import annotations

import copy
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.attacks.objective import ObjectiveCalculator as JObjective
from moeva2_ijcai22_replication_tpu.domains import get_constraints_class as jget_class
from moeva2_ijcai22_replication_tpu.experiments import defense as jdefense
from moeva2_ijcai22_replication_tpu.experiments import rq4 as jrq4
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu_torch.domains import get_constraints_class
from moeva2_ijcai22_replication_tpu_torch.domains.lcld import LcldConstraints
from moeva2_ijcai22_replication_tpu_torch.domains.synth import synth_lcld, synth_lcld_schema
from moeva2_ijcai22_replication_tpu_torch.experiments import common
from moeva2_ijcai22_replication_tpu_torch.experiments import defense, rq4
from moeva2_ijcai22_replication_tpu_torch.models import io as pio
from moeva2_ijcai22_replication_tpu_torch.models.scalers import load_npz
from moeva2_ijcai22_replication_tpu_torch.models.train import flat_params

torch.set_num_threads(1)

MODEL_TOL = 1e-5  # of max(|p|, lr): test_torch_train.py's 20-step tolerance
LR = 1e-3
SEEDED = ("x_train_moeva.npy", "x_train_adv_moeva.npy", "x_train_adv_moeva_index.npy",
          "x_train_adv_gradient.npy", "x_train_adv_gradient_index.npy", "x_train_augmented_moeva.npy")


def _config(tmp, paths, sub: str) -> dict:
    return {
        "project_name": "lcld",
        "paths": {
            "features": paths["features"],
            "constraints": paths["constraints"],
            "x_train": str(tmp / "x_train.npy"),
            "x_test": str(tmp / "x_test.npy"),
            "y_train": str(tmp / "y_train.npy"),
            "y_test": str(tmp / "y_test.npy"),
            "features_augmented": str(tmp / sub / "data" / "features_augmented.csv"),
            "constraints_augmented": str(tmp / sub / "data" / "constraints_augmented.csv"),
        },
        "dirs": {"data": str(tmp / sub / "data"), "models": str(tmp / sub / "models")},
        "misclassification_threshold": 0.5,
        "norm": 2,
        "eps": 0.5,
        "seed": 42,
        "budget": 3,
        "n_pop": 8,
        "n_offsprings": 4,
        "system": {"n_jobs": 1, "verbose": 0},
        "defense": {"epochs": 4, "balanced_n": 64},
    }


def _jax_init(d: int):
    return jax.tree.map(np.asarray, jmlp.lcld_mlp().init(jax.random.PRNGKey(42), jnp.zeros((1, d))))


def fit_from(init, fit):
    """``fit`` (``models.train.fit_mlp``) started from ``init(n_features)``,
    the JAX package's flax init: random draws are inputs."""

    def fit_mlp(model, *args, **kwargs):
        return fit(model, *args, init_params=init(model.layers[0].in_features), **kwargs)

    return fit_mlp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("defense")
    paths = synth_lcld_schema(str(tmp))
    cons = LcldConstraints(paths["features"], paths["constraints"])
    x_all = synth_lcld(384, cons.schema, seed=11)
    # learnable synthetic target: high interest rate => charged off
    y_all = (x_all[:, 2] > np.median(x_all[:, 2])).astype(np.int64)
    for name, arr in [("x_train", x_all[:256]), ("x_test", x_all[256:]),
                      ("y_train", y_all[:256]), ("y_test", y_all[256:])]:
        np.save(tmp / f"{name}.npy", arr)

    precise_off = functools.partial(JObjective, precise=False)
    saved = (jdefense.ObjectiveCalculator, jrq4.ObjectiveCalculator)
    jdefense.ObjectiveCalculator = jrq4.ObjectiveCalculator = precise_off
    try:
        jax_cfg = _config(tmp, paths, "jax")
        jax_art = jdefense.run(copy.deepcopy(jax_cfg))
        jax_rq4 = jrq4.run(copy.deepcopy(jax_cfg))
    finally:
        jdefense.ObjectiveCalculator, jrq4.ObjectiveCalculator = saved

    common.ARTIFACTS.clear()
    port_cfg = _config(tmp, paths, "port")
    os.makedirs(tmp / "port" / "data")
    for name in SEEDED:
        shutil.copy(tmp / "jax" / "data" / name, tmp / "port" / "data" / name)
    saved = defense.fit_mlp
    defense.fit_mlp = fit_from(_jax_init, saved)  # the trainer of both pipelines
    try:
        port_art = defense.run(copy.deepcopy(port_cfg), device="cpu")
        port_rq4 = rq4.run(copy.deepcopy(port_cfg), device="cpu")
    finally:
        defense.fit_mlp = saved

    free_cfg = _config(tmp, paths, "free")
    free_art = defense.run(copy.deepcopy(free_cfg), device="cpu")
    return dict(tmp=tmp, paths=paths, cons=cons, jax=jax_art, jax_rq4=jax_rq4, port=port_art, port_rq4=port_rq4,
                free=free_art, free_cfg=free_cfg, x_test=x_all[256:])


def test_same_artifact_family_as_jax(runs):
    tmp = runs["tmp"]
    assert sorted(os.listdir(tmp / "port" / "data")) == sorted(os.listdir(tmp / "jax" / "data"))
    jax_models = sorted(f.replace(".joblib", ".npz") for f in os.listdir(tmp / "jax" / "models"))
    assert sorted(os.listdir(tmp / "port" / "models")) == jax_models
    port = dict(runs["port"])
    assert port.pop("scaler_augmented").endswith("scaler_augmented.npz")
    assert port.pop("scaler").endswith("scaler.npz") and runs["jax"]["scaler"].endswith("scaler.joblib")
    jax_art = {k: v for k, v in runs["jax"].items() if k != "scaler"}
    assert {k: None if v is None else os.path.basename(v) for k, v in port.items()} == \
        {k: None if v is None else os.path.basename(v) for k, v in jax_art.items()}
    assert {k: os.path.basename(v) for k, v in runs["port_rq4"].items()} == \
        {k: os.path.basename(v) for k, v in runs["jax_rq4"].items()}


@pytest.mark.parametrize("key", ["important_features", "x_candidates_common", "x_candidates_common_augmented"])
def test_defense_outputs_equal_jax(runs, key):
    want, got = np.load(runs["jax"][key]), np.load(runs["port"][key])
    assert got.shape[0] >= 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["x_train_augmented.npy", "x_test_augmented.npy", "x_train_best_moeva.npy",
                                  "x_train_augmented_best_moeva.npy"])
def test_intermediate_arrays_equal_jax(runs, name):
    tmp = runs["tmp"]
    np.testing.assert_array_equal(np.load(tmp / "port" / "data" / name), np.load(tmp / "jax" / "data" / name))


@pytest.mark.parametrize("key", ["x_candidates_rq4_best", "x_candidates_rq4_augmented_best"])
def test_rq4_candidates_equal_jax(runs, key):
    np.testing.assert_array_equal(np.load(runs["port_rq4"][key]), np.load(runs["jax_rq4"][key]))


@pytest.mark.parametrize("key", ["nn", "nn_augmented", "nn_moeva", "nn_gradient", "nn_moeva_best",
                                 "nn_augmented_moeva_best"])
def test_models_within_the_train_tolerance(runs, key):
    jpath = {**runs["jax"], **runs["jax_rq4"]}[key]
    ppath = {**runs["port"], **runs["port_rq4"]}[key]
    want = pio.flat_from_tree(jax.tree.map(np.asarray, jio.load_classifier(jpath).params)).numpy()
    got = flat_params(pio.load_classifier(ppath).model).numpy()
    assert (np.abs(got - want) <= MODEL_TOL * np.maximum(np.abs(want), LR)).all()


@pytest.mark.parametrize("name", ["scaler", "scaler_augmented"])
def test_scalers_equal_sklearn_bit_for_bit(runs, name):
    import joblib

    tmp = runs["tmp"]
    want = joblib.load(tmp / "jax" / "models" / f"{name}.joblib")
    got = load_npz(str(tmp / "port" / "models" / f"{name}.npz"))
    for a, b in ((got.scale, want.scale_), (got.min_, want.min_)):
        np.testing.assert_array_equal(np.asarray(a).view(np.int64), np.asarray(b, np.float64).view(np.int64))


def test_augmented_csvs_give_the_jax_schema(runs):
    """The port's augmented CSVs load through both packages' ``lcld_augmented``
    classes with the schema the JAX package's CSVs give."""
    tmp = runs["tmp"]
    imp = runs["port"]["important_features"]
    schemas = []
    for sub in ("jax", "port"):
        files = (str(tmp / sub / "data" / "features_augmented.csv"), str(tmp / sub / "data" / "constraints_augmented.csv"))
        for cls in (jget_class("lcld_augmented"), get_constraints_class("lcld_augmented")):
            aug = cls(*files, important_features_path=imp)
            s = aug.schema
            schemas.append((tuple(s.names), tuple(s.types), tuple(s.mutable), tuple(map(str, s.raw_min)),
                            tuple(map(str, s.raw_max)), tuple(s.augmentation), aug.n_constraints))
    assert all(s == schemas[0] for s in schemas)
    assert len(schemas[0][0]) == 47 + 10


def test_free_run_properties(runs):
    """The port's own run: every artifact, 5 important mutable features, the
    augmented CSVs loadable, and common candidates feasible and classified
    as label 1 by every defended model (``tests/test_defense.py``)."""
    a, cons = runs["free"], runs["cons"]
    for key in ("scaler", "scaler_augmented", "nn", "nn_augmented", "nn_moeva", "nn_gradient",
                "important_features", "x_candidates_common", "x_candidates_common_augmented"):
        assert a[key] and os.path.exists(a[key]), key
    imp = np.load(a["important_features"])
    assert imp.shape == (5, 2)
    assert set(imp[:, 0].astype(int)) <= set(np.flatnonzero(cons.get_mutable_mask()).tolist())
    data = os.path.dirname(a["important_features"])
    aug = get_constraints_class("lcld_augmented")(f"{data}/features_augmented.csv",
                                                  f"{data}/constraints_augmented.csv")
    assert aug.schema.n_features == 57
    aug.check_constraints_error(np.load(f"{data}/x_test_augmented.npy"))
    x_cand = np.load(a["x_candidates_common"])
    assert x_cand.shape[0] >= 1
    cons.check_constraints_error(x_cand)
    scaler = load_npz(a["scaler"])
    for key in ("nn", "nn_moeva", "nn_gradient"):
        assert (defense.proba1(pio.load_classifier(a[key]), scaler, x_cand) >= 0.5).all(), key


def test_free_run_memoizes_and_rq4_runs(runs, capsys):
    cfg = runs["free_cfg"]
    assert defense.run(copy.deepcopy(cfg), device="cpu") == runs["free"]
    assert "exists loading..." in capsys.readouterr().out
    art = rq4.run(copy.deepcopy(cfg), device="cpu")
    x_rq4, x_rq4_aug = np.load(art["x_candidates_rq4_best"]), np.load(art["x_candidates_rq4_augmented_best"])
    assert x_rq4.shape[1] == 47 and x_rq4_aug.shape[1] == 57 and len(x_rq4) == len(x_rq4_aug)
    common_rows = {tuple(r) for r in np.load(runs["free"]["x_candidates_common"])}
    assert all(tuple(r) in common_rows for r in x_rq4)


def test_rq4_requires_defense_artifacts(runs, tmp_path):
    cfg = copy.deepcopy(runs["free_cfg"])
    cfg["dirs"] = {"data": str(tmp_path), "models": str(tmp_path)}
    with pytest.raises(FileNotFoundError, match="scaler.npz"):
        rq4.run(cfg, device="cpu")


@pytest.mark.parametrize("runner", ["defense", "rq4"])
def test_pipelines_refuse_the_cpu_without_asking(runs, runner, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    cfg = copy.deepcopy(runs["free_cfg"])
    cfg["dirs"] = {"data": str(tmp_path / "d"), "models": str(tmp_path / "m")}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        (defense if runner == "defense" else rq4).run(cfg)
    assert not os.path.exists(tmp_path / "d")
