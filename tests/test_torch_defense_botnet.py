"""The port's defense pipeline on botnet against the JAX package's, on the CPU.

``tests/test_defense.py``'s botnet setup (96 rows, a learnable label on the
highest-variance mutable column, 24 rows a class for the
importance, MoEvA at budget 3) on the port's synthetic botnet schema and
``synth_botnet`` rows (the reference's data is not shipped; 30 epochs, so that
the weak synthetic label is learnt and the common candidates are not
empty): the botnet
knobs (19 important features and the ``_19`` suffix, untargeted PGD, no
gradient-defended model, no constraint filter on the common candidates).
As in ``test_torch_defense.py``: the JAX run first (its
``ObjectiveCalculator`` patched to ``precise=False``, test side only), then
the port's with the JAX run's attack artifacts pre-seeded and the JAX
package's flax init fed through the trainer: the same artifact family,
important features and candidate sets, models within 1e-5 of max(|p|, lr).
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
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu_torch.domains import get_constraints_class
from moeva2_ijcai22_replication_tpu_torch.domains.botnet import BotnetConstraints
from moeva2_ijcai22_replication_tpu_torch.domains.synth import synth_botnet, synth_botnet_schema
from moeva2_ijcai22_replication_tpu_torch.experiments import common, defense
from moeva2_ijcai22_replication_tpu_torch.models import io as pio
from moeva2_ijcai22_replication_tpu_torch.models.scalers import load_npz
from moeva2_ijcai22_replication_tpu_torch.models.train import flat_params

torch.set_num_threads(1)

MODEL_TOL = 1e-5  # of max(|p|, lr): test_torch_train.py's 20-step tolerance
LR = 1e-3
SEEDED = ("x_train_moeva.npy", "x_train_adv_moeva.npy", "x_train_adv_moeva_index.npy",
          "x_train_adv_gradient.npy", "x_train_adv_gradient_index.npy")


def _config(tmp, paths, sub: str) -> dict:
    return {
        "project_name": "botnet",
        "paths": {
            "features": paths["features"],
            "constraints": paths["constraints"],
            "x_train": str(tmp / "x_train.npy"),
            "x_test": str(tmp / "x_test.npy"),
            "y_train": str(tmp / "y_train.npy"),
            "y_test": str(tmp / "y_test.npy"),
        },
        "dirs": {"data": str(tmp / sub / "data"), "models": str(tmp / sub / "models")},
        "misclassification_threshold": 0.5,
        "norm": 2,
        "eps": 4.0,
        "seed": 42,
        "budget": 3,
        "n_pop": 8,
        "n_offsprings": 4,
        "system": {"n_jobs": 1, "verbose": 0},
        "defense": {"epochs": 30, "balanced_n": 24},
    }


def fit_from(init, fit):
    """``fit`` (``models.train.fit_mlp``) started from ``init(n_features)``,
    the JAX package's flax init: random draws are inputs."""

    def fit_mlp(model, *args, **kwargs):
        return fit(model, *args, init_params=init(model.layers[0].in_features), **kwargs)

    return fit_mlp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("botnet_defense")
    paths = synth_botnet_schema(str(tmp))
    cons = BotnetConstraints(paths["features"], paths["constraints"])
    x_all = synth_botnet(96, cons.schema, seed=5)
    mut = np.flatnonzero(cons.get_mutable_mask())
    j = mut[np.argmax(x_all[:, mut].std(0))]
    y_all = (x_all[:, j] > np.median(x_all[:, j])).astype(np.int64)
    for name, arr in [("x_train", x_all[:64]), ("x_test", x_all[64:]),
                      ("y_train", y_all[:64]), ("y_test", y_all[64:])]:
        np.save(tmp / f"{name}.npy", arr)

    saved = jdefense.ObjectiveCalculator
    jdefense.ObjectiveCalculator = functools.partial(JObjective, precise=False)
    try:
        jax_art = jdefense.run(_config(tmp, paths, "jax"))
    finally:
        jdefense.ObjectiveCalculator = saved

    common.ARTIFACTS.clear()
    os.makedirs(tmp / "port" / "data")
    for name in SEEDED:
        shutil.copy(tmp / "jax" / "data" / name, tmp / "port" / "data" / name)
    init = lambda d: jax.tree.map(  # noqa: E731
        np.asarray, jmlp.botnet_mlp().init(jax.random.PRNGKey(42), jnp.zeros((1, d))))
    cfg = _config(tmp, paths, "port")
    saved = defense.fit_mlp
    defense.fit_mlp = fit_from(init, saved)
    try:
        port_art = defense.run(copy.deepcopy(cfg), device="cpu")
    finally:
        defense.fit_mlp = saved
    return dict(tmp=tmp, cfg=cfg, cons=cons, jax=jax_art, port=port_art)


def test_botnet_knobs_artifact_family(runs):
    a, tmp = runs["port"], runs["tmp"]
    assert a["important_features"].endswith("important_features_19.npy")
    assert a["nn_augmented"].endswith("nn_augmented_19.msgpack")
    assert a["scaler_augmented"].endswith("scaler_augmented_19.npz")
    assert a["nn_gradient"] is None and runs["jax"]["nn_gradient"] is None
    assert sorted(os.listdir(tmp / "port" / "data")) == sorted(os.listdir(tmp / "jax" / "data"))
    assert sorted(os.listdir(tmp / "port" / "models")) == \
        sorted(f.replace(".joblib", ".npz") for f in os.listdir(tmp / "jax" / "models"))


@pytest.mark.parametrize("key", ["important_features", "x_candidates_common", "x_candidates_common_augmented"])
def test_outputs_equal_jax(runs, key):
    got, want = np.load(runs["port"][key]), np.load(runs["jax"][key])
    assert got.shape[0] >= 1
    np.testing.assert_array_equal(got, want)


def test_widths(runs):
    assert np.load(runs["port"]["important_features"]).shape == (19, 2)
    assert np.load(runs["port"]["x_candidates_common_augmented"]).shape[1] == 756 + 171


@pytest.mark.parametrize("key", ["nn", "nn_augmented", "nn_moeva"])
def test_models_within_the_train_tolerance(runs, key):
    want = pio.flat_from_tree(jax.tree.map(np.asarray, jio.load_classifier(runs["jax"][key]).params)).numpy()
    got = flat_params(pio.load_classifier(runs["port"][key]).model).numpy()
    assert (np.abs(got - want) <= MODEL_TOL * np.maximum(np.abs(want), LR)).all()


@pytest.mark.parametrize("name", ["scaler", "scaler_augmented_19"])
def test_scalers_equal_sklearn_bit_for_bit(runs, name):
    import joblib

    tmp = runs["tmp"]
    want = joblib.load(tmp / "jax" / "models" / f"{name}.joblib")
    got = load_npz(str(tmp / "port" / "models" / f"{name}.npz"))
    for a, b in ((got.scale, want.scale_), (got.min_, want.min_)):
        np.testing.assert_array_equal(np.asarray(a).view(np.int64), np.asarray(b, np.float64).view(np.int64))


def test_augmented_csvs_give_the_jax_schema(runs):
    tmp = runs["tmp"]
    imp = runs["port"]["important_features"]
    schemas = []
    for sub in ("jax", "port"):
        # the botnet classes read feat_idx.pickle beside the features file, as
        # in the reference's data/botnet/, where the pipeline writes its CSVs
        shutil.copy(tmp / "feat_idx.pickle", tmp / sub / "data" / "feat_idx.pickle")
        files = (str(tmp / sub / "data" / "features_augmented_19.csv"),
                 str(tmp / sub / "data" / "constraints_augmented_19.csv"))
        for cls in (jget_class("botnet_augmented"), get_constraints_class("botnet_augmented")):
            aug = cls(*files, important_features_path=imp)
            s = aug.schema
            schemas.append((tuple(s.names), tuple(s.types), tuple(s.mutable), tuple(map(str, s.raw_min)),
                            tuple(map(str, s.raw_max)), tuple(s.augmentation), aug.n_constraints))
    assert all(s == schemas[0] for s in schemas)


def test_common_candidates_and_memoization(runs, capsys):
    """Correctly classified by every model; no constraint filter on botnet;
    a second run loads every artifact."""
    a = runs["port"]
    x_cand = np.load(a["x_candidates_common"])
    scaler = load_npz(a["scaler"])
    for key in ("nn", "nn_moeva"):
        assert (defense.proba1(pio.load_classifier(a[key]), scaler, x_cand) >= 0.5).all(), key
    assert defense.run(copy.deepcopy(runs["cfg"]), device="cpu") == a
    assert "exists loading..." in capsys.readouterr().out
