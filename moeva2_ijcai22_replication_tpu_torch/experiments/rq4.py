"""RQ4 defense iteration: retrain on the *best* adversarials.

Port of ``experiments/rq4.py`` (parity with the reference's
``03_train_robust_rq4.py``): consumes the :mod:`.defense` artifact family
(scalers, nn, nn_augmented, important features, augmented data,
x_train_moeva, common candidates; raises FileNotFoundError when one is
missing, like the reference) and produces:

- ``nn_moeva_best``: retrained on the best successful adversarial per state
  under the *relaxed* misclassification threshold f1=1.0 (:164-186);
- a MoEvA attack on the augmented model under augmented constraints (on the
  card K1's ``kPairs`` instantiation, or K8's ``kXorTerms``) →
  ``nn_augmented_moeva_best`` (:237-328);
- the RQ4 candidate sets: common candidates still classified correctly by
  both "best" models (:331-343).

The scalers are the defense pipeline's ``.npz`` files, or the JAX
package's ``.joblib`` ones where only those exist (read with joblib and
sklearn). Training runs on kernel K11 as in :mod:`.defense`; ``device``
and ``dtype`` are :func:`.defense.run`'s.

Run from the command line as :mod:`.defense`::

    python3 -m moeva2_ijcai22_replication_tpu_torch.experiments.rq4 -c config/defense.lcld.yaml
"""

from __future__ import annotations

import os

import numpy as np

from .. import resolve_device
from ..attacks.objective import ObjectiveCalculator
from ..domains import get_constraints_class
from ..models.io import load_classifier
from ..models.scalers import load_joblib_scaler, load_npz
from ..models.train import auroc, train_dtype
from ..utils.config import parse_run_args
from . import common
from .defense import PROJECT_DEFAULTS, _memo_model, _memo_npy, _violations, make_trainer, moeva_attack, proba1


def _require(path: str) -> str:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} missing — run the defense pipeline (experiments.defense) first"
        )
    return path


def _require_scaler(stem: str):
    """The scaler ``{stem}.npz``, or ``{stem}.joblib`` where only that
    exists; FileNotFoundError naming the ``.npz`` when neither does."""
    if not os.path.exists(f"{stem}.npz") and os.path.exists(f"{stem}.joblib"):
        return load_joblib_scaler(f"{stem}.joblib")
    return load_npz(_require(f"{stem}.npz"))


def run(config: dict, device="cuda", dtype=None) -> dict:
    common.refuse_knobs(config, {})
    dev = resolve_device(device)
    dtype = train_dtype(dev, dtype)
    project = config["project_name"]
    knobs = dict(PROJECT_DEFAULTS[project.split("_")[0]])
    knobs.update(config.get("defense", {}))
    threshold = config["misclassification_threshold"]
    data_dir = config["dirs"]["data"]
    models_dir = config["dirs"]["models"]
    suffix = knobs["augmented_suffix"]

    # ----- LOAD (03_train_robust_rq4.py:41-120 — all load-or-raise)
    x_train = np.load(config["paths"]["x_train"])
    x_test = np.load(config["paths"]["x_test"])
    y_train = np.load(config["paths"]["y_train"])
    y_test = np.load(config["paths"]["y_test"])
    scaler = _require_scaler(f"{models_dir}/scaler")
    scaler_augmented = _require_scaler(f"{models_dir}/scaler_augmented{suffix}")
    model = load_classifier(_require(f"{models_dir}/nn.msgpack"))
    model_augmented = load_classifier(
        _require(f"{models_dir}/nn_augmented{suffix}.msgpack")
    )
    x_train_augmented = np.load(_require(f"{data_dir}/x_train_augmented.npy"))
    x_test_augmented = np.load(_require(f"{data_dir}/x_test_augmented.npy"))
    x_train_moeva = np.load(_require(f"{data_dir}/x_train_moeva.npy"))
    train = make_trainer(knobs["model_fn"], knobs, config["seed"], dev, dtype)

    # ----- CANDIDATES (same filter as the defense pipeline, :123-139)
    constraints = common.load_constraints(config)
    cand_mask = (y_train == 1) & (
        (proba1(model, scaler, x_train, dev) >= threshold).astype(int) == y_train
    )
    x_cand = x_train[cand_mask]
    x_cand = x_cand[_violations(constraints, x_cand).max(-1) <= 0]

    ml_scaler = scaler

    # ----- BEST MOEVA ADVERSARIALS: f1 threshold 1.0 (:164-186)
    best_path = f"{data_dir}/x_train_best_moeva.npy"
    if os.path.exists(best_path):
        x_best = np.load(best_path)
    else:
        calc = ObjectiveCalculator(
            classifier=model,
            constraints=constraints,
            thresholds={"f1": 1.0, "f2": config["eps"]},
            min_max_scaler=ml_scaler,
            ml_scaler=ml_scaler,
            minimize_class=1,
            norm=config["norm"],
        )
        x_best, idx = calc.get_successful_attacks(
            x_cand, x_train_moeva, preferred_metrics="misclassification",
            order="asc", max_inputs=1, return_index_success=True,
        )
        np.save(f"{data_dir}/x_train_best_moeva_index.npy", idx)
        np.save(best_path, x_best)

    # ----- nn_moeva_best (:191-216)
    model_best = _memo_model(
        f"{models_dir}/nn_moeva_best.msgpack",
        lambda: train(
            scaler.transform(np.concatenate([x_train, x_best])),
            np.concatenate([y_train, np.ones(len(x_best), dtype=y_train.dtype)]),
        ),
    )
    print(f"AUROC: {auroc(proba1(model_best, scaler, x_test, dev), y_test)}")

    # ----- AUGMENTED ATTACK (:218-266)
    aug_constraints = get_constraints_class(f"{project}_augmented")(
        config["paths"]["features_augmented"],
        config["paths"]["constraints_augmented"],
        important_features_path=f"{data_dir}/important_features{suffix}.npy",
    )
    aug_cand_mask = (y_train == 1) & (
        (proba1(model_augmented, scaler_augmented, x_train_augmented, dev) >= threshold)
        .astype(int)
        == y_train
    )
    x_aug_cand = x_train_augmented[aug_cand_mask]
    x_aug_cand = x_aug_cand[_violations(aug_constraints, x_aug_cand).max(-1) <= 0]
    ml_scaler_aug = scaler_augmented

    x_aug_moeva = _memo_npy(
        f"{data_dir}/x_train_augmented_moeva.npy",
        lambda: moeva_attack(
            model_augmented, aug_constraints, ml_scaler_aug, config, x_aug_cand, dev
        ),
    )

    # ----- BEST AUGMENTED ADVERSARIALS (:269-298; threshold back to config)
    aug_best_path = f"{data_dir}/x_train_augmented_best_moeva.npy"
    if os.path.exists(aug_best_path):
        x_aug_best = np.load(aug_best_path)
    else:
        calc = ObjectiveCalculator(
            classifier=model_augmented,
            constraints=aug_constraints,
            thresholds={"f1": threshold, "f2": config["eps"]},
            min_max_scaler=ml_scaler_aug,
            ml_scaler=ml_scaler_aug,
            minimize_class=1,
            norm=config["norm"],
        )
        x_aug_best, idx = calc.get_successful_attacks(
            x_aug_cand, x_aug_moeva, preferred_metrics="misclassification",
            order="asc", max_inputs=1, return_index_success=True,
        )
        np.save(f"{data_dir}/x_train_augmented_best_moeva_index.npy", idx)
        np.save(aug_best_path, x_aug_best)

    # ----- nn_augmented_moeva_best (:303-328)
    model_aug_best = _memo_model(
        f"{models_dir}/nn_augmented_moeva_best.msgpack",
        lambda: train(
            scaler_augmented.transform(
                np.concatenate([x_train_augmented, x_aug_best])
            ),
            np.concatenate(
                [y_train, np.ones(len(x_aug_best), dtype=y_train.dtype)]
            ),
        ),
    )
    print(f"AUROC: {auroc(proba1(model_aug_best, scaler_augmented, x_test_augmented, dev), y_test)}")

    # ----- RQ4 CANDIDATE SETS (:331-343)
    x_common = np.load(_require(f"{data_dir}/x_candidates_common.npy"))
    x_common_aug = np.load(
        _require(f"{data_dir}/x_candidates_common_augmented.npy")
    )
    still_ok = (proba1(model_best, scaler, x_common, dev) >= threshold).astype(int)
    print(f"Still ok rate: {still_ok.sum() / len(x_common)}")
    still_ok_aug = (
        proba1(model_aug_best, scaler_augmented, x_common_aug, dev) >= threshold
    ).astype(int)
    print(f"Still ok rate: {still_ok_aug.sum() / len(x_common_aug)}")
    final = (still_ok * still_ok_aug) == 1
    rq4_path = f"{data_dir}/x_candidates_rq4_best.npy"
    rq4_aug_path = f"{data_dir}/x_candidates_rq4_augmented_best.npy"
    np.save(rq4_path, x_common[final])
    np.save(rq4_aug_path, x_common_aug[final])
    print(f"{int(final.sum())}")

    return {
        "nn_moeva_best": f"{models_dir}/nn_moeva_best.msgpack",
        "nn_augmented_moeva_best": f"{models_dir}/nn_augmented_moeva_best.msgpack",
        "x_candidates_rq4_best": rq4_path,
        "x_candidates_rq4_augmented_best": rq4_aug_path,
    }


if __name__ == "__main__":
    _config, _args = parse_run_args()
    run(_config, **_args)
