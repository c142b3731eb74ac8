"""Defense pipeline: augmentation + adversarial retraining artifact family.

Port of ``experiments/defense.py`` (parity with the reference's
``01_train_robust.py``): the staged, artifact-memoized workflow that
produces every model and candidate artifact the attack experiments consume,
in the JAX module's order, with its artifact names, memoisation and prints:

1.  min-max scaler from the feature bounds ∪ data (floor/ceil envelope)
2.  base surrogate ``nn`` + AUROC
3.  top-k important mutable features: gradient×input attribution on a
    class-balanced subsample, the gradient on kernel K12
4.  XOR-augmented dataset + ``features_augmented.csv`` /
    ``constraints_augmented.csv``
5.  augmented scaler + augmented surrogate ``nn_augmented``
6.  adversarial candidates (label 1, correctly classified, feasible)
7.  MoEvA on the train candidates → best successful adversarial per state
    → ``nn_moeva``
8.  targeted (LCLD) or untargeted (botnet) constrained PGD → ``nn_gradient``
    (LCLD only)
9.  the common candidate set ``x_candidates_common[_augmented].npy``

Every training step runs on kernel K11 (``models.train``), the attacks on
the kernels of ``Moeva2`` (K1-K6, K8) and ``ConstrainedPGD`` (K7, K7b);
``proba1`` is the surrogate's forward on the run's device in float64, as
the JAX package's runs under x64. Without a card, ``device="cuda"`` (the
default) raises; ``device="cpu"`` runs every stage's plain version.

One-GPU and no-sklearn decisions: the scalers are written as
``scaler.npz`` and ``scaler_augmented{suffix}.npz`` (``models.scalers.
save_npz``, with the fitted bounds, so the augmented scaler is fit from the
base scaler's ``data_min_``/``data_max_`` exactly as the JAX package fits
it), and a ``.joblib`` written by the JAX package is read where one exists
(it needs joblib and sklearn); the 10% validation split is
``models.train.train_test_split``, sklearn's stratified split reproduced
in numpy; the augmented CSVs are written with ``csv``; MoEvA and PGD take no
mesh padding.

Run from the command line (``-c`` config files, ``-j`` inline JSON,
``--device``, default the card; ``--dtype`` the training's float type)::

    python3 -m moeva2_ijcai22_replication_tpu_torch.experiments.defense -c config/defense.lcld.yaml
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from .. import resolve_device
from ..attacks.moeva import Moeva2
from ..attacks.objective import ObjectiveCalculator
from ..attacks.pgd import ConstrainedPGD, round_ints_toward_initial
from ..core.schema import FeatureSchema
from ..domains import augmentation
from ..models.io import Surrogate, load_classifier, save_classifier
from ..models.mlp import botnet_mlp, lcld_mlp, proba1_plain
from ..models.scalers import fit_minmax_sklearn, from_sklearn_minmax, load_npz, load_npz_bounds, save_npz
from ..models.train import (
    auroc, fit_mlp, flat_params, input_grad, mlp_widths, stack_tensors, train_dtype, train_test_split,
)
from ..utils.config import parse_run_args
from . import common

#: per-project pipeline knobs (reference: nb_important_features=5 at
#: lcld/01_train_robust.py:36 vs 19 at botnet/01_train_robust.py:36;
#: balanced subsample 5000/300 per class at :99 / :98; epochs/batch from the
#: model modules; the botnet reference trains no gradient-defended model and
#: skips the constraint filter on common candidates)
PROJECT_DEFAULTS = {
    "lcld": dict(
        model_fn=lcld_mlp, nb_important=5, balanced_n=5000, epochs=100,
        batch_size=512, augmented_suffix="", gradient_model=True,
        common_requires_constraints=True,
    ),
    "botnet": dict(
        model_fn=botnet_mlp, nb_important=19, balanced_n=300, epochs=3,
        batch_size=256, augmented_suffix="_19", gradient_model=False,
        common_requires_constraints=False,
    ),
}


def _memo_npy(path, fn):
    if os.path.exists(path):
        print(f"{path} exists loading...")
        return np.load(path)
    out = fn()
    np.save(path, out)
    return out


def _memo_model(path, fn) -> Surrogate:
    if os.path.exists(path):
        print(f"{path} exists loading...")
        return load_classifier(path)
    sur = fn()
    save_classifier(sur, path)  # format follows the path's suffix
    return sur


def _memo_scaler(npz_path: str, joblib_path: str, fit) -> tuple:
    """``(scaler, (data_min, data_max))``: the ``.npz`` where it exists;
    else a ``.joblib`` the JAX package wrote (read with joblib and sklearn),
    kept as the ``.npz``; else ``fit()``'s bounds through
    ``fit_minmax_sklearn``, written as the ``.npz``."""
    if os.path.exists(npz_path):
        return load_npz(npz_path), load_npz_bounds(npz_path)
    if os.path.exists(joblib_path):
        import joblib

        fitted = joblib.load(joblib_path)
        scaler = from_sklearn_minmax(fitted)
        bounds = (np.asarray(fitted.data_min_, np.float64), np.asarray(fitted.data_max_, np.float64))
    else:
        bounds = fit()
        scaler = fit_minmax_sklearn(*bounds)
    save_npz(scaler, npz_path, *bounds)
    return scaler, bounds


def make_trainer(model_fn, knobs: dict, seed: int, device="cuda", dtype=None):
    """Keras-fit-parity trainer: 10% stratified val split, ES patience 25
    (lcld/model.py:23-42) — shared by the defense and RQ4 pipelines."""

    def train(x_s, y) -> Surrogate:
        x_tr, x_val, y_tr, y_val = train_test_split(x_s, y, test_size=0.1, random_state=42)
        return fit_mlp(
            model_fn(x_s.shape[1]), x_tr, y_tr, x_val, y_val,
            epochs=knobs["epochs"], batch_size=knobs["batch_size"],
            patience=25, seed=seed, device=device, dtype=dtype,
        ).surrogate

    return train


def proba1(sur: Surrogate, scaler, x: np.ndarray, device="cpu") -> np.ndarray:
    """P(class=1) of the scaled rows, the forward in float64 on ``device``:
    kernel K16's float64 instantiation on the card, its plain version
    ``models.mlp.proba1_plain`` on the CPU."""
    widths, params, layers = stack_tensors(sur.model, torch.float64, torch.device(device))
    with torch.no_grad():
        xs = torch.as_tensor(np.asarray(scaler.transform(x), np.float64), device=params.device)
        if xs.is_cuda:
            from ..kernels import forward_proba1

            return forward_proba1(xs, params, widths).cpu().numpy()
        return proba1_plain(layers, xs).numpy()


def moeva_attack(model, constraints, ml_scaler, config, x_cand, device="cuda") -> np.ndarray:
    """MoEvA over internally-computed candidates (one card: no mesh
    padding)."""
    result = Moeva2(
        classifier=model, constraints=constraints, ml_scaler=ml_scaler,
        norm=config["norm"], n_gen=config["budget"],
        n_pop=config["n_pop"], n_offsprings=config["n_offsprings"],
        seed=config["seed"],
        max_states_per_call=config.get("max_states_per_call") or None,
        device=device,
    ).generate(x_cand, 1)
    return result.x_ml


def fit_envelope_scaler(schema: FeatureSchema, x_all: np.ndarray) -> tuple:
    """``(data_min, data_max)`` of sklearn's MinMaxScaler over the
    floor/ceil of feature bounds ∪ data (01_train_robust.py:55-65;
    'dynamic' bounds resolve to the data); ``models.scalers.
    fit_minmax_sklearn`` gives the scaler."""
    x_min = np.array(schema.raw_min, dtype=object)
    x_max = np.array(schema.raw_max, dtype=object)
    dyn_min = x_min == "dynamic"
    dyn_max = x_max == "dynamic"
    x_min[dyn_min] = x_all.min(0)[dyn_min]
    x_max[dyn_max] = x_all.max(0)[dyn_max]
    x_min = np.minimum(x_min.astype(float), x_all.min(0))
    x_max = np.maximum(x_max.astype(float), x_all.max(0))
    return np.floor(x_min), np.ceil(x_max)


def importance_gradient_x_input(
    surrogate: Surrogate,
    scaler,
    x: np.ndarray,
    y: np.ndarray,
    mutable_mask: np.ndarray,
    k: int,
    balanced_n: int,
    seed: int = 42,
    device="cuda",
    dtype=None,
) -> np.ndarray:
    """Top-k important mutable features as (k, 2) [index, train-mean].

    Reference: SHAP DeepExplainer values for class 0, mean |value| per
    feature, on a RandomUnderSampler({0: n, 1: n}) subsample
    (01_train_robust.py:98-115). Here, as in the JAX package:
    |gradient×(x - background mean)| of the class-0 probability over the
    same balanced subsample; the gradient is kernel K12 on the card (its
    plain version on the CPU, in :func:`..models.train.train_dtype`'s float
    type), the mean and the argsort host numpy.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    parts = []
    for cls in (0, 1):
        idx = np.flatnonzero(y == cls)
        take = min(balanced_n, len(idx))
        parts.append(rng.choice(idx, size=take, replace=False))
    sub = np.concatenate(parts)
    xs = np.asarray(scaler.transform(x[sub]))
    background = xs.mean(0)

    model = surrogate.model
    grads = input_grad(mlp_widths(model), flat_params(model).to(dev),
                       torch.as_tensor(xs, dtype=train_dtype(dev, dtype), device=dev))
    attr = np.mean(np.abs(grads.cpu().numpy() * (xs - background)), axis=0)

    mutable_idx = np.flatnonzero(mutable_mask)
    order = np.argsort(attr[mutable_mask])[::-1]
    top = mutable_idx[order][:k]
    return np.column_stack([top, x[:, top].mean(0)])


def _read_csv(path: str) -> tuple:
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return list(reader.fieldnames), [dict(r) for r in reader]


def _write_csv(path: str, table: tuple) -> None:
    fields, rows = table
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields, lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)


def augmented_schema_rows(schema: tuple, constraints: tuple, n_new: int) -> tuple:
    """Append the reference's augmented-feature rows to both CSV tables
    (``(fieldnames, rows)``; 01_train_robust.py:134-156), as the JAX
    package's pandas frames do: an ``augmentation`` column (False on the
    base rows where missing), ``augmented_i,int,True,0.0,1.0,True``
    features, constraint rows ``min 0.0, max 1.0, augmentation True`` with
    their other columns empty."""
    out = []
    for (fields, rows), new in (
        (schema, lambda i: {"feature": f"augmented_{i}", "type": "int", "mutable": "True",
                            "min": "0.0", "max": "1.0", "augmentation": "True"}),
        (constraints, lambda i: {"min": "0.0", "max": "1.0", "augmentation": "True"}),
    ):
        fields, rows = list(fields), [dict(r) for r in rows]
        if "augmentation" not in fields:
            fields.append("augmentation")
            for r in rows:
                r["augmentation"] = "False"
        rows += [{**dict.fromkeys(fields, ""), **new(i)} for i in range(n_new)]
        out.append((fields, rows))
    return tuple(out)


def run(config: dict, device="cuda", dtype=None) -> dict:
    """Execute the defense pipeline; returns the artifact-path map. The
    models train on ``device`` in ``dtype`` (:func:`..models.train.
    train_dtype`: float32 on the card, float64 on the CPU unless given)."""
    common.refuse_knobs(config, {})
    dev = resolve_device(device)
    dtype = train_dtype(dev, dtype)

    project = config["project_name"]
    knobs = dict(PROJECT_DEFAULTS[project.split("_")[0]])
    knobs.update(config.get("defense", {}))
    threshold = config["misclassification_threshold"]
    data_dir = config["dirs"]["data"]
    models_dir = config["dirs"]["models"]
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(models_dir, exist_ok=True)
    suffix = knobs["augmented_suffix"]

    # ----- LOAD (01_train_robust.py:41-46)
    x_train = np.load(config["paths"]["x_train"])
    x_test = np.load(config["paths"]["x_test"])
    y_train = np.load(config["paths"]["y_train"])
    y_test = np.load(config["paths"]["y_test"])
    schema = FeatureSchema.from_csv(config["paths"]["features"])
    train = make_trainer(knobs["model_fn"], knobs, config["seed"], dev, dtype)

    # ----- SCALER (:50-66)
    scaler_path = f"{models_dir}/scaler.npz"
    scaler, (data_min, data_max) = _memo_scaler(
        scaler_path, f"{models_dir}/scaler.joblib",
        lambda: fit_envelope_scaler(schema, np.concatenate([x_train, x_test])),
    )

    # ----- BASE MODEL + AUROC (:70-90)
    model = _memo_model(
        f"{models_dir}/nn.msgpack",
        lambda: train(scaler.transform(x_train), y_train),
    )
    y_proba = proba1(model, scaler, x_test, dev)
    y_pred = (y_proba >= threshold).astype(int)
    print(f"AUROC: {auroc(y_proba, y_test)}")

    # ----- IMPORTANT FEATURES (:94-116)
    important_features = _memo_npy(
        f"{data_dir}/important_features{suffix}.npy",
        lambda: importance_gradient_x_input(
            model, scaler, x_train, y_train, np.asarray(schema.mutable, dtype=bool),
            knobs["nb_important"], knobs["balanced_n"], device=dev, dtype=dtype,
        ),
    )

    # ----- AUGMENT DATASET (:120-160)
    feats_aug_path = f"{data_dir}/features_augmented{suffix}.csv"
    cons_aug_path = f"{data_dir}/constraints_augmented{suffix}.csv"
    x_train_augmented = _memo_npy(
        f"{data_dir}/x_train_augmented.npy",
        lambda: augmentation.augment(torch.as_tensor(x_train), important_features).numpy(),
    )
    x_test_augmented = _memo_npy(
        f"{data_dir}/x_test_augmented.npy",
        lambda: augmentation.augment(torch.as_tensor(x_test), important_features).numpy(),
    )
    n_new = x_train_augmented.shape[1] - x_train.shape[1]
    if not os.path.exists(feats_aug_path):
        feats_aug, cons_aug = augmented_schema_rows(
            _read_csv(config["paths"]["features"]), _read_csv(config["paths"]["constraints"]), n_new
        )
        _write_csv(feats_aug_path, feats_aug)
        _write_csv(cons_aug_path, cons_aug)

    # ----- AUGMENTED SCALER (:164-179): fit from the base scaler's bounds
    scaler_aug_path = f"{models_dir}/scaler_augmented{suffix}.npz"
    scaler_augmented, _ = _memo_scaler(
        scaler_aug_path, f"{models_dir}/scaler_augmented{suffix}.joblib",
        lambda: (np.concatenate([data_min, np.zeros(n_new)]), np.concatenate([data_max, np.ones(n_new)])),
    )

    # ----- AUGMENTED MODEL (:183-205)
    model_augmented = _memo_model(
        f"{models_dir}/nn_augmented{suffix}.msgpack",
        lambda: train(scaler_augmented.transform(x_train_augmented), y_train),
    )
    p_augmented = proba1(model_augmented, scaler_augmented, x_test_augmented, dev)
    y_pred_augmented = (p_augmented >= threshold).astype(int)
    print(f"AUROC: {auroc(p_augmented, y_test)}")

    # ----- ADVERSARIAL CANDIDATES (:208-224)
    constraints = common.load_constraints(config)
    correct = (proba1(model, scaler, x_train, dev) >= threshold).astype(int) == y_train
    cand_mask = (y_train == 1) & correct
    x_cand = x_train[cand_mask]
    satisfied = _violations(constraints, x_cand).max(-1) <= 0
    x_cand = x_cand[satisfied]
    print(f"{x_cand.shape} candidates.")

    ml_scaler = scaler
    calc = ObjectiveCalculator(
        classifier=model,
        constraints=constraints,
        thresholds={"f1": threshold, "f2": config["eps"]},
        min_max_scaler=ml_scaler,
        ml_scaler=ml_scaler,
        minimize_class=1,
        norm=config["norm"],
    )

    # ----- MOEVA ADVERSARIALS + RETRAINING (:230-293, :411-437)
    x_train_moeva = _memo_npy(
        f"{data_dir}/x_train_moeva.npy",
        lambda: moeva_attack(model, constraints, ml_scaler, config, x_cand, dev),
    )
    adv_moeva_path = f"{data_dir}/x_train_adv_moeva.npy"
    adv_moeva_index_path = f"{data_dir}/x_train_adv_moeva_index.npy"
    if os.path.exists(adv_moeva_path):
        x_adv_moeva = np.load(adv_moeva_path)
        adv_moeva_index = np.load(adv_moeva_index_path)
    else:
        x_adv_moeva, adv_moeva_index = calc.get_successful_attacks(
            x_cand, x_train_moeva, preferred_metrics="misclassification",
            order="asc", max_inputs=1, return_index_success=True,
        )
        print(f"Success rate: {x_adv_moeva.shape[0] / x_train_moeva.shape[0]}")
        np.save(adv_moeva_path, x_adv_moeva)
        np.save(adv_moeva_index_path, adv_moeva_index)

    # ----- GRADIENT ADVERSARIALS (:297-397)
    adv_grad_path = f"{data_dir}/x_train_adv_gradient.npy"
    adv_grad_index_path = f"{data_dir}/x_train_adv_gradient_index.npy"
    if os.path.exists(adv_grad_path):
        x_adv_gradient = np.load(adv_grad_path)
        adv_gradient_index = np.load(adv_grad_index_path)
    else:
        pgd = ConstrainedPGD(
            classifier=model, constraints=constraints, scaler=ml_scaler,
            eps=config["eps"] - 0.000001, eps_step=0.1,
            max_iter=int(config["budget"]), norm=config["norm"],
            loss_evaluation=config.get("loss_evaluation", "flip"),
            constraints_optim=config.get("constraints_optim", "sum"),
            # LCLD attacks toward class 0 (targeted y=[1,0] one-hots,
            # :358-364); botnet runs the untargeted variant (:361-366).
            targeted=knobs["gradient_model"],
            seed=config["seed"],
            device=dev,
        )
        y_att = np.zeros(x_cand.shape[0], dtype=np.int64)
        x_att = np.asarray(ml_scaler.inverse(pgd.generate(ml_scaler.transform(np.asarray(x_cand)), y_att)))
        x_att = round_ints_toward_initial(x_att, x_cand, constraints.get_feature_type())
        x_adv_gradient, adv_gradient_index = calc.get_successful_attacks(
            x_cand, x_att[:, None, :], preferred_metrics="misclassification",
            order="asc", max_inputs=1, return_index_success=True,
        )
        print(f"Success rate: {x_adv_gradient.shape[0] / x_att.shape[0]}")
        np.save(adv_grad_path, x_adv_gradient)
        np.save(adv_grad_index_path, adv_gradient_index)

    # ----- COMMON SUCCESS MASKS (:401-409) — LCLD only: the LCLD reference
    # retrains each model on adversarials whose initial state BOTH attacks
    # defeated; the botnet reference retrains on all MoEvA successes
    # (botnet/01_train_robust.py:275).
    if knobs["gradient_model"]:
        both = adv_moeva_index & adv_gradient_index
        if not both.any():
            # The gradient attack can come back empty (constrained PGD
            # rarely beats LCLD validity): the strict intersection would
            # retrain on zero adversarials and ship base weights as the
            # defended models. Fall back to the botnet reference's semantics
            # for nn_moeva (every MoEvA success); nn_gradient keeps the
            # intersection's and retrains on zero adversarials, as the JAX
            # package's does.
            print(
                "WARNING: both-attacks intersection is empty; retraining "
                "nn_moeva on all MoEvA successes (botnet semantics)"
            )
            moeva_mask = np.ones(len(x_adv_moeva), dtype=bool)
            gradient_mask = np.zeros(len(x_adv_gradient), dtype=bool)
        else:
            moeva_mask = both[adv_moeva_index]
            gradient_mask = both[adv_gradient_index]
    else:
        moeva_mask = np.ones(len(x_adv_moeva), dtype=bool)
        gradient_mask = np.ones(len(x_adv_gradient), dtype=bool)

    # ----- ADVERSARIAL RETRAINING (:411-466)
    model_moeva = _memo_model(
        f"{models_dir}/nn_moeva.msgpack",
        lambda: train(
            scaler.transform(np.concatenate([x_train, x_adv_moeva[moeva_mask]])),
            np.concatenate([y_train, np.ones(moeva_mask.sum(), dtype=y_train.dtype)]),
        ),
    )
    p_adv_moeva = proba1(model_moeva, scaler, x_test, dev)
    y_pred_adv_moeva = (p_adv_moeva >= threshold).astype(int)
    print(f"AUROC: {auroc(p_adv_moeva, y_test)}")

    y_pred_adv_gradient = None
    if knobs["gradient_model"]:
        model_gradient = _memo_model(
            f"{models_dir}/nn_gradient.msgpack",
            lambda: train(
                scaler.transform(np.concatenate([x_train, x_adv_gradient[gradient_mask]])),
                np.concatenate([y_train, np.ones(gradient_mask.sum(), dtype=y_train.dtype)]),
            ),
        )
        p_adv_gradient = proba1(model_gradient, scaler, x_test, dev)
        y_pred_adv_gradient = (p_adv_gradient >= threshold).astype(int)
        print(f"AUROC: {auroc(p_adv_gradient, y_test)}")

    # ----- COMMON CANDIDATE SET (:468-491)
    cand_path = f"{data_dir}/x_candidates_common.npy"
    cand_aug_path = f"{data_dir}/x_candidates_common_augmented.npy"
    if not (os.path.exists(cand_path) and os.path.exists(cand_aug_path)):
        index = (
            (y_test == 1)
            & (y_test == y_pred)
            & (y_test == y_pred_augmented)
            & (y_test == y_pred_adv_moeva)
        )
        if knobs["common_requires_constraints"]:
            index &= _violations(constraints, x_test).max(-1) <= 0
        if y_pred_adv_gradient is not None:
            index &= y_pred == y_pred_adv_gradient
        np.save(cand_path, x_test[index])
        np.save(cand_aug_path, x_test_augmented[index])
    x_candidates = np.load(cand_path)
    print(f"Candidates: {x_candidates.shape}.")

    return {
        "scaler": scaler_path,
        "scaler_augmented": scaler_aug_path,
        "nn": f"{models_dir}/nn.msgpack",
        "nn_augmented": f"{models_dir}/nn_augmented{suffix}.msgpack",
        "nn_moeva": f"{models_dir}/nn_moeva.msgpack",
        "nn_gradient": (
            f"{models_dir}/nn_gradient.msgpack" if knobs["gradient_model"] else None
        ),
        "important_features": f"{data_dir}/important_features{suffix}.npy",
        "x_candidates_common": cand_path,
        "x_candidates_common_augmented": cand_aug_path,
    }


def _violations(constraints, x: np.ndarray) -> np.ndarray:
    """The hard-thresholded violations of rows ``x``, float64 on the CPU."""
    return constraints.evaluate(torch.as_tensor(np.asarray(x, np.float64))).numpy()


if __name__ == "__main__":
    _config, _args = parse_run_args()
    run(_config, **_args)
