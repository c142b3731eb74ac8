"""Result and artifact IO, and the model artifacts' suffix dispatch.

Port of ``utils/in_out.py``: the json, npy and pickle helpers and
``load_model``, whose artifacts go to ``models.io.load_classifier``; a
``.joblib`` artifact (an sklearn model) gets :class:`HostClassifier`, the
host wrapper with the reference's 1-column probability expansion, joblib
imported only there. No attack takes a host classifier: the runners refuse
one (``experiments.common.load_surrogate``).
"""

from __future__ import annotations

import glob
import json
import os
import pickle

import numpy as np


# -- pickle ------------------------------------------------------------------
def pickle_from_file(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def pickle_to_file(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


# -- numpy -------------------------------------------------------------------
def load_from_file(path: str) -> np.ndarray:
    return np.load(path)


def save_to_file(obj, path: str) -> None:
    with open(path, "wb") as f:
        np.save(f, obj)


def load_from_dir(input_dir: str, handler=None) -> list:
    out = []
    for i, file in enumerate(sorted(glob.glob(input_dir + "/*.npy"))):
        obj = np.load(file)
        out.append(obj if handler is None else handler(i, obj))
    return out


# -- json --------------------------------------------------------------------
def json_from_file(path: str):
    with open(path) as f:
        return json.load(f)


def json_to_file(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def json_from_dir(input_dir: str, handler=None) -> list:
    out = []
    for i, file in enumerate(sorted(glob.glob(input_dir + "/*.json"))):
        with open(file) as f:
            obj = json.load(f)
        out.append(obj if handler is None else handler(i, obj))
    return out


# -- model artifacts ---------------------------------------------------------
class HostClassifier:
    """Duck-typed host-side classifier (sklearn etc.) with the reference
    wrapper's probability-column expansion (``moeva2/classifier.py:4-41``):
    numpy in, numpy out, on the host; for post-hoc evaluation of models
    that are not neural, never for an attack."""

    def __init__(self, model):
        self.model = model

    def predict_proba(self, x) -> np.ndarray:
        probs = np.asarray(self.model.predict_proba(np.asarray(x)))
        if probs.shape[-1] == 1:
            probs = np.concatenate([1.0 - probs, probs], axis=-1)
        return probs


def load_model(path: str):
    """Extension dispatch (parity ``in_out.load_model``): ``.joblib`` ->
    :class:`HostClassifier` (needs joblib); anything else ->
    ``models.io.load_classifier``'s surrogate."""
    if path.endswith(".joblib"):
        import joblib

        return HostClassifier(joblib.load(path))
    from ..models.io import load_classifier

    return load_classifier(path)


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
