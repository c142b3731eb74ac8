"""Result and artifact IO, and the model artifacts' suffix dispatch.

Port of ``utils/in_out.py``: the json, npy and pickle helpers and
``load_model``, whose artifacts go to ``models.io.load_classifier``. A
``.joblib`` host classifier (sklearn) waits for the runner that takes one
(ROADMAP A12).
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
def load_model(path: str):
    """The surrogate of a model artifact, by ``models.io.load_classifier``;
    a ``.joblib`` host classifier is refused until ROADMAP A12."""
    if path.endswith(".joblib"):
        raise NotImplementedError(f"{path}: host classifiers (.joblib) are not read by the port yet (ROADMAP A12)")
    from ..models.io import load_classifier

    return load_classifier(path)


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
