"""MinMax feature scaling (port of ``models/scalers.py``).

Constants stay numpy float64, so one scaler is exact under the float64
judgement and compact in float32 inside the attack loop: ``transform``
converts them to the input tensor's dtype and device.

Formats: the JAX package keeps a fitted sklearn ``MinMaxScaler`` in a
``.joblib`` file (:func:`load_joblib_scaler`, which needs joblib and
sklearn, so it runs where they are installed). The port adds one format
that needs numpy alone, for machines without sklearn: ``scale`` and
``min_`` in float64 in an ``.npz`` (:func:`save_npz`, :func:`load_npz`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class MinMaxParams(NamedTuple):
    scale: np.ndarray  # multiply
    min_: np.ndarray  # then add  (sklearn's X * scale_ + min_)

    def tensors(self, like: torch.Tensor):
        """(scale, min_) as tensors of ``like``'s dtype and device."""
        return (
            torch.as_tensor(self.scale, dtype=like.dtype, device=like.device),
            torch.as_tensor(self.min_, dtype=like.dtype, device=like.device),
        )

    def transform(self, x):
        if isinstance(x, np.ndarray):
            return x * self.scale + self.min_
        scale, min_ = self.tensors(x)
        return x * scale + min_

    def inverse(self, x):
        if isinstance(x, np.ndarray):
            return (x - self.min_) / self.scale
        scale, min_ = self.tensors(x)
        return (x - min_) / scale


def fit_minmax(x_min: np.ndarray, x_max: np.ndarray) -> MinMaxParams:
    """Fit to explicit per-feature bounds (zero-range features: scale 1)."""
    rng = np.asarray(x_max, dtype=np.float64) - np.asarray(x_min, dtype=np.float64)
    scale = 1.0 / np.where(rng == 0, 1.0, rng)
    return MinMaxParams(scale=scale, min_=-np.asarray(x_min, dtype=np.float64) * scale)


def from_sklearn_minmax(scaler) -> MinMaxParams:
    """The parameters of a fitted sklearn ``MinMaxScaler``."""
    return MinMaxParams(
        scale=np.asarray(scaler.scale_, dtype=np.float64),
        min_=np.asarray(scaler.min_, dtype=np.float64),
    )


def load_joblib_scaler(path: str) -> MinMaxParams:
    """A ``.joblib`` sklearn ``MinMaxScaler`` (imports joblib and sklearn)."""
    import joblib

    return from_sklearn_minmax(joblib.load(path))


def save_npz(params: MinMaxParams, path: str) -> None:
    """Write ``scale`` and ``min_`` in float64 to an ``.npz``."""
    with open(path, "wb") as f:
        np.savez(
            f,
            scale=np.asarray(params.scale, dtype=np.float64),
            min_=np.asarray(params.min_, dtype=np.float64),
        )


def load_npz(path: str) -> MinMaxParams:
    with np.load(path, allow_pickle=False) as z:
        return MinMaxParams(scale=np.asarray(z["scale"], np.float64), min_=np.asarray(z["min_"], np.float64))
