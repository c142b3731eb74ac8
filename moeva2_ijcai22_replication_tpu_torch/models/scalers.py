"""MinMax feature scaling (port of ``models/scalers.py``).

Constants stay numpy float64, so one scaler is exact under the float64
judgement and compact in float32 inside the attack loop: ``transform``
converts them to the input tensor's dtype and device.

Formats: the JAX package keeps a fitted sklearn ``MinMaxScaler`` in a
``.joblib`` file (:func:`load_joblib_scaler`, which needs joblib and
sklearn, so it runs where they are installed). The port adds one format
that needs numpy alone, for machines without sklearn: ``scale`` and
``min_`` in float64 in an ``.npz`` (:func:`save_npz`, :func:`load_npz`),
with the fitted bounds where the defense pipeline keeps them
(:func:`load_npz_bounds`); :func:`fit_minmax_sklearn` fits as sklearn's
``MinMaxScaler`` does, bit for bit.
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


def fit_minmax_sklearn(data_min: np.ndarray, data_max: np.ndarray) -> MinMaxParams:
    """``MinMaxScaler().fit(np.stack([data_min, data_max]))``'s ``scale_``
    and ``min_``, by sklearn's arithmetic (``1 / range``, ``0 - data_min *
    scale``: a zero bound gives ``min_`` +0.0, where :func:`fit_minmax`
    gives -0.0). sklearn reads a range below 10 eps as zero, this a range
    of exactly 0 only: the two agree on integer bounds, which the defense
    pipeline's floor/ceil envelope gives."""
    lo = np.asarray(data_min, dtype=np.float64)
    rng = np.asarray(data_max, dtype=np.float64) - lo
    scale = 1.0 / np.where(rng == 0, 1.0, rng)
    return MinMaxParams(scale=scale, min_=0.0 - lo * scale)


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


def save_npz(params: MinMaxParams, path: str, data_min=None, data_max=None) -> None:
    """Write ``scale`` and ``min_`` in float64 to an ``.npz``, with the
    fitted bounds ``data_min`` and ``data_max`` where given (the defense
    pipeline fits its augmented scaler from the base scaler's bounds, which
    ``scale`` and ``min_`` do not give back exactly)."""
    bounds = {} if data_min is None else {"data_min": np.asarray(data_min, np.float64),
                                          "data_max": np.asarray(data_max, np.float64)}
    with open(path, "wb") as f:
        np.savez(
            f,
            scale=np.asarray(params.scale, dtype=np.float64),
            min_=np.asarray(params.min_, dtype=np.float64),
            **bounds,
        )


def load_npz(path: str) -> MinMaxParams:
    with np.load(path, allow_pickle=False) as z:
        return MinMaxParams(scale=np.asarray(z["scale"], np.float64), min_=np.asarray(z["min_"], np.float64))


def load_npz_bounds(path: str) -> tuple:
    """``(data_min, data_max)`` that :func:`save_npz` kept (KeyError where
    it kept none)."""
    with np.load(path, allow_pickle=False) as z:
        return np.asarray(z["data_min"], np.float64), np.asarray(z["data_max"], np.float64)
