"""MinMax feature scaling (port of ``models/scalers.py``).

Constants stay numpy float64, so one scaler is exact under the float64
judgement and compact in float32 inside the attack loop: ``transform``
converts them to the input tensor's dtype and device.
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
