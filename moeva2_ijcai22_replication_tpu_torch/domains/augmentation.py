"""XOR feature augmentation, the "engineering defense".

Port of ``moeva2_ijcai22_replication_tpu/domains/augmentation.py``. For the
top-k important features, every pair (i, j) contributes a derived binary
feature ``XOR(x_i >= mean_i, x_j >= mean_j)``; the augmented features are
the last P = C(k, 2) columns of a row, and their consistency terms
``|x_aug - XOR(...)|`` are the augmented constraint sets' extra violations.

Semantics kept from the JAX package: ``x >= threshold`` (a NaN compares
False), a logical xor cast to the row's dtype, the pairs in
``itertools.combinations`` order.

Threshold rounding: the thresholds (float64 column means) are rounded once
to the dtype of the rows they are compared with, and the comparison is made
in that dtype. In float64 this is the JAX package's comparison under x64;
in float32 it is the JAX package's without x64, where ``jnp.asarray``
rounds the float64 means to float32. Kernels K1 and K7 compare a float32
feature with the float32 threshold the same way.
"""

from __future__ import annotations

from itertools import combinations
from math import comb
from typing import NamedTuple

import numpy as np
import torch


def pair_table(important_features: np.ndarray):
    """Static (P, 2) int32 index and (P, 2) float64 threshold tables over all
    pairs; ``important_features`` is (k, 2) rows of [feature_index,
    threshold_mean]."""
    important_features = np.asarray(important_features)
    pairs = list(combinations(range(important_features.shape[0]), 2))
    idx = np.array(
        [[int(important_features[i, 0]), int(important_features[j, 0])] for i, j in pairs],
        dtype=np.int32,
    ).reshape(-1, 2)
    thr = np.array(
        [[important_features[i, 1], important_features[j, 1]] for i, j in pairs], dtype=np.float64
    ).reshape(-1, 2)
    return idx, thr


def n_pairs(important_features: np.ndarray) -> int:
    return comb(np.asarray(important_features).shape[0], 2)


class PairTables(NamedTuple):
    """Pair index and threshold tables, built once per constraint set."""

    idx: torch.Tensor  # (P, 2) int64 feature indices
    thr: np.ndarray  # (P, 2) float64 thresholds, rounded to the rows' dtype at use

    @classmethod
    def build(cls, important_features: np.ndarray) -> "PairTables":
        idx, thr = pair_table(important_features)
        return cls(idx=torch.as_tensor(idx, dtype=torch.int64), thr=thr)

    @property
    def n_pairs(self) -> int:
        return self.idx.shape[0]

    def xor_features(self, x: torch.Tensor) -> torch.Tensor:
        """The (..., P) XOR pair features of the base features of ``x``."""
        thr = torch.as_tensor(self.thr, dtype=x.dtype, device=x.device)
        above = x[..., self.idx.to(x.device)] >= thr  # (..., P, 2)
        return torch.logical_xor(above[..., 0], above[..., 1]).to(x.dtype)

    def consistency_terms(self, x: torch.Tensor) -> torch.Tensor:
        """``|x_aug - XOR(...)|`` (..., P), the augmented features being the
        last P columns of ``x``."""
        return torch.abs(x[..., x.shape[-1] - self.n_pairs :] - self.xor_features(x))


def xor_features(x: torch.Tensor, important_features: np.ndarray) -> torch.Tensor:
    """The (..., P) XOR pair features of the base features of ``x``."""
    return PairTables.build(important_features).xor_features(x)


def augment(x: torch.Tensor, important_features: np.ndarray) -> torch.Tensor:
    """``x`` with its XOR pair features appended along the last axis."""
    return torch.cat([x, xor_features(x, important_features)], dim=-1)


def consistency_terms(x: torch.Tensor, important_features: np.ndarray) -> torch.Tensor:
    """|x_aug - XOR(...)| per pair, (..., P); the augmented features are the
    last P columns of ``x``."""
    return PairTables.build(important_features).consistency_terms(x)
