"""Feature and constraint schema loading.

Parses the ``features.csv`` / ``constraints.csv`` schema the reference defines
(columns ``feature,type,mutable,min,max[,augmentation]``, type in
{real, int, oheN, softmax}; min/max may be the literal string ``"dynamic"``
meaning the bound is resolved per input sample). ``softmax`` marks genes that
together form one probability simplex — the genetic operators renormalise the
sub-vector after every crossover/mutation (the reference registers dedicated
operators for this type, ``softmax_crossover.py:9-42``,
``softmax_mutation.py:8-71``, though none of its shipped datasets use it).

A numpy-only copy of ``moeva2_ijcai22_replication_tpu/core/schema.py``: the
JAX package's ``core/__init__.py`` imports JAX, so the port keeps its own.
The ``bounds`` resolution with a dynamic input mirrors
``get_feature_min_max(dynamic_input)``.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass

import numpy as np

OHE_PREFIX = "ohe"
SOFTMAX_TYPE = "softmax"


def _parse_bool(value: str) -> bool:
    return str(value).strip().upper() in ("TRUE", "1", "YES")


@dataclass(frozen=True)
class FeatureSchema:
    """Static description of one tabular use case's feature space."""

    names: tuple
    types: np.ndarray  # (D,) object: "real" | "int" | "ohe<N>" | "softmax"
    mutable: np.ndarray  # (D,) bool
    raw_min: np.ndarray  # (D,) object: float or "dynamic"
    raw_max: np.ndarray  # (D,) object: float or "dynamic"
    augmentation: np.ndarray  # (D,) bool — augmented (derived XOR) feature flag

    def __post_init__(self):
        # The type strings are semantically load-bearing across independent
        # consumers (codec genetics, MILP variable typing, PGD rounding): an
        # unrecognised string must fail here, at load, not drift into
        # contradictory per-consumer defaults.
        import re

        bad = [
            (n, t)
            for n, t in zip(self.names, self.types)
            if not re.fullmatch(rf"real|int|{SOFTMAX_TYPE}|{OHE_PREFIX}\d+", str(t))
        ]
        if bad:
            raise ValueError(
                f"unknown feature type(s) {bad}; expected real, int, "
                f"{SOFTMAX_TYPE}, or {OHE_PREFIX}<N>"
            )

    @property
    def n_features(self) -> int:
        return len(self.names)

    @property
    def min_dynamic(self) -> np.ndarray:
        return np.array([str(v) == "dynamic" for v in self.raw_min])

    @property
    def max_dynamic(self) -> np.ndarray:
        return np.array([str(v) == "dynamic" for v in self.raw_max])

    @property
    def has_dynamic_bounds(self) -> bool:
        return bool(self.min_dynamic.any() or self.max_dynamic.any())

    def bounds(self, dynamic_input: np.ndarray | None = None):
        """Resolve (xl, xu) float bounds; dynamic entries come from the input.

        With no dynamic input, dynamic entries resolve to 0.0 (the reference's
        behaviour, which it warns about). ``dynamic_input`` may be a single
        sample ``(D,)`` or a batch ``(S, D)`` — bounds broadcast accordingly.
        """
        min_dyn = self.min_dynamic
        max_dyn = self.max_dynamic
        xl = np.zeros(self.n_features)
        xu = np.zeros(self.n_features)
        xl[~min_dyn] = np.asarray(self.raw_min[~min_dyn], dtype=float)
        xu[~max_dyn] = np.asarray(self.raw_max[~max_dyn], dtype=float)
        if dynamic_input is not None:
            dynamic_input = np.asarray(dynamic_input, dtype=float)
            if dynamic_input.ndim == 1:
                xl = xl.copy()
                xu = xu.copy()
                xl[min_dyn] = dynamic_input[min_dyn]
                xu[max_dyn] = dynamic_input[max_dyn]
            else:
                xl = np.broadcast_to(xl, dynamic_input.shape).copy()
                xu = np.broadcast_to(xu, dynamic_input.shape).copy()
                xl[:, min_dyn] = dynamic_input[:, min_dyn]
                xu[:, max_dyn] = dynamic_input[:, max_dyn]
        return xl, xu

    def ohe_groups(self) -> list[np.ndarray]:
        """Index groups of one-hot-encoded features, in first-seen order."""
        seen: dict[str, list[int]] = {}
        for i, t in enumerate(self.types):
            t = str(t)
            if t.startswith(OHE_PREFIX):
                seen.setdefault(t, []).append(i)
        return [np.array(v) for v in seen.values()]

    @classmethod
    def from_csv(cls, path: str) -> "FeatureSchema":
        names, types, mutable, rmin, rmax, aug = [], [], [], [], [], []
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                names.append(row["feature"])
                types.append(row["type"])
                mutable.append(_parse_bool(row["mutable"]))
                rmin.append(_coerce_bound(row["min"]))
                rmax.append(_coerce_bound(row["max"]))
                aug.append(_parse_bool(row.get("augmentation", "FALSE")))
        return cls(
            names=tuple(names),
            types=np.array(types, dtype=object),
            mutable=np.array(mutable, dtype=bool),
            raw_min=np.array(rmin, dtype=object),
            raw_max=np.array(rmax, dtype=object),
            augmentation=np.array(aug, dtype=bool),
        )


def _coerce_bound(value: str):
    value = str(value).strip()
    if value == "dynamic":
        return "dynamic"
    return float(value)


@dataclass(frozen=True)
class ConstraintBounds:
    """Per-constraint (min, max) used to normalise violation magnitudes.

    Reference parity: ``constraints.csv`` consumed by ``_provision_constraints_min_max``
    + the MinMax scaler over them (``lcld_constraints.py:27-30,275-279``).
    """

    cmin: np.ndarray
    cmax: np.ndarray

    @property
    def n_constraints(self) -> int:
        return len(self.cmin)

    def normalise(self, g: np.ndarray) -> np.ndarray:
        rng = self.cmax - self.cmin
        rng = np.where(rng == 0, 1.0, rng)
        return (g - self.cmin) / rng

    @classmethod
    def from_csv(cls, path: str) -> "ConstraintBounds":
        cmin, cmax = [], []
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                cmin.append(float(row["min"]))
                cmax.append(float(row["max"]))
        return cls(cmin=np.array(cmin), cmax=np.array(cmax))
