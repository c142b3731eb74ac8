"""Post-hoc attack evaluation: the o1..o7 success metrics.

Port of ``attacks/objective.py``. Per candidate ``[constraint_violation, f1,
f2]``: the summed domain violations plus the one-hot distance over ALL OHE
groups, the probability of ``minimize_class``, and the unscaled Lp distance
in min-max-scaled feature space. o1..o7 = C, M, D, C∧M, C∧D, M∧D, C∧M∧D.

The judgement runs in float64 on the host CPU, as the JAX package's
``precise=True`` does: it is the reference's numpy-float64 semantics, not a
fallback from the card.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core.codec import all_ohe_groups_distance, full_ohe_tables
from ..core.constraints import ConstraintSet
from ..core.norms import lp_distance, validate_norm
from ..models.io import Surrogate
from ..models.scalers import MinMaxParams

O_COLUMNS = ("o1", "o2", "o3", "o4", "o5", "o6", "o7")
QUALITY_STAT_COLUMNS = O_COLUMNS + ("best_cv", "best_dist")


def engine_quality_stats(f, threshold: float, eps: float):
    """Per-state statistics (..., 9) from engine-space objectives ``f``
    (..., P, 3) = ``[f1, f2, Σ violations]``: the seven "state holds ≥1
    qualifying candidate" flags (C = Σ violations ≤ 0, M = f1 < threshold,
    D = f2 ≤ eps), the best summed violation, and the best distance among
    misclassified ∧ feasible candidates (+inf when none). Takes a tensor or
    a numpy array and returns the same kind."""
    as_numpy = isinstance(f, np.ndarray)
    f = torch.as_tensor(f)
    c = f[..., 2] <= 0.0
    m = f[..., 0] < threshold
    d = f[..., 1] <= eps
    cols = (c, m, d, c & m, c & d, m & d, c & m & d)
    o = [col.any(dim=-1).to(f.dtype) for col in cols]
    best_cv = f[..., 2].amin(dim=-1)
    best_dist = torch.where(c & m, f[..., 1], torch.inf).amin(dim=-1)
    out = torch.stack([*o, best_cv, best_dist], dim=-1)
    return out.numpy() if as_numpy else out


def write_success_rate_csv(record: dict, path: str) -> None:
    """Write a success-rate record as the JAX runner's CSV: the text of
    pandas' ``DataFrame([record]).to_csv(path, index=False)``, a header line
    of the columns and one line of their values by ``repr``."""
    with open(path, "w") as f:
        f.write(",".join(record) + "\n")
        f.write(",".join(repr(float(v)) for v in record.values()) + "\n")


@dataclass
class ObjectiveCalculator:
    classifier: Surrogate
    constraints: ConstraintSet
    thresholds: dict  # {"f1": misclassification threshold, "f2": eps}
    min_max_scaler: MinMaxParams
    minimize_class: int = 1
    norm: Any = np.inf
    ml_scaler: MinMaxParams | None = None

    def __post_init__(self):
        validate_norm(self.norm)
        self._ohe_idx, self._ohe_mask = full_ohe_tables(self.constraints.schema)
        self._model = copy.deepcopy(self.classifier.model).to(
            device="cpu", dtype=torch.float64
        ).eval()

    @torch.inference_mode()
    def objectives(self, x_initial: np.ndarray, x_f: np.ndarray) -> np.ndarray:
        """[cv, f1, f2] per candidate of ``x_f`` (..., P, D) against
        ``x_initial`` (..., D), in float64 on the CPU."""
        x_initial = torch.as_tensor(np.asarray(x_initial, np.float64))
        x_f = torch.as_tensor(np.asarray(x_f, np.float64))
        g = self.constraints.evaluate(x_f)
        cv = g.sum(-1) + all_ohe_groups_distance(self._ohe_idx, self._ohe_mask, x_f)
        x_ml = self.ml_scaler.transform(x_f) if self.ml_scaler is not None else x_f
        probs = Surrogate(self._model).predict_proba(x_ml)
        f1 = probs[..., self.minimize_class]
        xi = self.min_max_scaler.transform(x_initial)[..., None, :]
        xs = self.min_max_scaler.transform(x_f)
        f2 = lp_distance(xi - xs, self.norm)
        tol = 1e-4
        # NaN-propagating, as the reference's jnp.minimum / jnp.maximum: a
        # NaN anywhere fails the check (Python's min and max would drop it)
        lo = float(torch.minimum(xi.min(), xs.min()))
        hi = float(torch.maximum(xi.max(), xs.max()))
        if not (lo >= -tol and hi <= 1 + tol):
            raise AssertionError("min-max scaled values outside [0,1]: wrong scaler for this data?")
        return torch.stack([cv, f1, f2], dim=-1).numpy()

    def respected(self, objective_values: np.ndarray) -> np.ndarray:
        """o1..o7 booleans from [cv, f1, f2]."""
        c = objective_values[..., 0] <= 0
        m = objective_values[..., 1] < self.thresholds["f1"]
        d = objective_values[..., 2] <= self.thresholds["f2"]
        return np.stack([c, m, d, c & m, c & d, m & d, c & m & d], axis=-1)

    def success_rate(self, x_initial: np.ndarray, x_f: np.ndarray) -> np.ndarray:
        """Mean of each o-column over one state's population."""
        return self.respected(self.objectives(x_initial, x_f)).mean(axis=-2)

    def at_least_one(self, x_initial, x_f) -> np.ndarray:
        return self.success_rate(x_initial, x_f) > 0

    def success_rate_3d(self, x_initial: np.ndarray, x: np.ndarray, objective_values=None) -> np.ndarray:
        """(7,) fraction of states with ≥1 qualifying candidate."""
        if objective_values is None:
            objective_values = self.objectives(x_initial, x)
        return self.respected(objective_values).any(axis=1).mean(axis=0)

    def success_rate_3d_record(self, x_initial: np.ndarray, x: np.ndarray, objective_values=None) -> dict:
        """:meth:`success_rate_3d` as ``{"o1": float, ..., "o7": float}``: the
        JAX package's ``success_rate_3d_df(...).to_dict(orient="records")[0]``,
        without pandas."""
        rates = self.success_rate_3d(x_initial, x, objective_values)
        return {k: float(v) for k, v in zip(O_COLUMNS, rates)}

    def get_successful_attacks(
        self,
        x_initials: np.ndarray,  # (S, D)
        x_generated: np.ndarray,  # (S, P, D)
        preferred_metrics: str = "misclassification",
        order: str = "asc",
        max_inputs: int = -1,
        return_index_success: bool = False,
    ):
        """o7-successful candidates per state, sorted by the preferred metric
        (at most ``max_inputs`` per state when it is > -1)."""
        metric_col = {"misclassification": 1, "distance": 2}[preferred_metrics]
        vals = self.objectives(x_initials, x_generated)
        ok = self.respected(vals)[..., -1]
        out, index_success = [], []
        for i in range(vals.shape[0]):
            idx = np.argsort(vals[i, :, metric_col], kind="stable")
            if order == "desc":
                idx = idx[::-1]
            idx = idx[ok[i, idx]]
            if max_inputs > -1:
                idx = idx[:max_inputs]
            out.append(np.asarray(x_generated)[i, idx])
            index_success.append(len(idx) >= 1)
        successful = np.concatenate(out, axis=0)
        if return_index_success:
            return successful, np.array(index_success)
        return successful
