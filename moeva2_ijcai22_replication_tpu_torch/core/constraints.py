"""Constraint-set API: violation kernels on tensors.

Port of ``moeva2_ijcai22_replication_tpu/core/constraints.py``. One function
``(..., D) -> (..., K)`` of unthresholded violations serves every consumer,
with two thresholding flavours:

- ``evaluate``: violations ``<= tol`` snap to exactly 0 (the oracle
  semantics);
- ``evaluate_smooth``: ``max(g - tol, 0)``, the differentiable flavour.
"""

from __future__ import annotations

import numpy as np
import torch

from .schema import ConstraintBounds, FeatureSchema

DEFAULT_TOL = 1e-3


class ConstraintViolationError(ValueError):
    pass


class ConstraintSet:
    """A use case's relational feature constraints. Subclasses implement
    ``_raw`` returning unthresholded violations ``(..., K)``."""

    n_constraints: int = 0
    tol: float = DEFAULT_TOL
    #: name of the hand-written objective kernel (K1, K8, K9) that serves
    #: this set on the card; None = no kernel, so the engine runs it on the
    #: CPU only
    objective_kernel: str | None = None
    #: name of the hand-written PGD kernel (K7, K7b, K10) that serves this
    #: set on the card; None = no kernel
    pgd_kernel: str | None = None
    #: why the set has no repair (its ``repair`` raises it), None where it
    #: has one: constrained PGD refuses a ``+repair`` loss on it before
    #: anything runs
    repair_undefined: str | None = None

    def __init__(self, schema: FeatureSchema, bounds: ConstraintBounds | None = None):
        self.schema = schema
        self.constraint_bounds = bounds
        if bounds is not None and self.n_constraints and bounds.n_constraints != self.n_constraints:
            raise ValueError(
                f"{type(self).__name__} defines {self.n_constraints} constraints "
                f"but the constraint-bounds file has {bounds.n_constraints} rows"
            )

    def _raw(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def kernel_tables(self, device):
        """What the objective kernel reads of this set besides the
        objectives' own tables, on ``device``; None where the kernel
        hard-codes the terms."""
        return None

    def pgd_kernel_tables(self, device):
        """What the PGD kernel reads of this set, on ``device``: the
        objective kernel's tables unless the set says otherwise."""
        return self.kernel_tables(device)

    def repair(self, x: torch.Tensor) -> torch.Tensor:
        """Project candidates toward constraint satisfaction; identity by
        default."""
        return x

    def smooth_vjp(self, x: torch.Tensor, ct_g: torch.Tensor):
        """``(evaluate_smooth(x), cotangent of x from ct_g)``: the hand-written
        backward that constrained PGD takes, with ``jax.grad``'s conventions.
        None by default: a set without one cannot be attacked by PGD."""
        raise NotImplementedError(f"{type(self).__name__} has no hand-written constraint backward")

    def evaluate(self, x: torch.Tensor) -> torch.Tensor:
        """Hard-thresholded violations: value if > tol else exactly 0."""
        g = self._raw(x)
        return torch.where(g > self.tol, g, 0.0)

    def evaluate_smooth(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable violations: clip(g - tol, 0, inf)."""
        return torch.clamp(self._raw(x) - self.tol, min=0.0)

    def normalise(self, g: torch.Tensor) -> torch.Tensor:
        if self.constraint_bounds is None:
            return g
        cmin = np.asarray(self.constraint_bounds.cmin, np.float64)
        rng = np.asarray(self.constraint_bounds.cmax, np.float64) - cmin
        inv = 1.0 / np.where(rng == 0, 1.0, rng)
        as_t = lambda a: torch.as_tensor(a, dtype=g.dtype, device=g.device)  # noqa: E731
        return (g - as_t(cmin)) * as_t(inv)

    def check_constraints_error(self, x: np.ndarray) -> None:
        """Raise if any sample violates any constraint (evaluated in float64
        on the CPU)."""
        g = self.evaluate(torch.as_tensor(np.asarray(x, np.float64))).numpy()
        n_bad = int((g > 0).sum())
        if n_bad > 0:
            raise ConstraintViolationError(
                f"{n_bad} constraint violations across {int((g.sum(-1) > 0).sum())} "
                f"samples (max violation {float(np.nanmax(g)):.6g})."
            )

    def get_mutable_mask(self) -> np.ndarray:
        return np.asarray(self.schema.mutable)

    def get_feature_type(self) -> np.ndarray:
        return np.asarray(self.schema.types)

    def get_feature_min_max(self, dynamic_input=None):
        return self.schema.bounds(dynamic_input)

    def get_nb_constraints(self) -> int:
        return self.n_constraints
