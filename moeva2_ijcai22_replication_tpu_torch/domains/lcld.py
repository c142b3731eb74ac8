"""LCLD (LendingClub loan data) domain: 47 features, 10 relational constraints.

Port of ``moeva2_ijcai22_replication_tpu/domains/lcld.py`` (the augmented
variant is not ported yet).

Feature indices used: 0 loan_amnt, 1 term, 2 int_rate, 3 installment,
6 annual_inc, 7 issue_d, 9 earliest_cr_line, 10 open_acc, 11 pub_rec,
14 total_acc, 16 pub_rec_bankruptcies, 20..25 derived ratio features.
"""

from __future__ import annotations

import torch

from ..core.codec import full_ohe_tables, harden_onehot
from ..core.constraints import ConstraintSet
from ..core.schema import ConstraintBounds, FeatureSchema
from .synth import months

N_BASE_FEATURES = 47


def _installment(loan_amnt, term, int_rate):
    """Amortised monthly payment: L*r*(1+r)^t / ((1+r)^t - 1), r = rate/1200.
    The power is taken in float64 and rounded once, and 1200 is a 0-d
    tensor, so that the division is a true one on the card too (PyTorch on
    CUDA multiplies by the rounded reciprocal of a Python number): the
    operations of kernel K1, which float64 leaves unchanged."""
    r = int_rate / torch.full((), 1200.0, dtype=int_rate.dtype, device=int_rate.device)
    growth = torch.pow((1.0 + r).double(), term.double()).to(r.dtype)
    return loan_amnt * r * growth / (growth - 1.0)


def lcld_constraint_terms(x: torch.Tensor) -> torch.Tensor:
    """Unthresholded violation magnitudes, shape (..., 10), one rounded
    operation at a time in the order kernel K1
    (``kernels/csrc/objective_lcld.cu``) computes them."""
    g1 = torch.abs(x[..., 3] - _installment(x[..., 0], x[..., 1], x[..., 2])) - 0.099999
    # open_acc <= total_acc ; pub_rec_bankruptcies <= pub_rec
    g2 = x[..., 10] - x[..., 14]
    g3 = x[..., 16] - x[..., 11]
    # term must be one of {36, 60}
    g4 = torch.abs((36.0 - x[..., 1]) * (60.0 - x[..., 1]))
    # derived-ratio equalities
    g5 = torch.abs(x[..., 20] - x[..., 0] / x[..., 6])
    g6 = torch.abs(x[..., 21] - x[..., 10] / x[..., 14])
    g7 = torch.abs(x[..., 22] - (months(x[..., 7]) - months(x[..., 9])))
    g8 = torch.abs(x[..., 23] - x[..., 11] / x[..., 22])
    g9 = torch.abs(x[..., 24] - x[..., 16] / x[..., 22])
    # pub_rec_bankruptcies / pub_rec, with a 0 denominator (and any non-finite
    # result) mapped to the sentinel -1
    denom_ok = x[..., 11] != 0
    ratio = torch.where(denom_ok, x[..., 16] / torch.where(denom_ok, x[..., 11], 1.0), -1.0)
    ratio = torch.where(torch.isfinite(ratio), ratio, -1.0)
    g10 = torch.abs(x[..., 25] - ratio)
    return torch.stack([g1, g2, g3, g4, g5, g6, g7, g8, g9, g10], dim=-1)


class LcldConstraints(ConstraintSet):
    n_constraints = 10
    #: kernel K1 (``kernels/csrc/objective_lcld.cu``) computes these terms
    #: inside the objectives on the card
    objective_kernel = "lcld"

    def __init__(self, features_path: str, constraints_path: str):
        schema = FeatureSchema.from_csv(features_path)
        super().__init__(schema, ConstraintBounds.from_csv(constraints_path))
        self._ohe_idx, self._ohe_mask = full_ohe_tables(schema)

    def _raw(self, x: torch.Tensor) -> torch.Tensor:
        return lcld_constraint_terms(x)

    def repair(self, x: torch.Tensor) -> torch.Tensor:
        """Constructive repair: snap term to {36, 60}, recompute the
        installment by formula, harden every one-hot group to its argmax."""
        if x.shape[-1] > N_BASE_FEATURES:
            raise NotImplementedError("augmented LCLD inputs are not ported yet")
        x = x.clone()
        term = torch.where(x[..., 1] < (60.0 + 36.0) / 2.0, 36.0, 60.0).to(x.dtype)
        x[..., 1] = term
        x[..., 3] = _installment(x[..., 0], term, x[..., 2])
        return harden_onehot(x, self._ohe_idx.to(x.device), self._ohe_mask.to(x.device))
