"""LCLD (LendingClub loan data) domain: 47 features, 10 relational constraints;
its augmented variant adds C(k, 2) XOR pair features and their consistency
terms (10 + 10 for k = 5).

Port of ``moeva2_ijcai22_replication_tpu/domains/lcld.py``.

Feature indices used: 0 loan_amnt, 1 term, 2 int_rate, 3 installment,
6 annual_inc, 7 issue_d, 9 earliest_cr_line, 10 open_acc, 11 pub_rec,
14 total_acc, 16 pub_rec_bankruptcies, 20..25 derived ratio features.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..core.codec import full_ohe_tables, harden_onehot
from ..core.constraints import ConstraintSet
from ..core.schema import ConstraintBounds, FeatureSchema
from ..core.vjp import abs_vjp, clip_vjp, div_vjp, pow_base_jac, pow_exp_jac
from . import augmentation
from .synth import months

N_BASE_FEATURES = 47
N_BASE_TERMS = 10


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


def _pow_jacobians(base, t):
    """``(growth, d growth / d base, d growth / d t)`` of ``base ** t``: the
    growth as :func:`_installment` takes it, its derivatives ``t * base **
    (t - 1)`` and ``log(base) * base ** t`` (``jax.lax.pow``'s, a 0 base's
    log taken at 1), each in float64 and rounded once."""
    return torch.pow(base.double(), t.double()).to(base.dtype), pow_base_jac(base, t), pow_exp_jac(base, t)


def lcld_smooth_vjp(u: torch.Tensor, ct_g: torch.Tensor, tol: float):
    """``(g, ct_u)``: the smooth violations ``g = clip(terms(u) - tol, 0,
    inf)`` (..., 10) of the unscaled rows ``u`` (..., 47), as
    :meth:`LcldConstraints.evaluate_smooth` computes them, and the cotangent
    of ``u`` from ``ct_g`` (..., 10), the backward ``jax.grad`` takes through
    ``lcld_constraint_terms``.

    The conventions are ``jax.grad``'s (abs, clip and division as
    ``core/vjp.py`` gives them; a ``where`` passes the cotangent to the
    branch it took and exact zeros to the other; months has derivative
    1). Every product of the chain rule is taken, also where
    a cotangent is 0, so NaN and inf land where ``jax.grad`` puts them: a
    term whose clip is inactive still sends NaN into the features of a 0
    denominator. The contributions to a feature are summed term by term,
    g1 first, one rounded operation at a time from 0: the order kernel K7
    (``kernels/csrc/pgd_lcld.cu``) keeps.
    """
    x = lambda k: u[..., k]  # noqa: E731
    ct = torch.zeros_like(u)

    def add(k, c):
        ct[..., k] = ct[..., k] + c

    # forward, in lcld_constraint_terms' operations
    r = x(2) / torch.full((), 1200.0, dtype=u.dtype, device=u.device)
    base = 1.0 + r
    growth, d_base, d_t = _pow_jacobians(base, x(1))
    p1 = x(0) * r
    p2 = p1 * growth
    dn = growth - 1.0
    inst = p2 / dn
    v1 = x(3) - inst
    a4, b4 = 36.0 - x(1), 60.0 - x(1)
    v4 = a4 * b4
    q5, q6 = x(0) / x(6), x(10) / x(14)
    v5, v6 = x(20) - q5, x(21) - q6
    m7 = months(x(7)) - months(x(9))
    v7 = x(22) - m7
    q8, q9 = x(11) / x(22), x(16) / x(22)
    v8, v9 = x(23) - q8, x(24) - q9
    ok = x(11) != 0
    den10 = torch.where(ok, x(11), 1.0)
    q10 = torch.where(ok, x(16) / den10, -1.0)
    fin10 = torch.isfinite(q10)
    v10 = x(25) - torch.where(fin10, q10, -1.0)
    raw = torch.stack(
        [torch.abs(v1) - 0.099999, x(10) - x(14), x(16) - x(11), torch.abs(v4), torch.abs(v5),
         torch.abs(v6), torch.abs(v7), torch.abs(v8), torch.abs(v9), torch.abs(v10)], dim=-1,
    )
    pre = raw - tol
    g = torch.clamp(pre, min=0.0)

    # backward, term by term
    c_all = clip_vjp(pre, ct_g)
    c = lambda k: c_all[..., k]  # noqa: E731
    # g1: |x3 - installment(x0, x1, x2)|
    c_v = abs_vjp(v1, c(0))
    add(3, c_v)
    c_p2, c_dn = div_vjp(-c_v, p2, dn)
    c_growth = c_p2 * p1 + c_dn
    c_p1 = c_p2 * growth
    add(0, c_p1 * r)
    add(2, (c_p1 * x(0) + c_growth * d_base) / torch.full((), 1200.0, dtype=u.dtype, device=u.device))
    add(1, c_growth * d_t)
    # g2, g3: differences
    add(10, c(1))
    add(14, -c(1))
    add(16, c(2))
    add(11, -c(2))
    # g4: |(36 - x1)(60 - x1)|
    c_v = abs_vjp(v4, c(3))
    add(1, -(c_v * b4))
    add(1, -(c_v * a4))
    # g5, g6: ratio equalities
    for k, v, num, d, out in ((4, v5, 0, 6, 20), (5, v6, 10, 14, 21)):
        c_v = abs_vjp(v, c(k))
        add(out, c_v)
        c_num, c_den = div_vjp(-c_v, x(num), x(d))
        add(num, c_num)
        add(d, c_den)
    # g7: month count; months' derivative is 1
    c_v = abs_vjp(v7, c(6))
    add(22, c_v)
    add(7, -c_v)
    add(9, -(-c_v))
    # g8, g9: ratios over x22
    for k, v, num, out in ((7, v8, 11, 23), (8, v9, 16, 24)):
        c_v = abs_vjp(v, c(k))
        add(out, c_v)
        c_num, c_den = div_vjp(-c_v, x(num), x(22))
        add(num, c_num)
        add(22, c_den)
    # g10: x16 / x11 with the -1 sentinel; a where passes 0 to the branch
    # it did not take
    c_v = abs_vjp(v10, c(9))
    add(25, c_v)
    c_div = torch.where(ok, torch.where(fin10, -c_v, 0.0), 0.0)
    c_num, c_den = div_vjp(c_div, x(16), den10)
    add(16, c_num)
    add(11, torch.where(ok, c_den, 0.0))
    return g, ct


class LcldConstraints(ConstraintSet):
    n_constraints = 10
    #: kernel K1 (``kernels/csrc/objective_lcld.cu``) computes these terms
    #: inside the objectives on the card
    objective_kernel = "lcld"
    #: kernel K7 (``kernels/csrc/pgd_lcld.cu``) runs constrained PGD on the
    #: card with these terms and their backward
    pgd_kernel = "lcld"

    def __init__(self, features_path: str, constraints_path: str, important_features_path: str | None = None):
        schema = FeatureSchema.from_csv(features_path)
        super().__init__(schema, ConstraintBounds.from_csv(constraints_path))
        if important_features_path is None:
            important_features_path = os.path.join(os.path.dirname(features_path), "important_features.npy")
        self.important_features = (
            np.load(important_features_path) if os.path.exists(important_features_path) else None
        )
        self._ohe_idx, self._ohe_mask = full_ohe_tables(schema)

    def _raw(self, x: torch.Tensor) -> torch.Tensor:
        return lcld_constraint_terms(x)

    def smooth_vjp(self, u: torch.Tensor, ct_g: torch.Tensor):
        """:func:`lcld_smooth_vjp` at this set's tolerance; the columns of an
        augmented row past the 47 base features get a zero cotangent."""
        return lcld_smooth_vjp(u, ct_g, self.tol)

    def repair(self, x: torch.Tensor) -> torch.Tensor:
        """Constructive repair: snap term to {36, 60}, recompute the
        installment by formula, harden every one-hot group to its argmax,
        and re-derive the XOR features of an augmented row from its repaired
        base features."""
        x = x.clone()
        term = torch.where(x[..., 1] < (60.0 + 36.0) / 2.0, 36.0, 60.0).to(x.dtype)
        x[..., 1] = term
        x[..., 3] = _installment(x[..., 0], term, x[..., 2])
        x = harden_onehot(x, self._ohe_idx.to(x.device), self._ohe_mask.to(x.device))
        if x.shape[-1] > N_BASE_FEATURES:
            if self.important_features is None:
                raise FileNotFoundError(
                    "repair() on augmented inputs requires important_features.npy "
                    "to re-derive the XOR features (otherwise they would be left "
                    "stale and constraint-violating)"
                )
            base = x[..., : x.shape[-1] - augmentation.n_pairs(self.important_features)]
            x = augmentation.augment(base, self.important_features)
        return x


class LcldPairTables(NamedTuple):
    """What kernels K1 and K7 read of an augmented LCLD set: its pairs'
    base features and their thresholds, rounded once to float32."""

    idx: torch.Tensor  # (P, 2) int32
    thr: torch.Tensor  # (P, 2) float32


class LcldAugmentedConstraints(LcldConstraints):
    """LCLD and the XOR-consistency terms of its augmented features: 10 + P
    terms (P = C(k, 2) pairs of k important features; 10 + 10 at k = 5)."""

    n_constraints = 20

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.important_features is None:
            raise FileNotFoundError(
                "LcldAugmentedConstraints requires important_features.npy "
                "(pass important_features_path or place it next to features.csv)"
            )
        feats = self.important_features[:, 0]
        if not np.isin(feats, np.arange(N_BASE_FEATURES)).all():
            # the XOR features are derived from base features only (the
            # repair re-derives them from the first 47 columns)
            raise ValueError(f"important features must index base features in [0, {N_BASE_FEATURES}), got {feats}")
        self._pairs = augmentation.PairTables.build(self.important_features)

    def _raw(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([lcld_constraint_terms(x), self._pairs.consistency_terms(x)], dim=-1)

    def kernel_tables(self, device) -> LcldPairTables:
        return LcldPairTables(
            idx=self._pairs.idx.to(device=device, dtype=torch.int32),
            thr=torch.as_tensor(self._pairs.thr, dtype=torch.float32, device=device),
        )

    def smooth_vjp(self, u: torch.Tensor, ct_g: torch.Tensor):
        """``(g, ct_u)`` over the 10 + P terms: :func:`lcld_smooth_vjp` of the
        base terms, then each pair's ``abs_vjp(v, clip_vjp(pre, ct))`` added
        to its augmented column from 0 (the base terms touch none of them).
        No cotangent flows through the comparisons, as under ``jax.grad``."""
        g_base, ct = lcld_smooth_vjp(u, ct_g[..., :N_BASE_TERMS], self.tol)
        p = self._pairs.n_pairs
        v = u[..., u.shape[-1] - p :] - self._pairs.xor_features(u)
        pre = torch.abs(v) - self.tol
        c_v = abs_vjp(v, clip_vjp(pre, ct_g[..., N_BASE_TERMS:]))
        ct[..., u.shape[-1] - p :] = ct[..., u.shape[-1] - p :] + c_v
        return torch.cat([g_base, torch.clamp(pre, min=0.0)], dim=-1), ct
