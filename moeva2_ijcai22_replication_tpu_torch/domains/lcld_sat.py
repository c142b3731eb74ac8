"""LCLD constraints linearised for the MILP attack.

Port of ``domains/lcld_sat.py``, whole: the same rows in the same order,
with the port's own copy of ``months`` (``domains/synth.py``).

Reference semantics: ``/root/reference/src/examples/lcld/lcld_constraints_sat.py``
(Gurobi: indicator constraints for term ∈ {36, 60}, ``addGenConstrPow`` for
(1+r)^term, integer div/mod date decomposition, big-M pub_rec guard).

HiGHS formulation:

- **term is searched, not pinned** (parity with the reference's indicator
  constraints, ``lcld_constraints_sat.py:25-36``): an auxiliary binary z
  selects the mode via ``term = 36 + 24·z``, and big-M rows activate the
  matching amortisation equality |installment − c_t·loan_amnt| ≤ 0.0999
  (int_rate is immutable, so both c_36 and c_60 are constants — the
  (1+r)^term power never has to live inside the MILP).
- **the mutable ratio denominators annual_inc and total_acc are searched,
  not pinned**: each gets a grid of candidate values over its ε-box (the
  hot-start and initial values are included after clamping into the box, so
  in-box pins are never lost) selected by one-hot binaries — the denominator
  variable is the
  exact linear combination Σ vₖ·zₖ, and each mode's ratio equality
  (g5: ratio = loan/annual_inc, g6: ratio = open/total) activates through
  big-M rows with benign magnitudes. This is the same mode-search
  architecture as the term switch; the reference instead hands Gurobi the
  nonconvex bilinear rows directly (``NonConvex=2``), so its search is
  continuous where ours is gridded. ``SatAttack.refine_rounds`` narrows that
  gap iteratively: each round re-grids the denominators around the incumbent
  solution with a ¼-shrinking window (monotone — the incumbent stays in the
  grid), reaching box/64 resolution after two rounds; the residual gap is
  the finite final resolution.
- pub_rec and both date features are pinned at hot-start values — **exact**
  pins, those features are immutable in the schema — so g7 fixes the
  month-difference feature and g8/g9/g10 are linear. A zero month
  difference (or an all-zero denominator grid) makes the corresponding
  equality unsatisfiable — the builder flags the program infeasible instead
  of emitting inf coefficients.
- one-hot groups: integral 0/1 members summing to 1.

The MILP searches term, loan_amnt, installment, open_acc,
pub_rec_bankruptcies, the derived ratios, and every one-hot group.
"""

from __future__ import annotations

import numpy as np

from ..attacks.sat.engine import LinearRows
from ..core.schema import FeatureSchema
from .synth import months as _months

SLACK = 1e-4  # inside the evaluator's 1e-3 snap tolerance


def _amortisation_factor(rate_pct: float, term: float) -> float:
    """c such that installment = c · loan_amnt (r = rate/1200); r → 0 limits
    to the interest-free 1/term."""
    r = rate_pct / 1200.0
    if r <= 0.0:
        return 1.0 / term
    growth = (1.0 + r) ** term
    return r * growth / (growth - 1.0)


def _denominator_grid(
    hot_v: float, init_v: float, lo: float, hi: float, n: int = 5
) -> list:
    """Candidate pins for a searched ratio denominator: hot-start and initial
    values clamped into the ε-box (the directional L2 radii can leave the raw
    hot displacement slightly outside it) plus an n-point spread over the box;
    near-zero values dropped — a tiny |v| would put num_hi/|v| big-Ms in the
    rows and wreck the MILP conditioning — and near-duplicates merged."""
    cand = [
        float(np.clip(hot_v, lo, hi)),
        float(np.clip(init_v, lo, hi)),
    ] + list(np.linspace(lo, hi, n))
    tol = 1e-6 * max(1.0, hi - lo)
    cand = [v for v in cand if abs(v) > tol]
    out: list = []
    for v in sorted(cand):
        if not out or abs(v - out[-1]) > 1e-9 * max(1.0, abs(v)):
            out.append(v)
    return out


def make_lcld_sat_builder(schema: FeatureSchema, grid_points: int = 5):
    """``grid_points`` sets the denominator-grid density (default 5; the
    refinement loop makes denser initial grids unnecessary in production —
    the dense setting exists as a brute-force oracle for tests)."""
    ohe_groups = [np.asarray(g) for g in schema.ohe_groups()]
    d = schema.n_features

    def build(
        x_init: np.ndarray,
        hot: np.ndarray,
        box: tuple | None = None,
        focus: np.ndarray | None = None,
        window: float = 1.0,
    ) -> LinearRows:
        """``focus``/``window`` drive the engine's iterative grid refinement
        (``SatAttack.refine_rounds``): with a focus solution, each searched
        denominator re-grids over ``window``·(box width) centred on the
        incumbent value — which is always kept in the grid, so refinement is
        monotone. Two rounds take the denominator resolution from box/4 to
        box/64, closing most of the gap to Gurobi's continuous nonconvex
        search (``lcld_constraints_sat.py:33-36``)."""
        rows = []
        fixes = {}

        # g1 + g4: term mode search. z = extra binary at index d;
        # term = 36 + 24·z keeps g4 exact for both assignments.
        z = d
        rows.append(([1, z], [1.0, -24.0], 36.0, 36.0))
        c36 = _amortisation_factor(x_init[2], 36.0)
        c60 = _amortisation_factor(x_init[2], 60.0)
        xl_s, xu_s = schema.bounds(dynamic_input=x_init[None, :])
        xl_s, xu_s = np.asarray(xl_s).reshape(-1), np.asarray(xu_s).reshape(-1)
        big_m = (
            max(abs(xu_s[3]), abs(xl_s[3]))
            + max(c36, c60) * max(abs(xu_s[0]), abs(xl_s[0]))
            + 1.0
        )
        # mode 36 (z = 0): |installment − c36·loan| ≤ 0.0999 + M·z
        rows.append(([3, 0, z], [1.0, -c36, -big_m], -np.inf, 0.0999))
        rows.append(([3, 0, z], [1.0, -c36, big_m], -0.0999, np.inf))
        # mode 60 (z = 1): |installment − c60·loan| ≤ 0.0999 + M·(1 − z)
        rows.append(([3, 0, z], [1.0, -c60, big_m], -np.inf, 0.0999 + big_m))
        rows.append(([3, 0, z], [1.0, -c60, -big_m], -0.0999 - big_m, np.inf))

        # g2/g3: orderings
        rows.append(([10, 14], [1.0, -1.0], -np.inf, 0.0))
        rows.append(([16, 11], [1.0, -1.0], -np.inf, 0.0))

        # exact pins: issue_d / earliest_cr_line / pub_rec are immutable, so
        # the hot-start value IS the only admissible value
        fixes[7] = hot[7]  # issue_d (g7 months)
        fixes[9] = hot[9]  # earliest_cr_line (g7 months)
        fixes[11] = hot[11]  # pub_rec (g3/g8/g10 denominator)
        diff = float(_months(fixes[7]) - _months(fixes[9]))
        if diff == 0:  # g8/g9 unsatisfiable: zero month difference
            return LinearRows(rows=[], fixes={}, feasible=False)

        # g5/g6: mutable denominators searched over a candidate grid. For a
        # denominator feature j with grid v_1..v_K and one-hot binaries z_k:
        #   x_j = Σ v_k z_k  (exact linear selection),  Σ z_k = 1,
        #   |ratio − numerator / v_k| ≤ SLACK + M_k (1 − z_k)  per mode.
        if box is not None:
            box_lo, box_hi = np.asarray(box[0]), np.asarray(box[1])
        else:  # standalone callers without a box: search hot ∪ init only
            box_lo = np.minimum(x_init, hot)
            box_hi = np.maximum(x_init, hot)
        n_bin = 1  # the term binary z at index d

        def denominator_modes(den: int, ratio: int, num_cols, num_coefs, num_hi):
            """Append mode-search rows for ratio == numerator / x_den, where
            the numerator is the linear form num_cols·num_coefs (|·| ≤ num_hi).
            Returns False when no admissible denominator value exists."""
            nonlocal n_bin
            if focus is None:
                grid = _denominator_grid(
                    hot[den], x_init[den], box_lo[den], box_hi[den],
                    n=grid_points,
                )
            else:
                v_star = float(focus[den])
                half = window * (box_hi[den] - box_lo[den]) / 2.0
                grid = _denominator_grid(
                    v_star,
                    v_star,
                    max(box_lo[den], v_star - half),
                    min(box_hi[den], v_star + half),
                    n=grid_points,
                )
            if not grid:
                return False
            base = d + n_bin
            n_bin += len(grid)
            zs = list(range(base, base + len(grid)))
            rows.append((zs, np.ones(len(grid)), 1.0, 1.0))  # Σ z_k = 1
            rows.append(  # x_den = Σ v_k z_k
                ([den] + zs, np.concatenate([[1.0], -np.asarray(grid)]), 0.0, 0.0)
            )
            for v, z_k in zip(grid, zs):
                big = (
                    max(abs(xu_s[ratio]), abs(xl_s[ratio]))
                    + num_hi / abs(v)
                    + 1.0
                )
                coefs = [1.0] + [-c / v for c in num_coefs]
                rows.append(
                    (([ratio] + list(num_cols) + [z_k]), coefs + [big], -np.inf, SLACK + big)
                )
                rows.append(
                    (([ratio] + list(num_cols) + [z_k]), coefs + [-big], -SLACK - big, np.inf)
                )
            return True

        # g5: ratio_loan_income == loan_amnt / annual_inc
        ok5 = denominator_modes(6, 20, [0], [1.0], max(abs(xu_s[0]), abs(xl_s[0])))
        # g6: ratio_open_total == open_acc / total_acc
        ok6 = denominator_modes(14, 21, [10], [1.0], max(abs(xu_s[10]), abs(xl_s[10])))
        if not (ok5 and ok6):  # every candidate denominator was zero/out-of-box
            return LinearRows(rows=[], fixes={}, feasible=False)

        # g7: month difference fixed by the pinned dates
        fixes[22] = diff
        # g8/g9: ratios over the (constant) month difference
        rows.append(([23, 11], [1.0, -1.0 / diff], -SLACK, SLACK))
        rows.append(([24, 16], [1.0, -1.0 / diff], -SLACK, SLACK))
        # g10: pub_rec_bankruptcies / pub_rec, sentinel -1 on zero denominator
        if fixes[11] == 0:
            fixes[25] = -1.0
            fixes[16] = 0.0  # g3 with pub_rec = 0
        else:
            rows.append(([25, 16], [1.0, -1.0 / fixes[11]], -SLACK, SLACK))

        # one-hot validity: each group sums to exactly 1
        for g in ohe_groups:
            rows.append((g, np.ones(len(g)), 1.0, 1.0))

        return LinearRows(rows=rows, fixes=fixes, n_extra_bin=n_bin)

    return build
