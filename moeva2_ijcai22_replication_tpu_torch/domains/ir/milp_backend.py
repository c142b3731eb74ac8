"""MILP compiler backend: spec -> HiGHS ``LinearRows`` builder.

Port of ``moeva2_ijcai22_replication_tpu/domains/ir/milp_backend.py``, whole:
host numpy over the port's ``LinearRows``, ``DEFAULT_TOL``, ``SLACK`` and
``_denominator_grid``, so that a spec builds the same rows, array by array.
The anchored values are the AST evaluated in numpy float64
(:func:`_eval_np`, the JAX package's evaluator with numpy's ufuncs).

Generalizes the hand-written linearizations (``domains/lcld_sat.py``,
``domains/botnet_sat.py``) into one compiler over the IR:

- **pins**: immutable features are fixed at the hot-start value; a
  *pin-propagation fixpoint* then derives every feature a defining equality
  forces to a constant (the month-difference pattern: pinned dates make
  ``g7`` constant, which makes ``g8``/``g9`` linear). A propagated division
  by zero (zero month difference) flags the program infeasible — exactly
  ``lcld_sat``'s ``diff == 0`` escape.
- **affine rows**: constraints affine in the surviving variables emit plain
  rows — ``<=`` one-sided, ``==`` two-sided at ``±SLACK`` (inside the
  evaluator's 1e-3 snap), ``abs(E) <= c`` as a two-sided band.
- **membership modes**: ``f in {v1..vk}`` on a searched feature becomes
  one-hot mode binaries (``f = Σ v_k z_k``, ``Σ z_k = 1``); a constraint
  that is nonlinear only through such a feature (the term/amortisation
  pattern) is re-extracted per mode with big-M activation rows.
- **denominator grids**: ``r == n / d`` (and the guarded
  ``safe_div``/``finite_div`` forms) with a searched denominator reuses the
  ``lcld_sat`` denominator-grid pattern — candidate pins over the ε-box
  selected by one-hot binaries, with ``focus``/``window`` re-gridding for
  the engine's refinement rounds. Guarded ratios additionally get a
  *sentinel mode* (denominator pinned 0, ratio pinned to the sentinel)
  whenever 0 lies in the box, so the ``pub_rec == 0`` branch stays
  reachable without the hand-written special case.
- **guarded ratio bounds**: ``safe_div(n, d, s) <= C`` with ``d >= 0`` and
  ``s <= C`` cross-multiplies to ``n − C·d <= 0`` (the botnet 1500-ratio
  row; conservative at ``d = 0``).
- **anchored fallback**: residual nonlinearities whose value the
  hand-written builders also freeze at the initial point (the
  ``(1+r)^term`` amortisation factor with a *mutable* rate) are evaluated
  numerically at the anchor (x_init + pins) — products of two non-constant
  affines anchor the **right** operand, so specs should keep the searched
  variable leftmost (the committed lcld spec does).

Anything outside this inventory raises :class:`SpecMilpError` with the
constraint name — ``tools/domain_lint.py`` builds every committed spec once
to prove it compiles.
"""

from __future__ import annotations

import math

import numpy as np

from ...attacks.sat.engine import LinearRows
from ...core.constraints import DEFAULT_TOL
from ..lcld_sat import SLACK, _denominator_grid
from . import expr as E
from . import ops
from .spec import ResolvedSpec


def _eval_np(node, x: np.ndarray, env):
    """``(value, width)`` of ``node`` over the float64 rows ``x`` (..., D) in
    numpy: a literal a Python float, a feature a column, a group its columns;
    the operators numpy's (``^`` is ``np.power``), the guarded divisions and
    ``months`` :mod:`.ops`'."""
    if isinstance(node, E.Num):
        return node.value, 0
    if isinstance(node, E.Feat):
        return x[..., env.col(node.name)], 1
    if isinstance(node, E.Group):
        idx = env.group(node.name)
        return x[..., idx], len(idx)
    if isinstance(node, E.Neg):
        v, w = _eval_np(node.arg, x, env)
        return -v, w
    if isinstance(node, E.Bin):
        a, wa = _eval_np(node.lhs, x, env)
        b, wb = _eval_np(node.rhs, x, env)
        a, b, w = E._align(a, wa, b, wb)
        if node.op == "^":
            return np.power(a, b), w
        return {"+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b, "/": lambda: a / b}[node.op](), w
    if isinstance(node, E.Call):
        if node.fn == "sum":
            v, w = _eval_np(node.args[0], x, env)
            if w < 2:
                raise E.SpecError("sum() takes a @group argument")
            return v.sum(-1), 1
        if node.fn in ("abs", "months"):
            v, w = _eval_np(node.args[0], x, env)
            return (np.abs(v) if node.fn == "abs" else ops.months(v)), w
        if node.fn in ("safe_div", "finite_div"):
            n, wn = _eval_np(node.args[0], x, env)
            d, wd = _eval_np(node.args[1], x, env)
            n, d, w = E._align(n, wn, d, wd)
            fn = ops.safe_div if node.fn == "safe_div" else ops.finite_div
            return fn(n, d, E.sentinel_value(node)), w
    raise E.SpecError(f"cannot evaluate {node!r}")


class SpecMilpError(ValueError):
    """A constraint shape the MILP backend cannot linearize."""


class _NonAffine(Exception):
    pass


class _Infeasible(Exception):
    pass


class _RatioMode(Exception):
    """num / den with a searched bare-feature denominator."""

    def __init__(self, den_col: int, num: "_Affine", sentinel: float | None):
        super().__init__(den_col)
        self.den_col = den_col
        self.num = num
        self.sentinel = sentinel


class _Affine:
    __slots__ = ("const", "coefs")

    def __init__(self, const: float = 0.0, coefs: dict | None = None):
        self.const = float(const)
        self.coefs = coefs or {}

    @property
    def is_const(self) -> bool:
        return not self.coefs

    def add(self, other: "_Affine", sign: float = 1.0) -> "_Affine":
        coefs = dict(self.coefs)
        for c, v in other.coefs.items():
            coefs[c] = coefs.get(c, 0.0) + sign * v
        coefs = {c: v for c, v in coefs.items() if v != 0.0}
        return _Affine(self.const + sign * other.const, coefs)

    def scale(self, k: float) -> "_Affine":
        return _Affine(self.const * k, {c: v * k for c, v in self.coefs.items()})


def _sentinel_value(node) -> float:
    if isinstance(node, E.Num):
        return node.value
    if isinstance(node, E.Neg) and isinstance(node.arg, E.Num):
        return -node.arg.value
    raise SpecMilpError("guarded-division sentinel must be a literal")


class _Extractor:
    """Affine extraction under pins, with optional element context for group
    constraints and optional anchored numeric fallback."""

    def __init__(self, env, pins: dict, elem: int | None, anchor=None):
        self.env = env
        self.pins = pins
        self.elem = elem
        self.anchor = anchor  # (D,) numpy row with pins applied, or None

    def _numeric(self, node) -> float:
        if self.anchor is None:
            raise _NonAffine(node)
        with np.errstate(divide="ignore", invalid="ignore"):
            v, w = _eval_np(node, self.anchor[None, :], self.env)
        v = np.asarray(v, dtype=float)
        if w > 1:
            v = v[..., self.elem]
        v = float(np.ravel(v)[0])
        if not np.isfinite(v):
            raise _Infeasible(f"anchored value of {E.canon_expr(node)} not finite")
        return v

    def _col(self, col: int) -> _Affine:
        if col in self.pins:
            return _Affine(self.pins[col])
        return _Affine(0.0, {col: 1.0})

    def run(self, node) -> _Affine:
        if isinstance(node, E.Num):
            return _Affine(node.value)
        if isinstance(node, E.Feat):
            return self._col(self.env.col(node.name))
        if isinstance(node, E.Group):
            idx = self.env.group(node.name)
            if self.elem is None:
                raise SpecMilpError(
                    f"group @{node.name} outside an elementwise constraint"
                )
            return self._col(int(idx[self.elem]))
        if isinstance(node, E.Neg):
            return self.run(node.arg).scale(-1.0)
        if isinstance(node, E.Bin):
            return self._bin(node)
        if isinstance(node, E.Call):
            return self._call(node)
        raise _NonAffine(node)

    def _bin(self, node: E.Bin) -> _Affine:
        if node.op in ("+", "-"):
            return self.run(node.lhs).add(
                self.run(node.rhs), 1.0 if node.op == "+" else -1.0
            )
        if node.op == "*":
            a, b = self.run(node.lhs), self.run(node.rhs)
            if a.is_const:
                return b.scale(a.const)
            if b.is_const:
                return a.scale(b.const)
            # two searched factors: anchor the right operand (spec
            # convention: searched variable leftmost)
            return a.scale(self._numeric(node.rhs))
        if node.op == "/":
            num = self.run(node.lhs)
            den = self.run(node.rhs)
            if den.is_const:
                if den.const == 0.0:
                    raise _Infeasible(
                        f"division by pinned zero in {E.canon_expr(node)}"
                    )
                return num.scale(1.0 / den.const)
            den_col = self._bare_col(node.rhs)
            if den_col is not None and self.anchor is None:
                raise _RatioMode(den_col, num, None)
            return num.scale(1.0 / self._numeric(node.rhs))
        if node.op == "^":
            a, b = self.run(node.lhs), self.run(node.rhs)
            if a.is_const and b.is_const:
                return _Affine(a.const**b.const)
            return _Affine(self._numeric(node))
        raise _NonAffine(node)

    def _call(self, node: E.Call) -> _Affine:
        if node.fn == "sum":
            arg = node.args[0]
            if not isinstance(arg, E.Group):
                raise SpecMilpError("sum() takes a @group argument")
            out = _Affine(0.0)
            for col in self.env.group(arg.name):
                out = out.add(self._col(int(col)))
            return out
        if node.fn in ("abs", "months"):
            a = self.run(node.args[0])
            if a.is_const:
                return _Affine(
                    math.fabs(a.const)
                    if node.fn == "abs"
                    else float(ops.months(float(a.const)))
                )
            return _Affine(self._numeric(node))
        if node.fn in ("safe_div", "finite_div"):
            sentinel = _sentinel_value(node.args[2])
            num = self.run(node.args[0])
            den = self.run(node.args[1])
            if den.is_const:
                if den.const == 0.0:
                    return _Affine(sentinel)
                return num.scale(1.0 / den.const)
            den_col = self._bare_col(node.args[1])
            if den_col is not None and self.anchor is None:
                raise _RatioMode(den_col, num, sentinel)
            return _Affine(self._numeric(node))
        raise _NonAffine(node)

    def _bare_col(self, node) -> int | None:
        if isinstance(node, E.Feat):
            return self.env.col(node.name)
        if isinstance(node, E.Group) and self.elem is not None:
            return int(self.env.group(node.name)[self.elem])
        return None


def make_spec_sat_builder(constraints_set, grid_points: int = 5):
    """``SpecConstraintSet`` instance -> ``build(x_init, hot, box=None,
    focus=None, window=1.0) -> LinearRows`` (the ``SatAttack`` builder
    protocol, including the focus/window refinement contract)."""
    resolved: ResolvedSpec = constraints_set.resolved
    schema = constraints_set.schema
    env = resolved.env
    spec = resolved.spec
    d = schema.n_features
    mutable = np.asarray(schema.mutable)
    ohe_groups = [np.asarray(g) for g in schema.ohe_groups()]
    tol = getattr(constraints_set, "tol", DEFAULT_TOL)

    def build(
        x_init: np.ndarray,
        hot: np.ndarray,
        box: tuple | None = None,
        focus: np.ndarray | None = None,
        window: float = 1.0,
    ) -> LinearRows:
        x_init = np.asarray(x_init, dtype=float)
        hot = np.asarray(hot, dtype=float)
        rows: list = []
        fixes: dict = {}
        state = {"n_bin": 0}

        xl_s, xu_s = schema.bounds(dynamic_input=x_init[None, :])
        xl_s = np.asarray(xl_s, dtype=float).reshape(-1)
        xu_s = np.asarray(xu_s, dtype=float).reshape(-1)
        maxabs = np.maximum(np.abs(xl_s), np.abs(xu_s))
        if box is not None:
            box_lo, box_hi = np.asarray(box[0]), np.asarray(box[1])
        else:
            box_lo = np.minimum(x_init, hot)
            box_hi = np.maximum(x_init, hot)

        pins = {int(j): float(hot[j]) for j in np.nonzero(~mutable)[0]}

        # -- membership modes ------------------------------------------------
        member_modes: dict = {}  # col -> list of (value, z_index)
        for c in spec.constraints:
            if c.kind != "member" or not isinstance(c.lhs, E.Feat):
                continue
            col = env.col(c.lhs.name)
            if col in pins:
                if min(abs(pins[col] - v) for v in c.rhs) > tol:
                    return LinearRows(rows=[], fixes={}, feasible=False)
                continue
            if col in member_modes:
                continue
            base = d + state["n_bin"]
            state["n_bin"] += len(c.rhs)
            zs = list(range(base, base + len(c.rhs)))
            rows.append((zs, np.ones(len(zs)), 1.0, 1.0))
            rows.append(
                (
                    [col] + zs,
                    np.concatenate([[1.0], -np.asarray(c.rhs, dtype=float)]),
                    0.0,
                    0.0,
                )
            )
            member_modes[col] = list(zip((float(v) for v in c.rhs), zs))

        # -- pin-propagation fixpoint ---------------------------------------
        try:
            changed = True
            while changed:
                changed = False
                for c in spec.constraints:
                    if c.kind != "eq":
                        continue
                    for feat, other in ((c.lhs, c.rhs), (c.rhs, c.lhs)):
                        if not isinstance(feat, E.Feat):
                            continue
                        col = env.col(feat.name)
                        if col in member_modes:
                            continue
                        try:
                            a = _Extractor(env, pins, None).run(other)
                        except (_NonAffine, _RatioMode, SpecMilpError):
                            continue
                        if not a.is_const:
                            continue
                        if col in pins:
                            if abs(pins[col] - a.const) > tol:
                                raise _Infeasible(
                                    f"{c.name}: pinned value contradiction"
                                )
                        else:
                            pins[col] = a.const
                            changed = True
                        break
        except _Infeasible:
            return LinearRows(rows=[], fixes={}, feasible=False)

        anchor = x_init.copy()
        for col, v in pins.items():
            anchor[col] = v

        def bound_of(a: _Affine) -> float:
            return (
                abs(a.const)
                + sum(abs(v) * maxabs[c] for c, v in a.coefs.items())
                + 1.0
            )

        def emit(a: _Affine, lo: float, hi: float, z_gate: int | None = None):
            """Row for ``a ∈ [lo, hi]`` (inf-open sides allowed), optionally
            big-M gated on binary ``z_gate`` being 1."""
            if a.is_const and z_gate is None:
                if not (lo - tol <= a.const <= hi + tol):
                    raise _Infeasible(f"constant term {a.const} outside bounds")
                return
            cols = list(a.coefs)
            coefs = [a.coefs[c] for c in cols]
            row_lo = lo - a.const if np.isfinite(lo) else -np.inf
            row_hi = hi - a.const if np.isfinite(hi) else np.inf
            if z_gate is None:
                rows.append((cols, coefs, row_lo, row_hi))
                return
            big = bound_of(a) + max(
                abs(v) for v in (lo, hi) if np.isfinite(v)
            )
            if np.isfinite(row_hi):
                rows.append(
                    (cols + [z_gate], coefs + [big], -np.inf, row_hi + big)
                )
            if np.isfinite(row_lo):
                rows.append(
                    (cols + [z_gate], coefs + [-big], row_lo - big, np.inf)
                )

        def extract(node, elem, mode_pins=None, anchored=False):
            p = dict(pins)
            anchor_row = anchor
            if mode_pins:
                p.update(mode_pins)
                anchor_row = anchor.copy()
                for col, v in mode_pins.items():
                    anchor_row[col] = v
            return _Extractor(
                env, p, elem, anchor=anchor_row if anchored else None
            ).run(node)

        def ratio_modes(c, lhs_aff: _Affine, rm: _RatioMode, elem):
            """Denominator-grid mode search for ``lhs == num / den``
            (``lcld_sat.denominator_modes`` generalized), plus a sentinel
            mode for guarded ratios when 0 is inside the box."""
            den = rm.den_col
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
            with_sentinel = (
                rm.sentinel is not None and box_lo[den] <= 0.0 <= box_hi[den]
            )
            if not grid and not with_sentinel:
                raise _Infeasible(f"{c.name}: empty denominator grid")
            values = ([0.0] if with_sentinel else []) + list(grid)
            base = d + state["n_bin"]
            state["n_bin"] += len(values)
            zs = list(range(base, base + len(values)))
            rows.append((zs, np.ones(len(zs)), 1.0, 1.0))
            rows.append(
                (
                    [den] + zs,
                    np.concatenate([[1.0], -np.asarray(values)]),
                    0.0,
                    0.0,
                )
            )
            for v, z_k in zip(values, zs):
                if v == 0.0:
                    # sentinel mode: ratio takes the guard value
                    emit(
                        lhs_aff.add(_Affine(rm.sentinel), -1.0),
                        -SLACK,
                        SLACK,
                        z_gate=z_k,
                    )
                else:
                    emit(
                        lhs_aff.add(rm.num.scale(1.0 / v), -1.0),
                        -SLACK,
                        SLACK,
                        z_gate=z_k,
                    )

        def member_var_of(c) -> tuple | None:
            feats = E.constraint_features(c)
            hits = [
                (env.col(f), member_modes[env.col(f)])
                for f in sorted(feats)
                if env.col(f) in member_modes
            ]
            return hits[0] if len(hits) == 1 else None

        def emit_le(c, elem):
            # guarded-ratio bound: safe_div(n, d, s) <= C cross-multiplies
            lhs, rhs = c.lhs, c.rhs
            if isinstance(lhs, E.Call) and lhs.fn in ("safe_div", "finite_div"):
                rhs_aff = extract(rhs, elem)
                if rhs_aff.is_const:
                    sentinel = _sentinel_value(lhs.args[2])
                    try:
                        den_aff = extract(lhs.args[1], elem)
                    except (_NonAffine, _RatioMode):
                        den_aff = None
                    if den_aff is not None and not den_aff.is_const:
                        den_lo = (
                            den_aff.const
                            + sum(
                                v * (xl_s[cc] if v > 0 else xu_s[cc])
                                for cc, v in den_aff.coefs.items()
                            )
                        )
                        if den_lo >= 0.0 and sentinel <= rhs_aff.const + tol:
                            num_aff = extract(lhs.args[0], elem)
                            emit(
                                num_aff.add(
                                    den_aff.scale(rhs_aff.const), -1.0
                                ),
                                -np.inf,
                                0.0,
                            )
                            return
            # abs band: abs(E) <= c
            if isinstance(lhs, E.Call) and lhs.fn == "abs":
                rhs_aff = extract(rhs, elem)
                if rhs_aff.is_const:
                    _emit_band(c, lhs.args[0], rhs_aff.const, elem)
                    return
            _emit_general(c, elem, kind="le")

        def _emit_band(c, inner, half_width: float, elem):
            """|inner| <= half_width, with membership-mode fallback."""
            try:
                a = extract(inner, elem)
                emit(a, -half_width, half_width)
                return
            except _RatioMode:
                raise SpecMilpError(
                    f"{c.name}: searched denominator inside abs-band "
                    "unsupported"
                ) from None
            except _NonAffine:
                pass
            mv = member_var_of(c)
            if mv is None:
                a = extract(inner, elem, anchored=True)
                emit(a, -half_width, half_width)
                return
            col, modes = mv
            for v, z_k in modes:
                a = extract(inner, elem, mode_pins={col: v}, anchored=True)
                emit(a, -half_width, half_width, z_gate=z_k)

        def _emit_general(c, elem, kind: str):
            lo, hi = (
                (-SLACK, SLACK) if kind == "eq" else (-np.inf, 0.0)
            )
            try:
                if kind == "eq":
                    lhs_aff = extract(c.lhs, elem)
                    try:
                        rhs_aff = extract(c.rhs, elem)
                    except _RatioMode as rm:
                        ratio_modes(c, lhs_aff, rm, elem)
                        return
                    a = lhs_aff.add(rhs_aff, -1.0)
                else:
                    a = extract(c.lhs, elem).add(extract(c.rhs, elem), -1.0)
                emit(a, lo, hi)
                return
            except _RatioMode as rm:
                if kind == "eq":
                    try:
                        rhs_aff = extract(c.rhs, elem)
                    except (_NonAffine, _RatioMode):
                        raise SpecMilpError(
                            f"{c.name}: both sides nonlinear"
                        ) from None
                    ratio_modes(c, rhs_aff, rm, elem)
                    return
                raise SpecMilpError(
                    f"{c.name}: searched denominator in <= unsupported"
                ) from None
            except _NonAffine:
                pass
            mv = member_var_of(c)
            if mv is None:
                a = extract(c.lhs, elem, anchored=True).add(
                    extract(c.rhs, elem, anchored=True), -1.0
                )
                emit(a, lo, hi)
                return
            col, modes = mv
            for v, z_k in modes:
                a = extract(
                    c.lhs, elem, mode_pins={col: v}, anchored=True
                ).add(
                    extract(c.rhs, elem, mode_pins={col: v}, anchored=True),
                    -1.0,
                )
                emit(a, lo, hi, z_gate=z_k)

        try:
            for c, width in zip(spec.constraints, resolved.widths):
                if c.kind == "member":
                    if isinstance(c.lhs, E.Feat):
                        continue  # handled by member_modes / pin check
                    raise SpecMilpError(
                        f"{c.name}: membership on a compound expression"
                    )
                for elem in range(width) if width > 1 else (None,):
                    if c.kind == "le":
                        emit_le(c, elem)
                    else:
                        _emit_general(c, elem, kind="eq")
        except _Infeasible:
            return LinearRows(rows=[], fixes={}, feasible=False)

        # derived-constant features the equalities force (pins minus the
        # immutables the engine already fixes through its bounds)
        for col, v in pins.items():
            if mutable[col]:
                fixes[col] = v
        for col in np.nonzero(~mutable)[0]:
            fixes[int(col)] = float(hot[col])

        for g in ohe_groups:
            rows.append((g, np.ones(len(g)), 1.0, 1.0))

        return LinearRows(rows=rows, fixes=fixes, n_extra_bin=state["n_bin"])

    return build
