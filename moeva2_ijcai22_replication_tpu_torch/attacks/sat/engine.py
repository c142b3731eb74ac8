"""SAT/MIP attack: constraint-satisfying candidates by mixed-integer programs.

Port of ``attacks/sat/engine.py``, whole: per initial state a typed
mixed-integer program (integer and one-hot features as integer variables,
immutable features pinned, an ε-box in min-max-scaled space, the domain's
linear rows from a per-domain builder), solved by scipy's HiGHS ``milp``,
hot-started from a gradient attack's output and falling back to the initial
state when infeasible. The exact L2 ball by tangent cuts (``l2_cut_rounds``)
with the inscribed directional box as its fallback, the denominator-grid
refinement rounds (``refine_rounds``), the solution pool of no-good cuts
(``n_sample``) and the thread pool over states (``n_jobs``) are the JAX
package's, and each program is built row for row in its order, so that HiGHS
gets the same program and returns the same solution. See the JAX module's
docstring for the formulation and its limits against the reference's
Gurobi attack.

This is host work: numpy and scipy on the CPU, as in the JAX package, which
has no device stage for it either. :meth:`SatAttack.generate` takes arrays
(or CPU tensors) and returns a numpy array.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from ...core.constraints import ConstraintSet
from ...core.norms import is_inf, validate_norm
from ...models.scalers import MinMaxParams

SAFETY_DELTA = 1e-7  # sat.py:18
#: relative radial margin of the L2 cutting planes: cuts are tangent to a
#: (1 − margin)-shrunk ball so the cutting-plane incumbents — which approach
#: the cut ball's boundary FROM OUTSIDE — land strictly inside the true
#: ε-ball after a few rounds instead of converging to it asymptotically.
#: Accepted solutions are validated against the full ε (− SAFETY_DELTA), so
#: the margin costs at most 0.1% of the radius — vs the inscribed box's
#: (1 − 1/√m) sacrifice on concentrated directions.
L2_CUT_MARGIN = 1e-3


@dataclass
class LinearRows:
    """Sparse-ish linear constraint rows over the feature variables:
    lo <= sum_j coefs[j] * x[cols[j]] <= hi, plus hard variable pins.

    ``n_extra_bin`` auxiliary {0,1} variables are appended after the
    ``n_features`` feature variables; rows may reference them by index
    ``n_features + k`` (mode switches for big-M constructions).
    ``feasible=False`` short-circuits the solve: the builder proved the
    program unsatisfiable (e.g. a zero pinned denominator), so the engine
    takes the reference's infeasible fallback (``sat.py:184-185``)."""

    rows: list  # [(cols: np.ndarray, coefs: np.ndarray, lo: float, hi: float)]
    fixes: dict  # {var_index: value} — variables pinned to constants
    n_extra_bin: int = 0
    feasible: bool = True


@dataclass
class SatAttack:
    constraints: ConstraintSet
    #: (x_init, hot, box) -> LinearRows, box = the ε-intersected (xl, xu)
    sat_rows_builder: Callable[[np.ndarray, np.ndarray, tuple], LinearRows]
    min_max_scaler: MinMaxParams
    eps: float
    norm: Any = np.inf
    n_sample: int = 1
    n_jobs: int = 1
    time_limit: float | None = 30.0
    #: iterative grid refinement for builders that search nonlinear
    #: participants over candidate grids (LCLD's ratio denominators): after a
    #: successful solve the builder is re-invoked with the incumbent solution
    #: as ``focus`` and a geometrically shrinking ``window`` (¼, ¹⁄₁₆, … of
    #: the box per round), re-gridding around the incumbent. The incumbent's
    #: grid values are always kept, so each round's program contains the
    #: previous optimum and the objective improves monotonically — after r
    #: rounds the effective denominator resolution is box/4^(r+1) per round
    #: chain vs the reference's continuous nonconvex search
    #: (``sat.py:167-173`` NonConvex=2). Ignored for builders without a
    #: ``focus`` parameter (botnet: fully linear, nothing to refine).
    refine_rounds: int = 0
    #: outer-approximation rounds for the exact L2 ball (L2 norm only): the
    #: ε-box is relaxed to the circumscribed box and out-of-ball incumbents
    #: add supporting-hyperplane cuts until one lands inside the ball (then
    #: optimal over it up to L2_CUT_MARGIN) or the rounds run out (then the
    #: inscribed directional box is solved instead — the guaranteed-valid
    #: fallback).
    #: 0 disables the cut path entirely.
    l2_cut_rounds: int = 12

    def __post_init__(self):
        validate_norm(self.norm)
        import inspect

        try:
            self._builder_refines = "focus" in inspect.signature(
                self.sat_rows_builder
            ).parameters
        except (TypeError, ValueError):
            self._builder_refines = False
        schema = self.constraints.schema
        # int/ohe features become MILP integer variables; real and softmax
        # (simplex) features stay continuous
        self._int_mask = np.array(
            [str(t) not in ("real", "softmax") for t in schema.types]
        )
        # the softmax sub-vector's Σ=1 simplex row is part of the type's
        # meaning, so the engine adds it itself — like integer typing, it is
        # derived from the schema, not left to the domain builders
        self._softmax_idx = np.flatnonzero(
            [str(t) == "softmax" for t in schema.types]
        )
        self._mutable = np.asarray(schema.mutable, dtype=bool)
        self._scale = np.asarray(self.min_max_scaler.scale)
        self._min = np.asarray(self.min_max_scaler.min_)

    # -- per-state program --------------------------------------------------
    def _box_radii(self, x_init: np.ndarray, hot: np.ndarray) -> np.ndarray:
        """Per-feature half-widths of the ε-box in scaled space (sat.py:85-97).

        L∞ is the box itself. The L2 ball (Gurobi quadratic pow-constraint,
        ``sat.py:98-124``) has no linear encoding, so it is inscribed by a
        box with Σ radius² = ε² — every solution remains a valid L2 member.
        The budget goes only to features the MILP can actually move (mutable,
        nonzero scale; pinned dims contribute zero displacement, so weighting
        them would only shrink everyone else), and the box is *directional*:
        radii follow the hot-start displacement |hot − x_init| with a 10%
        uniform floor so unmoved features keep room. Displacements below
        ε/100 are treated as zero — PGD converging at x_init must not let
        float noise steer the box — degrading to the uniform inscribed
        box ε/√m over the m movable features.
        """
        d = x_init.shape[0]
        if is_inf(self.norm):
            return np.full(d, self.eps)
        movable = self._mutable & (self._scale != 0)
        if not movable.any():
            return np.full(d, self.eps / np.sqrt(d))
        delta = np.abs((hot - x_init) * self._scale)
        delta = np.where(movable & (delta > self.eps / 100.0), delta, 0.0)
        if delta.max() > 0:
            weights = np.where(movable, delta + delta.max() / 10.0, 0.0)
        else:
            weights = movable.astype(float)
        return self.eps * weights / np.linalg.norm(weights)

    def _assemble(self, spec: LinearRows, xl: np.ndarray, xu: np.ndarray, hot: np.ndarray):
        """LinearRows -> the HiGHS program matrices, or None when a hard pin
        falls outside the ε-box ∩ feature bounds (the mode is unreachable
        within the budget: genuinely infeasible, never silently escaped)."""
        d = xl.shape[0]
        xl, xu = xl.copy(), xu.copy()
        rows = list(spec.rows)
        if len(self._softmax_idx):
            rows.append(
                (self._softmax_idx, np.ones(len(self._softmax_idx)), 1.0, 1.0)
            )
        tol = 1e-9
        for i, v in spec.fixes.items():
            if v < xl[i] - tol or v > xu[i] + tol:
                return None
            xl[i] = xu[i] = min(max(v, xl[i]), xu[i])

        # variable layout: [x (d features), z (e mode binaries), p, n (split)]
        e = spec.n_extra_bin
        n_rows = len(rows)
        a_rows, lo_r, hi_r = [], [], []
        for cols, coefs, lo, hi in rows:
            row = np.zeros(d + e)
            row[np.asarray(cols, dtype=int)] = np.asarray(coefs, dtype=float)
            a_rows.append(row)
            lo_r.append(lo)
            hi_r.append(hi)

        a_main = np.array(a_rows) if n_rows else np.zeros((0, d + e))
        # objective: scaled L1 distance to hot start via split variables
        # x = hot + p - n, p,n >= 0; minimise sum(scale * (p + n))
        mut_idx = np.flatnonzero(self._mutable)
        m = len(mut_idx)
        n_var = d + e + 2 * m
        a_split = np.zeros((m, n_var))
        a_split[np.arange(m), mut_idx] = 1.0
        a_split[np.arange(m), d + e + np.arange(m)] = -1.0
        a_split[np.arange(m), d + e + m + np.arange(m)] = 1.0

        a_full = np.zeros((n_rows + m, n_var))
        a_full[:n_rows, : d + e] = a_main
        a_full[n_rows:] = a_split
        lo_full = np.concatenate([lo_r, hot[mut_idx]])
        hi_full = np.concatenate([hi_r, hot[mut_idx]])

        c = np.zeros(n_var)
        w = np.where(self._scale[mut_idx] == 0, 1.0, np.abs(self._scale[mut_idx]))
        c[d + e: d + e + m] = w
        c[d + e + m:] = w

        xl_full = np.concatenate([xl, np.zeros(e), np.zeros(2 * m)])
        xu_full = np.concatenate([xu, np.ones(e), np.full(2 * m, np.inf)])
        integrality = np.concatenate(
            [
                self._int_mask.astype(int),
                np.ones(e, dtype=int),
                np.zeros(2 * m, dtype=int),
            ]
        )

        # Binary variables carry the solution pool's no-good cuts: mode
        # binaries plus any integer feature whose *feasible integer values*
        # are exactly {0, 1} (one-hot members, flags) — judged on the
        # ε-intersected box, not the schema bounds.
        lo_int = np.ceil(xl_full[: d + e] - 1e-9)
        hi_int = np.floor(xu_full[: d + e] + 1e-9)
        is_bin = (integrality[: d + e] == 1) & (lo_int == 0.0) & (hi_int == 1.0)
        return {
            "d": d,
            "e": e,
            "a": a_full,
            "lo": lo_full,
            "hi": hi_full,
            "c": c,
            "xl": xl_full,
            "xu": xu_full,
            "integrality": integrality,
            "bin_idx": np.flatnonzero(is_bin),
        }

    def _solve_pool(self, prog: dict, n_sample: int) -> list[np.ndarray]:
        """Solve, emulating Gurobi's solution pool with no-good cuts over the
        program's binary variables (``sat.py:167-173``)."""
        from scipy import optimize, sparse

        d, e = prog["d"], prog["e"]
        a_full, lo_full, hi_full = prog["a"], prog["lo"], prog["hi"]
        bin_idx = prog["bin_idx"]
        n_var = a_full.shape[1]
        options = {}
        if self.time_limit is not None:
            options["time_limit"] = self.time_limit

        sols: list[np.ndarray] = []
        for _ in range(n_sample):
            cons = optimize.LinearConstraint(
                sparse.csr_matrix(a_full), lo_full, hi_full
            )
            res = optimize.milp(
                prog["c"],
                constraints=cons,
                bounds=optimize.Bounds(prog["xl"], prog["xu"]),
                integrality=prog["integrality"],
                options=options,
            )
            if not res.success or res.x is None:
                break
            out = res.x[:d]
            out = np.where(self._int_mask, np.round(out), out)
            sols.append(out)
            if len(sols) == n_sample or len(bin_idx) == 0:
                break
            # no-good cut: at least one binary flips vs this assignment —
            # sum_{b=0} x_b + sum_{b=1} (1 - x_b) >= 1
            assign = np.round(res.x[: d + e][bin_idx])
            row = np.zeros(n_var)
            row[bin_idx] = np.where(assign > 0.5, -1.0, 1.0)
            a_full = np.vstack([a_full, row[None, :]])
            lo_full = np.concatenate([lo_full, [1.0 - assign.sum()]])
            hi_full = np.concatenate([hi_full, [np.inf]])
        return sols

    def _eps_box(self, x_init: np.ndarray, radius: np.ndarray):
        """Feature bounds ∩ per-feature ε-box (scaled space) with
        immutability pins (sat.py:56-61)."""
        xl, xu = self.constraints.get_feature_min_max(dynamic_input=x_init)
        xl = np.asarray(xl, dtype=float).copy()
        xu = np.asarray(xu, dtype=float).copy()
        s_init = x_init * self._scale + self._min
        nonzero = self._scale != 0
        safe_scale = np.where(nonzero, self._scale, 1.0)
        lo_box = np.where(
            nonzero, (s_init - radius + SAFETY_DELTA - self._min) / safe_scale, xl
        )
        hi_box = np.where(
            nonzero, (s_init + radius - SAFETY_DELTA - self._min) / safe_scale, xu
        )
        xl = np.maximum(xl, lo_box)
        xu = np.minimum(xu, hi_box)
        xl[~self._mutable] = x_init[~self._mutable]
        xu[~self._mutable] = x_init[~self._mutable]
        return xl, xu

    def _l1_objective(self, hot: np.ndarray):
        """The program's objective as a host function — scaled L1 distance to
        the hot start over the mutable features (refinement acceptance)."""
        mut_idx = np.flatnonzero(self._mutable)
        w = np.where(self._scale[mut_idx] == 0, 1.0, np.abs(self._scale[mut_idx]))

        def obj(s):
            return float(w @ np.abs(s[mut_idx] - hot[mut_idx]))

        return obj

    def _ball_cut_rows(self, dirs: list, x_init: np.ndarray) -> list:
        """Supporting hyperplanes of the (1 − L2_CUT_MARGIN)-shrunk scaled-L2
        ε-ball: for a unit direction u (scaled space), u·scale·(x − x_init) ≤
        ρ is valid for every shrunk-ball member and cuts off everything beyond
        the tangent plane (see L2_CUT_MARGIN for why the shrink)."""
        eps_eff = (self.eps - SAFETY_DELTA) * (1.0 - L2_CUT_MARGIN)
        rows = []
        for u in dirs:
            coefs = u * self._scale
            nz = np.flatnonzero(coefs)
            rows.append(
                (nz, coefs[nz], -np.inf, eps_eff + float(coefs[nz] @ x_init[nz]))
            )
        return rows

    def _ball_norm(self, x: np.ndarray, x_init: np.ndarray) -> float:
        return float(np.linalg.norm((x - x_init) * self._scale))

    def _solve_ball(self, assemble, x_init: np.ndarray, n_sample: int, dirs: list):
        """Cutting-plane solve over the exact scaled-L2 ball.

        ``assemble(cut_rows)`` builds the program with the given extra rows;
        ``dirs`` accumulates cut directions across calls (refinement rounds
        reuse every cut already found). Returns in-ball solutions, or [] when
        the loop exhausts ``l2_cut_rounds`` without an in-ball incumbent.
        Each added cut is strictly violated by the incumbent that produced
        it, so incumbents never repeat.

        Stall exit: Kelley converges in a handful of cuts when the repair
        displacement is low-dimensional (the binding subspace is small — the
        LCLD family), but when the nearest feasible repair moves hundreds of
        coordinated features OUTSIDE the ball (botnet sum-equality chains),
        each tangent plane shaves a negligible cap and the incumbent norm
        flatlines above ε — often because no in-ball repair exists at all,
        which a cutting-plane loop cannot prove cheaply. Two consecutive
        rounds without meaningful norm progress abandon the hunt to the
        caller's fallback instead of burning the full round budget.
        """
        eps_tol = self.eps - SAFETY_DELTA
        prev_nrm, stalled = None, 0
        for _ in range(self.l2_cut_rounds):
            prog = assemble(self._ball_cut_rows(dirs, x_init))
            if prog is None:
                return []
            sols = self._solve_pool(prog, 1)
            if not sols:
                return []
            delta = (sols[0] - x_init) * self._scale
            nrm = float(np.linalg.norm(delta))
            if nrm <= eps_tol:
                if n_sample > 1:
                    pool = self._solve_pool(prog, n_sample)
                    sols = [
                        s for s in pool if self._ball_norm(s, x_init) <= eps_tol
                    ] or sols
                return sols
            if prev_nrm is not None and nrm > prev_nrm * (1.0 - 1e-3):
                stalled += 1
                if stalled >= 2:
                    return []
            else:
                stalled = 0
            prev_nrm = nrm
            dirs.append(delta / nrm)
        return []

    def _refine(self, solve, x_init, hot, box, spec, sols):
        """Iterative denominator-grid refinement around the incumbent.

        A refined round's solution is accepted only when its objective does
        not worsen — the incumbent's grid value can fall to the builder's
        near-zero filter, in which case the refined program no longer
        contains the incumbent and its optimum may regress.
        """
        obj = self._l1_objective(hot)
        best = obj(sols[0])
        for r in range(self.refine_rounds):
            spec_r = self.sat_rows_builder(
                x_init, hot, box, focus=sols[0], window=0.25 ** (r + 1)
            )
            if not spec_r.feasible:
                break
            sols_r = solve(spec_r, 1)
            if not sols_r or obj(sols_r[0]) > best + 1e-9:
                break
            spec, sols, best = spec_r, sols_r, obj(sols_r[0])
        return spec, sols

    def _one_generate(self, x_init: np.ndarray, hot: np.ndarray) -> np.ndarray:
        fallback = np.tile(x_init, (self.n_sample, 1))
        d = x_init.shape[0]
        refining = self.refine_rounds > 0 and self._builder_refines

        # -- exact-ball path (L2): circumscribed box + tangent cuts ---------
        if not is_inf(self.norm) and self.l2_cut_rounds > 0:
            xl, xu = self._eps_box(x_init, np.full(d, self.eps))
            box = (xl.copy(), xu.copy())
            spec = self.sat_rows_builder(x_init, hot, box)
            if spec.feasible:
                dirs: list = []  # cuts persist across refinement rounds

                def solve(spec_i, n):
                    return self._solve_ball(
                        lambda cut_rows: self._assemble(
                            LinearRows(
                                rows=list(spec_i.rows) + cut_rows,
                                fixes=spec_i.fixes,
                                n_extra_bin=spec_i.n_extra_bin,
                            ),
                            xl, xu, hot,
                        ),
                        x_init, n, dirs,
                    )

                sols = solve(spec, 1 if refining else self.n_sample)
                if sols:
                    if refining:
                        spec, sols = self._refine(
                            solve, x_init, hot, box, spec, sols
                        )
                        if self.n_sample > 1:
                            sols = solve(spec, self.n_sample) or sols
                    while len(sols) < self.n_sample:
                        sols.append(sols[-1])
                    return np.stack(sols)

        # -- inscribed directional box (L∞, or the cut loop came up dry) ----
        xl, xu = self._eps_box(x_init, self._box_radii(x_init, hot))
        box = (xl.copy(), xu.copy())
        # builders receive the ε-intersected feature box so they can
        # grid-search nonlinear participants inside it
        spec = self.sat_rows_builder(x_init, hot, box)
        if not spec.feasible:
            return fallback

        def solve_box(spec_i, n):
            prog = self._assemble(spec_i, xl, xu, hot)
            return self._solve_pool(prog, n) if prog is not None else []

        sols = solve_box(spec, 1 if refining else self.n_sample)
        if sols and refining:
            spec, sols = self._refine(solve_box, x_init, hot, box, spec, sols)
            if self.n_sample > 1:
                sols = solve_box(spec, self.n_sample) or sols

        if not sols:
            return fallback  # sat.py:184-185
        while len(sols) < self.n_sample:
            sols.append(sols[-1])  # binary space exhausted: pad
        return np.stack(sols)

    # -- public API ---------------------------------------------------------
    def generate(self, x: np.ndarray, hot_start: np.ndarray | None = None) -> np.ndarray:
        """(S, D) initial states -> (S, n_sample, D) repaired candidates."""
        x = np.asarray(x, dtype=float)
        hot = x if hot_start is None else np.asarray(hot_start, dtype=float)
        if hot.shape != x.shape:
            raise ValueError(f"hot_start shape {hot.shape} != x shape {x.shape}")

        if self.n_jobs == 1:
            outs = [self._one_generate(x[i], hot[i]) for i in range(len(x))]
        else:
            from concurrent.futures import ThreadPoolExecutor

            workers = None if self.n_jobs in (-1, 0) else self.n_jobs
            with ThreadPoolExecutor(max_workers=workers) as pool:
                outs = list(
                    pool.map(lambda i: self._one_generate(x[i], hot[i]), range(len(x)))
                )
        return np.stack(outs)
