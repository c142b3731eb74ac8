"""Repair compiler backend: spec -> constructive projection, in torch.

Port of ``moeva2_ijcai22_replication_tpu/domains/ir/repair_backend.py``.
Derives the repair the hand-written domains implement by hand
(``LcldConstraints.repair``) from the spec's defining constraints:

1. **membership snap**: ``f in {v1..vk}`` on a mutable feature snaps to the
   nearest member (threshold at the midpoints, each rounded once to the
   rows' dtype);
2. **equality re-derivation**: ``f == E`` (and the tolerance-equality form
   ``abs(f - E) <= c``) with a mutable bare feature ``f`` not appearing in
   ``E`` becomes the assignment ``f := E``, applied in dependency order;
   cyclic or self-referential equalities are left to the search;
3. **one-hot hardening**: every one-hot group snaps to its argmax
   (``core.codec.harden_onehot``).

Plain torch, evaluated as :mod:`.expr` evaluates: the semantic twin of
the repair program that :func:`.program.lower_spec_repair` emits for
kernel K10 (which hardens the one-hot groups itself, from
``PgdTables.ohe``).
"""

from __future__ import annotations

import torch

from ...core.codec import harden_onehot
from . import expr as E
from . import ops
from .expr import eval_expr
from .spec import ResolvedSpec, _width_of


def _assignment_of(c: E.Constraint, env) -> tuple | None:
    """``(feature_name, expr)`` when the constraint defines a feature."""
    if c.kind == "eq":
        for feat, other in ((c.lhs, c.rhs), (c.rhs, c.lhs)):
            if (
                isinstance(feat, E.Feat)
                and feat.name not in E.features_of(other)
                and not E.groups_of(other)
                and _width_of(other, env) <= 1
            ):
                return feat.name, other
    if c.kind == "le":
        # tolerance equality: abs(f - E) <= c  ->  f := E
        lhs = c.lhs
        if (
            isinstance(lhs, E.Call)
            and lhs.fn == "abs"
            and isinstance(lhs.args[0], E.Bin)
            and lhs.args[0].op == "-"
            and not E.features_of(c.rhs)
        ):
            diff = lhs.args[0]
            for feat, other in ((diff.lhs, diff.rhs), (diff.rhs, diff.lhs)):
                if (
                    isinstance(feat, E.Feat)
                    and feat.name not in E.features_of(other)
                    and not E.groups_of(other)
                    and _width_of(other, env) <= 1
                ):
                    return feat.name, other
    return None


def _topo_assignments(assignments: dict) -> list:
    """Kahn order over feature-dependency edges; members of a dependency
    cycle are dropped (left to the search) rather than applied in an
    arbitrary order."""
    deps = {f: {d for d in E.features_of(expr) if d in assignments} for f, expr in assignments.items()}
    order, ready = [], [f for f, d in deps.items() if not d]
    done = set()
    while ready:
        f = ready.pop()
        order.append(f)
        done.add(f)
        ready.extend(g for g, d in deps.items() if g not in done and g not in ready and d <= done)
    return order


def membership_snaps(resolved: ResolvedSpec, schema) -> list:
    """``(column, sorted_values)`` for each mutable single-feature
    membership constraint."""
    mutable = schema.mutable
    out = []
    for c in resolved.spec.constraints:
        if c.kind == "member" and isinstance(c.lhs, E.Feat):
            col = resolved.env.col(c.lhs.name)
            if mutable[col]:
                out.append((col, tuple(sorted(c.rhs))))
    return out


def repair_plan(resolved: ResolvedSpec, schema) -> tuple:
    """``(snaps, order, assignments)``: the membership snaps, then the
    features the equalities define, in the order they are assigned, and
    each one's expression."""
    env = resolved.env
    mutable = schema.mutable
    assignments: dict = {}
    for c in resolved.spec.constraints:
        found = _assignment_of(c, env)
        if found is not None:
            name, expr_node = found
            if mutable[env.col(name)] and name not in assignments:
                assignments[name] = expr_node
    return membership_snaps(resolved, schema), _topo_assignments(assignments), assignments


def compile_repair(resolved: ResolvedSpec, schema, ohe_idx, ohe_mask):
    env = resolved.env
    snaps, order, assignments = repair_plan(resolved, schema)

    def repair(x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        for col, values in snaps:
            v = x[..., col]
            snapped = ops.literal(v, values[0])
            for k in range(1, len(values)):
                mid = (values[k - 1] + values[k]) / 2.0
                snapped = torch.where(v < ops.literal(v, mid), snapped, ops.literal(v, values[k]))
            x[..., col] = snapped + ops.literal(v, 0.0) * v
        for name in order:
            value, _ = eval_expr(assignments[name], x, env)
            x[..., env.col(name)] = value
        return harden_onehot(x, ohe_idx.to(x.device), ohe_mask.to(x.device))

    return repair
